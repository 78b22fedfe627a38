# strique_tpu container recipe (the reference ships a Dockerfile too,
# reference Dockerfile:1).
#
#   docker build -t strique .
#   docker run --rm strique strique --help
#
# The image ships the CPU backend (jax[cpu]): every pipeline runs through
# the plain lax scans, which is what the test tier and the golden
# verification use.  For an NVIDIA GPU, start from a CUDA base image
# with nvcc and install JAX with its CUDA plugin (see docs/install.md).
#
# The build finishes by reproducing the reference's golden integration
# run (index + count on the bundled c9orf72 read, with --mod_model,
# reference .travis.yml:99-102) so a successful build IS a verified
# install.
FROM python:3.11-slim

RUN apt-get update \
    && apt-get install -y --no-install-recommends g++ make git \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/strique_tpu
COPY pyproject.toml ./
COPY strique_tpu ./strique_tpu
COPY native ./native

RUN pip install --no-cache-dir jax numpy scipy h5py \
    && pip install --no-cache-dir -e . \
    && make -C native clean all CXXFLAGS="-O3 -ffp-contract=off -std=c++17 -fPIC -Wall"

# golden self-test: the documented row (count 733 default semantics /
# offset 1633 / ticks 40758, PARITY.md) must reproduce or the build fails
RUN git clone --depth 1 https://github.com/giesselmann/STRique /opt/reference \
    && strique index /opt/reference/data --out_prefix /opt/reference/data > /tmp/reads.fofn \
    && strique count /tmp/reads.fofn \
         /opt/reference/models/r9_4_450bps.model \
         /opt/reference/configs/repeat_config.tsv \
         --algn /opt/reference/data/c9orf72.sam \
         --config /opt/reference/configs/STRique.json \
         --mod_model /opt/reference/models/r9_4_450bps_mCpG.model \
         --out /tmp/counts.tsv \
    && python - <<'EOF'
row = open("/tmp/counts.tsv").read().strip().split("\n")[1].split("\t")
assert row[0].startswith("ce47b364"), row
assert int(row[3]) == 733 and int(row[7]) == 1633 and int(row[8]) == 40758, row
print("golden row OK:", "\t".join(row[:9]))
EOF

ENTRYPOINT ["strique"]
CMD ["--help"]
