"""CLI product path for multi-device data parallelism.

``strique count --devices N`` must produce byte-identical TSV output to
the single-device run: the fused detection pipeline is per-read work
under ``shard_map``, so sharding reads over chips cannot change any
result bit (the device-mesh replacement for the reference's ``--t``
worker-pool knob, reference scripts/STRique.py:912).
"""
import io
from contextlib import redirect_stdout

import h5py
import jax
import numpy as np
import pytest

from strique_tpu.cli import main
from strique_tpu.pore_model import PoreModel
from strique_tpu.synthetic import default_assets

MODEL = default_assets().model
REPEAT_TSV = default_assets().repeat_config

@pytest.fixture(autouse=True)
def eight_devices():
    """These cases shard over 8 devices (the CPU tier's virtual mesh)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")


def _write_single_fast5(path, read_id, signal):
    with h5py.File(path, "w") as f5:
        grp = f5.create_group(f"Raw/Reads/Read_{read_id[:4]}")
        grp.attrs["read_id"] = read_id
        grp.attrs["duration"] = len(signal)
        grp.create_dataset("Signal", data=signal.astype(np.float32))


@pytest.fixture(scope="module")
def synthetic_run(tmp_path_factory):
    """A directory of synthetic c9orf72 fast5 reads + index + SAM file."""
    d = tmp_path_factory.mktemp("cli_mesh")
    row = open(REPEAT_TSV).read().strip().split("\n")[1].split()
    chrom, begin = row[0], int(row[1])
    repeat, prefix, suffix = row[4], row[5], row[6]
    pm = PoreModel(MODEL)
    rng = np.random.default_rng(7)
    backbone = "".join(rng.choice(list("ACTG"), 400))
    expected = {}
    sam_lines = []
    for k, n_rep in enumerate((6, 9, 13, 17, 21)):
        rid = f"read-{k:04d}-0000-0000-0000-000000000000"
        seq = backbone[:200] + prefix + repeat * n_rep + suffix + backbone[-200:]
        _write_single_fast5(d / f"{rid}.fast5", rid, pm.generate_signal(seq, samples=8))
        expected[rid] = n_rep
        sam_lines.append(f"{rid}\t0\t{chrom}\t{begin - 400}\t60\t1000M\t*\t0\t0\t*\t*")
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["index", str(d)])
    (d / "reads.fofn").write_text(buf.getvalue())
    (d / "reads.sam").write_text("\n".join(sam_lines) + "\n")
    return d, expected


def _run_count(d, devices, out_name):
    out = d / out_name
    rc = main(["count", str(d / "reads.fofn"), MODEL, REPEAT_TSV,
               "--algn", str(d / "reads.sam"), "--out", str(out),
               "--devices", str(devices), "--batch", "8"])
    assert rc == 0
    return out.read_bytes()

def test_count_mesh_byte_identical(synthetic_run):
    d, expected = synthetic_run
    single = _run_count(d, 1, "single.tsv")
    meshed = _run_count(d, 8, "meshed.tsv")
    assert meshed == single
    rows = [l.split("\t") for l in single.decode().strip().split("\n")[1:]]
    assert len(rows) == len(expected)
    for cols in rows:
        assert int(cols[3]) == expected[cols[0]], cols
