"""Seeded stand-ins for the reference's bundled assets.

The reference ships an r9.4 6-mer pore model and its mCpG variant
(models/), a repeat config with the c9orf72 and FMR1 loci and an
align/HMM parameter JSON (configs/), and a small sequencing run
(data/).  None of them is redistributed here.  This module writes
equivalents from a seed, so tests, benchmarks and the CLI run from files
the repository itself generates:

  * a 4096-row 6-mer table whose levels are drawn around 95 pA with a
    12 pA spread, so they span the r9.4 range (about 60-130 pA) with
    sparse tails as a real table has (the minmax normalization takes
    medians of the outer 1% tails), and per-k-mer spreads of 1.2-2.5 pA;
  * an mCpG variant that shifts every k-mer holding a CG dinucleotide
    by 0.6-0.9 of its own level spread (either sign), leaving all other
    rows identical (larger shifts make the canonical counting HMM decode
    some mCpG reads a unit long, as the float64 oracle does too);
  * the repeat config TSV (c9orf72 GGCCCC and FMR1 CGG rows with their
    150 bp flanks) and the parameter JSON with the code defaults;
  * on request, a bulk fast5 plus SAM alignment of synthetic reads with
    known repeat counts (:func:`write_run`).

Files are deterministic functions of the seed; writes go through a
temporary name and an atomic rename, so concurrent writers (test
workers) never see a partial file.
"""
from __future__ import annotations

import itertools
import json
import os
from dataclasses import dataclass

import numpy as np

SEED = 94  # default asset seed ("r9.4")
KMER = 6

C9_REPEAT = "GGCCCC"
C9_PREFIX = ("CGGCAGCCGAACCCCAAACAGCCACCCGCCAGGATGCCGCCTCCTCACTCACCCACTCGCCACCGCCTGCGCC"
             "TCCGCCGCCGCGGGCGCAGGCACCGCAACCGCAGCCCCGCCCCGGGCCCGCCCCCGGGCCCGCCCCGACCACGCCCC")
C9_SUFFIX = ("TAGCGCGCGACTCCTGAGTTCCAGAGCTTGCTACAGGCTGCGGTTGTTTCCCTCCTTGTTTTCTTCTGGTTAA"
             "TCTTTATCAGGTCTTTTCTTGTTCACCCTCAGCGAGTACTGTGAGAGCAAGTAGTGGGGAGAGAGGGTGGGAAAAAC")
FMR1_REPEAT = "CGG"
FMR1_PREFIX = ("AGCGGGCCGGGGGTTCGGCCTCAGTCAGGCGCTCAGCTCCGTTTCGGTTTCACTTCCGGTGGAGGGCCGCC"
               "TCTGAGCGGGCGGCGGGCCGACGGCGAGCGCGGGCGGCGGCGGTGACGGAGGCGCCGCTGCCAGGGGGCGTGCGGCAGC")
FMR1_SUFFIX = ("GAGGCGGCGGCGGCGGCGGCGGCGGCGGCGGCTGGGCCTCGAGCGCCCGCAGCCCACCTCTCGGGGGCGGG"
               "CTCCCGGCGCTAGCAGGGCTGAAGAGAAGATGGAGGAGCTGGTGGTGGAAGTGCGGGGCTCCAATGGCGCTTTCTACAA")

# (chr, begin, end, name, repeat, prefix, suffix) — the repeat config's columns
LOCI = (
    ("chr9", 27573527, 27573544, "c9orf72", C9_REPEAT, C9_PREFIX, C9_SUFFIX),
    ("chrX", 146993569, 146993628, "fmr1", FMR1_REPEAT, FMR1_PREFIX, FMR1_SUFFIX),
)

PARAMS = {
    "align": {"dist_offset": 16.0, "dist_min": 0.0, "gap_open_h": -1.0,
              "gap_open_v": -16.0, "gap_extension_h": -1.0,
              "gap_extension_v": -16.0, "samples": 6},
    "HMM": {"match_loop": 0.75, "match_match": 0.15, "match_insert": 0.09,
            "match_delete": 0.01, "insert_loop": 0.15, "insert_match_0": 0.40,
            "insert_match_1": 0.40, "insert_delete": 0.05, "delete_delete": 0.005,
            "delete_insert": 0.05, "delete_match": 0.945, "skip": 0.9999,
            "leave_repeat": 0.002, "seq_std_scale": 1.0, "rep_std_scale": 1.0,
            "seq_std_offset": 0.0, "rep_std_offset": 0.0, "e1_ratio": 0.1},
}


@dataclass(frozen=True)
class Assets:
    """Paths of one seeded asset set."""

    root: str
    model: str        # 6-mer pore model
    mod_model: str    # mCpG variant
    repeat_config: str
    params: str       # align/HMM JSON

    def row(self, name: str = "c9orf72") -> tuple:
        """The repeat config row of one locus (chr, begin, end, name, repeat, prefix, suffix)."""
        return next(r for r in LOCI if r[3] == name)


def _write_atomic(path: str, text: str) -> None:
    if os.path.exists(path):
        with open(path) as fp:
            if fp.read() == text:
                return
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fp:
        fp.write(text)
    os.replace(tmp, path)


def pore_model_tables(seed: int = SEED) -> tuple[list[str], np.ndarray, np.ndarray, np.ndarray]:
    """(k-mers, level means, level stdvs, mCpG level means) from ``seed``."""
    rng = np.random.default_rng(seed)
    kmers = ["".join(p) for p in itertools.product("ACGT", repeat=KMER)]
    means = rng.normal(95.0, 12.0, len(kmers))
    stdvs = rng.uniform(1.2, 2.5, len(kmers))
    shift = rng.uniform(0.6, 0.9, len(kmers)) * stdvs * rng.choice((-1.0, 1.0), len(kmers))
    has_cg = np.array(["CG" in k for k in kmers])
    mod_means = np.where(has_cg, means + shift, means)
    return kmers, means, stdvs, mod_means


def _model_text(kmers, means, stdvs) -> str:
    return "".join(f"{k}\t{m:.6f}\t{s:.6f}\n" for k, m, s in zip(kmers, means, stdvs))


def write_assets(root: str | None = None, seed: int = SEED) -> Assets:
    """Write the pore models, repeat config and parameter JSON under ``root``.

    ``root`` defaults to ``<checkout>/.synthetic/seed<seed>`` (git-ignored).
    """
    from .platform import CHECKOUT

    root = root or os.path.join(CHECKOUT, ".synthetic", f"seed{seed}")
    os.makedirs(root, exist_ok=True)
    kmers, means, stdvs, mod_means = pore_model_tables(seed)
    a = Assets(root=root,
               model=os.path.join(root, "r9_4_synthetic.model"),
               mod_model=os.path.join(root, "r9_4_synthetic_mCpG.model"),
               repeat_config=os.path.join(root, "repeat_config.tsv"),
               params=os.path.join(root, "STRique.json"))
    _write_atomic(a.model, _model_text(kmers, means, stdvs))
    _write_atomic(a.mod_model, _model_text(kmers, mod_means, stdvs))
    rows = ["chr\tbegin\tend\tname\trepeat\tprefix\tsuffix"]
    rows += ["\t".join(str(c) for c in locus) for locus in LOCI]
    _write_atomic(a.repeat_config, "\n".join(rows) + "\n")
    _write_atomic(a.params, json.dumps(PARAMS, indent=2) + "\n")
    return a


_DEFAULT: dict = {}


def default_assets() -> Assets:
    """The default-seed asset set, written once per process."""
    if "a" not in _DEFAULT:
        _DEFAULT["a"] = write_assets()
    return _DEFAULT["a"]


def locus_read(pm, locus: tuple, n_units: int, backbone: str, strand: str = "+",
               rng=None, noise: bool = False, samples: int = 8) -> np.ndarray:
    """Raw signal of one read: backbone half, locus with ``n_units``, backbone half."""
    from .detect.counter import reverse_complement

    repeat, prefix, suffix = locus[4], locus[5], locus[6]
    half = len(backbone) // 2
    seq = backbone[:half] + prefix + repeat * n_units + suffix + backbone[half:]
    if strand == "-":
        seq = reverse_complement(seq)
    return pm.generate_signal(seq, samples=samples, noise=noise, rng=rng)


def write_run(root: str, assets: Assets, n_reads: int = 16, seed: int = SEED,
              units=(20, 60, 100), backbone_bp: int = 1200) -> dict:
    """A seeded sequencing run: one bulk fast5 plus a SAM alignment.

    Reads alternate strands and cycle through ``units`` repeat counts at
    the c9orf72 locus; each SAM row spans the locus.  Returns
    ``{"dir", "fast5", "sam", "expected": {read_id: (strand, units)}}``.
    """
    import h5py

    from .pore_model import PoreModel

    os.makedirs(root, exist_ok=True)
    pm = PoreModel(assets.model)
    locus = assets.row("c9orf72")
    rng = np.random.default_rng(seed)
    f5_path = os.path.join(root, "run.fast5")
    sam_path = os.path.join(root, "run.sam")
    expected = {}
    sam = ["@HD\tVN:1.6"]
    with h5py.File(f5_path, "w") as f5:
        f5.attrs["file_version"] = "2.0"
        for k in range(n_reads):
            rid = f"{k:08x}-5eed-4000-8000-{seed:012x}"
            strand = "+" if k % 2 == 0 else "-"
            n_units = int(units[k % len(units)])
            bb = "".join(rng.choice(list("ACGT"), backbone_bp))
            sig = locus_read(pm, locus, n_units, bb, strand=strand, rng=rng, noise=True)
            raw = f5.create_group(f"read_{rid}/Raw")
            raw.attrs["read_id"] = np.bytes_(rid.encode())
            raw.attrs["read_number"] = k
            raw.attrs["duration"] = len(sig)
            raw.create_dataset("Signal", data=np.round(sig * 10.0).astype(np.int16))
            expected[rid] = (strand, n_units)
            flag = 0 if strand == "+" else 16
            sam.append(f"{rid}\t{flag}\t{locus[0]}\t{locus[1] - 20000}\t60\t40000M"
                       "\t*\t0\t0\t*\t*")
    with open(sam_path, "w") as fp:
        fp.write("\n".join(sam) + "\n")
    return {"dir": root, "fast5": f5_path, "sam": sam_path, "expected": expected}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Write the seeded stand-in assets")
    ap.add_argument("--out", default=None, help="output directory")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--run_reads", type=int, default=0,
                    help="also write a bulk fast5 + SAM run with this many reads")
    args = ap.parse_args(argv)
    a = write_assets(args.out, args.seed)
    print(a)
    if args.run_reads:
        run = write_run(os.path.join(a.root, "run"), a, args.run_reads, args.seed)
        print(run["fast5"], run["sam"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
