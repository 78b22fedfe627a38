"""Randomized end-to-end parity: production pipeline vs the f64 oracle.

The oracle engine (ops/reference.py::detect_np) shares no
kernel code with the production path: NumPy preprocessing, full-matrix
float64 affine DP with SeqAn view-position semantics
(ops/reference.py::detect_range_np), dense float64 Viterbi (viterbi_np).
Agreement on randomized noisy reads pins the whole device pipeline — prep,
alignment, bounds, gate, Viterbi, count decode — against an independent
implementation of the reference's math (reference STRique.py:581-616).
"""
import numpy as np
import pytest

from strique_tpu.detect.counter import RepeatCounter, reverse_complement
from strique_tpu.ops.reference import detect_np as oracle_detect
from strique_tpu.pore_model import PoreModel
from strique_tpu.synthetic import default_assets

MODEL = default_assets().model
ROW = open(default_assets().repeat_config).read().strip().split("\n")[1].split()
REPEAT, PREFIX, SUFFIX = ROW[4], ROW[5], ROW[6]


@pytest.fixture(scope="module")
def assets():
    pm = PoreModel(MODEL)
    rc = RepeatCounter(MODEL)
    rc.add_target("c9", REPEAT, PREFIX, SUFFIX)
    return pm, rc


def test_randomized_reads_match_oracle(assets):
    pm, rc = assets
    rng = np.random.default_rng(20260820)
    cases = []
    for k in range(6):
        nrep = int(rng.integers(8, 22))
        bb_n = int(rng.integers(200, 500))
        bb = "".join(rng.choice(list("ACTG"), 2 * bb_n))
        seq = bb[:bb_n] + PREFIX + REPEAT * nrep + SUFFIX + bb[bb_n:]
        strand = "+" if k % 2 == 0 else "-"
        if strand == "-":
            seq = reverse_complement(seq)
        sig = pm.generate_signal(seq, samples=8, noise=True, rng=rng)
        cases.append((strand, nrep, sig))

    for strand in "+-":
        batch = [(s, n, sig) for s, n, sig in cases if s == strand]
        if not batch:
            continue
        res = rc.detect_many("c9", [sig for _, _, sig in batch], strand)
        tc = rc.targets["c9"][0 if strand == "+" else 1]
        for (s, nrep, sig), row in zip(batch, res):
            oc, sp, ss = oracle_detect(pm, tc, sig)
            assert row[0] == oc, (
                f"strand {s} inserted {nrep}: kernel count {row[0]} != oracle {oc}")
            assert row[0] == nrep, f"count {row[0]} != inserted {nrep}"
            np.testing.assert_allclose(row[1], sp, rtol=2e-3)
            np.testing.assert_allclose(row[2], ss, rtol=2e-3)


def test_gated_read_matches_oracle(assets):
    """A no-locus read must be rejected by both engines identically."""
    pm, rc = assets
    rng = np.random.default_rng(9)
    sig = pm.generate_signal("".join(rng.choice(list("ACTG"), 1200)), samples=8)
    row = rc.detect("c9", sig, "+")
    tc = rc.targets["c9"][0]
    oc, sp, ss = oracle_detect(pm, tc, sig)
    assert row[0] == oc == 0
