"""Fused single-D2H detection path: parity vs the two-phase host path."""
import numpy as np
import pytest

from strique_tpu.detect.counter import RepeatCounter
from strique_tpu.ops import align as align_ops
from strique_tpu.ops.bounds import nearest_positions
from strique_tpu.pore_model import PoreModel
from strique_tpu.synthetic import default_assets

MODEL = default_assets().model
PREFIX = ("CGGCAGCCGAACCCCAAACAGCCACCCGCCAGGATGCCGCCTCCTCACT"
          "CACCCACTCGCCACCGCCTGCGCCTCCGCCGCCGCGGGCGCAGG")
SUFFIX = ("TAGCGCGCGACTCCTGAGTTCCAGAGCTTGCTACAGGCTGCGGTTGTTT"
          "CCCTCCTTGTTTTCTTCTGGTTAATCTTTATCAGGTCTTTTCTTG")


def test_nearest_positions_matches_host():
    rng = np.random.default_rng(0)
    for trial in range(20):
        m = int(rng.integers(5, 60))
        is_gap = rng.random(m) < 0.35
        jpos = np.sort(rng.integers(0, 200, m)).astype(np.int64)
        # gap runs share the left-neighbor position like real tracebacks
        for k in range(1, m):
            if is_gap[k] and is_gap[k - 1] and rng.random() < 0.7:
                jpos[k] = jpos[k - 1]
        n = 210
        host = align_ops._nearest_positions(is_gap, jpos, n)
        dev = np.asarray(nearest_positions(is_gap, jpos.astype(np.int32), n))
        np.testing.assert_array_equal(host, dev.astype(np.int64))


def _make_reads(n_reads, repeats, rng, pm):
    backbone = "".join(rng.choice(list("ACTG"), 1200))
    seq = backbone[:600] + PREFIX + "GGCCCC" * repeats + SUFFIX + backbone[600:]
    sigs = [pm.generate_signal(seq, samples=8, noise=True, rng=rng)
            for _ in range(n_reads)]
    mx = max(len(s) for s in sigs)
    return [np.pad(s, (0, mx - len(s)), mode="edge") for s in sigs]


def test_split_fused_two_phase_match():
    """All three detection pipelines — split (default: morph-only upload,
    segment-only Viterbi), fused (single dispatch, full-flt upload) and
    the two-phase host-bounds path — must produce identical rows."""
    pm = PoreModel(MODEL)
    counter = RepeatCounter(MODEL)
    counter.add_target("t", "GGCCCC", PREFIX, SUFFIX)
    rng = np.random.default_rng(42)
    sigs = _make_reads(3, 20, rng, pm)
    # no-locus read (random backbone) and a flat dead read (fails the QC
    # gate -> exercises the masked dummy lane through the fused viterbi)
    sigs.append(pm.generate_signal("".join(rng.choice(list("ACTG"), 1400)),
                                   samples=8))
    sigs.append(np.full(2000, 90.0))
    mx = max(len(s) for s in sigs)
    sigs = [np.pad(s, (0, mx - len(s)), mode="edge") for s in sigs]

    assert counter.split
    split = counter.detect_many("t", sigs, "+")

    counter.split = False
    fused = counter.detect_many("t", sigs, "+")

    counter.fused = False
    two_phase = counter.detect_many("t", sigs, "+")

    assert len(split) == len(fused) == len(two_phase) == 5
    for s, f, t in zip(split, fused, two_phase):
        assert s == f  # split and fused share kernels end to end: exact
        assert f[0] == t[0]  # count
        assert f[4] == t[4] and f[5] == t[5]  # offset, ticks
        np.testing.assert_allclose(f[1], t[1], rtol=1e-6)
        np.testing.assert_allclose(f[2], t[2], rtol=1e-6)
        np.testing.assert_allclose(f[3], t[3], rtol=1e-6)
    assert fused[0][0] == 20
