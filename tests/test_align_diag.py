"""The anti-diagonal sweep (ops.align.align_diag), the executable spec of
the CUDA flank-DP kernel's output, against the column scan and the
float64 oracle.

Both sweeps carry the same float32 expression trees (the column cummax
rides as a running per-row value on the diagonal), so scores, end
columns and whole tracebacks must agree bitwise; the layout, per-row
templates, launch splitting and degenerate reads are pinned here because
the kernel itself has no CPU mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from strique_tpu.ops import align as A
from strique_tpu.ops.reference import AlignParams, semiglobal_align_np

FIELDS = ("score", "j_end", "is_gap", "jpos", "j_begin")
PARAMS = {
    "default": AlignParams(),
    "affine": AlignParams(gap_open_h=-3.0, gap_extension_h=-0.5,
                          gap_open_v=-20.0, gap_extension_v=-4.0),
    "positive_h": AlignParams(gap_open_h=1.0, gap_extension_h=0.5),
    "floor": AlignParams(dist_min=8.0, gap_open_v=-4.0),
}


def _planted(rng, B, N, M):
    template = rng.uniform(60, 120, M).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B // 2):
        st = 30 + i * 40
        signals[i, st : st + M] = template + rng.normal(0, 0.5, M)
    na = rng.integers(N // 2, N, B).astype(np.int32)
    return signals, na, template


def _assert_same(ref, got, msg=""):
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(ref[k]), np.asarray(got[k]),
                                      err_msg=f"{msg} {k}")


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_diag_matches_scan(name):
    rng = np.random.default_rng(7)
    signals, na, template = _planted(rng, 8, 384, 40)
    p = PARAMS[name]
    _assert_same(A.align_batch(signals, na, template, p, impl="xla"),
                 A.align_batch(signals, na, template, p, impl="diag"), name)


def test_diag_matches_f64_oracle():
    rng = np.random.default_rng(11)
    signals, na, template = _planted(rng, 6, 200, 16)
    got = A.align_batch(signals, na, template, AlignParams(), impl="diag")
    for i in range(len(signals)):
        n = int(na[i])
        s_o, _a, _b, j_begin, j_end = semiglobal_align_np(
            signals[i, :n].astype(np.float64), template.astype(np.float64),
            AlignParams(), full=True)
        assert abs(float(got["score"][i]) - s_o) / max(abs(s_o), 1.0) < 1e-4
        assert int(got["j_end"][i]) == j_end
        assert int(got["j_begin"][i]) == j_begin


def test_fused_pair_per_row_templates():
    """Both flanks as one row stream with per-row templates of unequal
    length equal two separate single-template alignments."""
    rng = np.random.default_rng(17)
    B, N = 6, 400
    t_pre = rng.uniform(60, 120, 40).astype(np.float32)
    t_suf = rng.uniform(60, 120, 28).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B):
        st = 30 + i * 40
        signals[i, st : st + 40] = t_pre + rng.normal(0, 0.5, 40)
        signals[i, st + 60 : st + 88] = t_suf + rng.normal(0, 0.5, 28)
    na = rng.integers(300, N, B).astype(np.int32)
    p = AlignParams()
    pre, suf = A.align_fused_pair(signals, na, t_pre, t_suf, p, impl="diag")
    _assert_same(A.align_batch(signals, na, t_pre, p, impl="xla"), pre, "pre")
    _assert_same(A.align_batch(signals, na, t_suf, p, impl="xla"), suf, "suf")


def test_degenerate_reads():
    """No match anywhere (end column may be the virtual column 0), a read
    shorter than the template, and a match at the very end of the read."""
    rng = np.random.default_rng(23)
    B, N, M = 4, 256, 24
    template = rng.uniform(60, 120, M).astype(np.float32)
    signals = np.full((B, N), 200.0, np.float32)
    na = np.full(B, N - 10, np.int32)
    signals[1] = rng.uniform(60, 120, N)
    na[2] = 8
    signals[3, N - 10 - M : N - 10] = template
    p = AlignParams()
    _assert_same(A.align_batch(signals, na, template, p, impl="xla"),
                 A.align_batch(signals, na, template, p, impl="diag"))


def test_launch_split_under_budget(monkeypatch):
    """A pointer budget that holds only a few rows splits the batch into
    narrower launches with identical results."""
    from strique_tpu import platform

    rng = np.random.default_rng(29)
    signals, na, template = _planted(rng, 8, 256, 20)
    p = AlignParams()
    whole = A.align_batch(signals, na, template, p, impl="diag")
    mp = A.row_pad(len(template))
    per_row = platform.ptr_row_bytes(256, mp)
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", str(3.5 * per_row / (1 << 30)))
    assert platform.launch_rows(8, 256, mp) == 3
    _assert_same(whole, A.align_batch(signals, na, template, p, impl="diag"))


def test_diag_pointer_layout_and_traceback():
    """The plane is (ceil((N+MP)/8), R, MP) int32; walking it with
    traceback_pointers(packed='diag') from each row's own template length
    reproduces the per-row alignments."""
    rng = np.random.default_rng(31)
    t_a = rng.uniform(60, 120, 30).astype(np.float32)
    t_b = rng.uniform(60, 120, 12).astype(np.float32)
    rows, ms = A.pad_template_rows([t_a, t_b])
    assert rows.shape == (2, 128) and list(ms) == [30, 12]
    assert np.all(rows[:, 0] == 1e30) and np.all(rows[1, 13:] == 1e30)
    sig = rng.uniform(60, 120, (2, 100)).astype(np.float32)
    na = np.array([100, 77], np.int32)
    ptr, score, j_end = A.align_diag(jnp.asarray(sig), jnp.asarray(na), jnp.asarray(rows),
                                     jnp.asarray(ms), AlignParams())
    assert ptr.shape == (-(-(100 + 128) // 8), 2, 128) and ptr.dtype == jnp.int32
    tb = A.traceback_diag(ptr, j_end, jnp.asarray(ms), 30)
    for r, t in enumerate((t_a, t_b)):
        ref = A.align_scan(jnp.asarray(sig[r]), jnp.int32(na[r]), jnp.asarray(t), AlignParams())
        assert float(score[r]) == float(ref["score"]) and int(j_end[r]) == int(ref["j_end"])
        np.testing.assert_array_equal(np.asarray(tb["jpos"][r, : len(t)]), np.asarray(ref["jpos"]))
        np.testing.assert_array_equal(np.asarray(tb["is_gap"][r, : len(t)]),
                                      np.asarray(ref["is_gap"]))
        assert int(tb["j_begin"][r]) == int(ref["j_begin"])


def test_issued_cells_from_launch_shape(monkeypatch):
    from strique_tpu import platform

    A.reset_kernel_stats()
    monkeypatch.setattr(platform, "align_impl", lambda: "cuda")
    A.count_issued_cells_estimate(64, 24576, 870, 880)
    assert A.kernel_stats()["cells"] == 128 * (24576 + 896) * 896
    A.reset_kernel_stats()
    monkeypatch.setattr(platform, "align_impl", lambda: "xla")
    A.count_issued_cells_estimate(8, 1024, 10, 20)
    assert A.kernel_stats()["cells"] == 8 * 1024 * 11 + 8 * 1024 * 21
    A.reset_kernel_stats()
