"""Alignment kernel tests: oracle self-consistency and JAX-vs-oracle parity."""
import numpy as np
import pytest

from strique_tpu.ops.reference import AlignParams, detect_range_np, semiglobal_align_np

NEG = -1e30
PARAMS = AlignParams()


def full_dp_score(a, b, p):
    """Explicit cell-by-cell Gotoh for score cross-checking."""
    n, m = len(a), len(b)
    Ih = np.full((m + 1, n + 1), NEG)
    Iv = np.full((m + 1, n + 1), NEG)
    S = np.full((m + 1, n + 1), NEG)
    S[0, :] = 0.0
    for i in range(1, m + 1):
        Iv[i, 0] = p.gap_open_v + (i - 1) * p.gap_extension_v
        S[i, 0] = Iv[i, 0]
    for j in range(1, n + 1):
        for i in range(1, m + 1):
            sc = max(p.dist_offset - abs(a[j - 1] - b[i - 1]) ** 1.2, p.dist_min)
            M = S[i - 1, j - 1] + sc
            Ih[i, j] = max(Ih[i, j - 1] + p.gap_extension_h, S[i, j - 1] + p.gap_open_h)
            Iv[i, j] = max(Iv[i - 1, j] + p.gap_extension_v, S[i - 1, j] + p.gap_open_v)
            S[i, j] = max(M, Ih[i, j], Iv[i, j])
    return S[m].max()


def test_oracle_score_vs_full_dp():
    rng = np.random.default_rng(0)
    for _ in range(8):
        n, m = int(rng.integers(10, 60)), int(rng.integers(3, 12))
        a = rng.uniform(60, 120, n)
        b = rng.uniform(60, 120, m)
        s, _, _ = semiglobal_align_np(a, b, PARAMS)
        assert np.isclose(s, full_dp_score(a, b, PARAMS))


def test_oracle_affine_gaps_score_vs_full_dp():
    p = AlignParams(gap_open_h=-3.0, gap_extension_h=-0.5, gap_open_v=-20.0, gap_extension_v=-4.0)
    rng = np.random.default_rng(1)
    for _ in range(8):
        n, m = int(rng.integers(10, 60)), int(rng.integers(3, 12))
        a = rng.uniform(60, 120, n)
        b = rng.uniform(60, 120, m)
        s, _, _ = semiglobal_align_np(a, b, p)
        assert np.isclose(s, full_dp_score(a, b, p))


def test_oracle_view_positions_valid():
    rng = np.random.default_rng(2)
    a = rng.uniform(60, 120, 80)
    b = a[20:35] + rng.normal(0, 0.3, 15)
    s, a_idx, b_idx = semiglobal_align_np(a, b, PARAMS)
    a_idx = a_idx.astype(int)
    b_idx = b_idx.astype(int)
    assert np.all(np.diff(a_idx) >= 1)
    assert np.all(np.diff(b_idx) >= 1)
    # each view column hosts at most one a and one b element
    assert len(set(a_idx)) == len(a_idx)
    assert len(set(b_idx)) == len(b_idx)


def test_oracle_finds_planted_segment():
    rng = np.random.default_rng(3)
    a = rng.uniform(60, 120, 200)
    b = a[50:80] + rng.normal(0, 0.5, 30)
    _, beg, end = detect_range_np(a, b, PARAMS)
    assert abs(beg - 50) <= 1
    assert abs(end - 79) <= 1


def test_jax_matches_oracle():
    from strique_tpu.ops.align import detect_range

    rng = np.random.default_rng(4)
    m, npad = 24, 256
    for trial in range(6):
        n = int(rng.integers(120, 250))
        a = rng.uniform(60, 120, n)
        b = rng.uniform(60, 120, m)
        s_o, b_o, e_o = detect_range_np(a, b, PARAMS, pre_trim=2, post_trim=3)
        apad = np.zeros(npad, np.float32)
        apad[:n] = a
        s_d, b_d, e_d = detect_range(apad, n, b.astype(np.float32), PARAMS, pre_trim=2, post_trim=3)
        assert (b_o, e_o) == (b_d, e_d), f"trial {trial}"
        assert np.isclose(s_o, s_d, atol=1e-3)


def test_jax_padding_invariance():
    from strique_tpu.ops.align import detect_range

    rng = np.random.default_rng(5)
    n, m = 200, 24
    a = rng.uniform(60, 120, n)
    b = rng.uniform(60, 120, m)
    results = []
    for npad in (256, 320):
        apad = np.zeros(npad, np.float32)
        apad[:n] = a
        results.append(detect_range(apad, n, b.astype(np.float32), PARAMS, pre_trim=1, post_trim=1))
    assert results[0][1:] == results[1][1:]
    assert np.isclose(results[0][0], results[1][0], atol=1e-4)


def test_kernel_batch_ptr_budget_cap(monkeypatch):
    """Long reads must shrink the flank-DP launch width so the
    traceback-pointer plane stays inside the device-memory budget instead
    of running out of memory at full width (the reference's CPU DP has no
    such cliff, src/align_raw.h:117-158), and a single row past the
    budget must fail with a message naming the read length and budget."""
    from strique_tpu import platform

    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "3.5")
    budget = platform.ptr_budget_bytes()
    assert budget == int(3.5 * (1 << 30))
    # bench-scale reads: 128 rows (64 reads x 2 flanks) fit one launch
    assert platform.launch_rows(128, 24576, 896) == 128
    # ~900k-sample bucket: the width drops to what the budget holds
    per_row = platform.ptr_row_bytes(917504, 896)
    kb = platform.launch_rows(128, 917504, 896)
    assert kb == budget // per_row and 1 <= kb < 128
    assert kb * per_row <= budget < (kb + 1) * per_row
    # one row past the budget raises, naming the read length
    with pytest.raises(ValueError, match="8388608-sample read"):
        platform.launch_rows(8, 8 * 1024 * 1024, 896)
    # a malformed override falls back instead of raising
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "not-a-number")
    assert platform.ptr_budget_bytes() > 0
    # without an override the budget comes from device stats (or the
    # 3.5 GB fallback) and is always a sane positive size
    monkeypatch.delenv("STRIQUE_PTR_BUDGET_GB", raising=False)
    assert platform.ptr_budget_bytes() >= (1 << 28)
