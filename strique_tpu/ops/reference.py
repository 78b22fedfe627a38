"""NumPy reference oracles for the two DP kernels.

These are slow, exact (float64 by default) host implementations used as
test oracles and as a CPU fallback engine:

  * :func:`semiglobal_align_np` — semi-global affine-gap alignment of a
    short template ``b`` into a long signal ``a`` with free end gaps on
    the signal axis.  Replicates the reference's native aligner
    (reference src/align_raw.h:106-158: SeqAn ``globalAlignment`` with
    ``AlignConfig<true,false,false,true>`` + ``AffineGaps`` and the
    custom distance score of src/score_distance.h:115-122).
  * :func:`viterbi_np` — dense log-space Viterbi with traceback over a
    compiled HMM (replacing pomegranate's Viterbi, reference
    scripts/STRique.py:434).

Alignment semantics (derived from SeqAn2's DP engine):
  * score(h, v) = max(dist_offset - |h-v|^1.2, dist_min)
  * affine gaps: a gap of length g costs gap_open + (g-1)*gap_extend;
    horizontal gap consumes signal (gap in template), vertical gap
    consumes template (gap in signal).  Gaps may open from any state of
    the predecessor cell (Gotoh with combined best).
  * free end gaps on the signal: DP row 0 initialised to zero and the
    final score is the max over the last row (template fully consumed),
    leftmost column on ties.
  * traceback tie-breaking: diagonal > vertical > horizontal for the
    best-matrix choice; gap extension preferred over opening on ties.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NEG = -1e30


@dataclass(frozen=True)
class AlignParams:
    """Alignment scoring parameters (reference scripts/STRique.py:507-513 defaults)."""

    dist_offset: float = 16.0
    dist_min: float = 0.0
    gap_open_h: float = -1.0
    gap_open_v: float = -16.0
    gap_extension_h: float = -1.0
    gap_extension_v: float = -16.0


# matrix ids
MAT_M, MAT_H, MAT_V = 0, 1, 2


def _pick_best(m: np.ndarray, h: np.ndarray, v: np.ndarray):
    """Best score and matrix id with preference M > V > H on ties."""
    best = np.maximum(np.maximum(m, h), v)
    which = np.where(m >= best, MAT_M, np.where(v >= best, MAT_V, MAT_H))
    return best, which


def semiglobal_align_np(a, b, params: AlignParams = AlignParams(), dtype=np.float64,
                        full: bool = False):
    """Align template ``b`` (len M) into signal ``a`` (len N), free end gaps on ``a``.

    Returns ``(score, a_idx, b_idx)`` — the alignment score and the view
    positions of every element of ``a`` and ``b`` in the gapped alignment,
    exactly like the reference binding ``pyseqan.align_overlap``
    (reference src/pyalign.cpp:47-63, src/align_raw.h:139-147).
    With ``full=True`` also returns ``(j_begin, j_end)`` — the DP's own
    aligned-span columns (view positions cannot recover them when the
    optimal path starts/ends with horizontal gaps, e.g. under positive
    gap scores).
    """
    a = np.asarray(a, dtype=dtype)
    b = np.asarray(b, dtype=dtype)
    n, m = len(a), len(b)
    go_h, go_v = dtype(params.gap_open_h), dtype(params.gap_open_v)
    ge_h, ge_v = dtype(params.gap_extension_h), dtype(params.gap_extension_v)

    # carry: columns over template rows i=0..m
    S = np.full(m + 1, NEG, dtype=dtype)
    Ih = np.full(m + 1, NEG, dtype=dtype)
    Iv = np.full(m + 1, NEG, dtype=dtype)
    # column j=0: only vertical gaps from the (free) origin
    S[0] = 0.0
    Iv[1:] = go_v + ge_v * np.arange(m, dtype=dtype)
    S[1:] = Iv[1:]
    # pointer bits per cell (i>=1), per column: bit0-1 best matrix,
    # bit2 Ih-extend, bit3 Iv-extend
    ptr = np.zeros((n + 1, m), dtype=np.uint8)
    ptr[0, :] = MAT_V | (1 << 3)  # column 0 is a pure vertical gap chain
    bottom = np.full(n + 1, NEG, dtype=dtype)
    bottom[0] = S[m]

    # Within-column vertical recursion, closed form:
    #   Iv[i] = max(Iv[i-1] + ge_v, Snew[i-1] + go_v)
    # with Snew = max(M, Ih, Iv) and Snew[0] = 0 (free top row).  Folding the
    # Iv self-reference gives, with g = max(ge_v, go_v) (re-opening mid-gap):
    #   Iv[i] = g*i + cummax(Q[k] + go_v - (k+1)*g)[i-1],  Q = max(M, Ih), Q[0]=0.
    g = max(ge_v, go_v)
    idx = np.arange(m + 1, dtype=dtype)
    for j in range(1, n + 1):
        diff = np.abs(a[j - 1] - b)
        sc = np.maximum(params.dist_offset - np.power(diff, dtype(1.2)), params.dist_min).astype(dtype)
        newM = np.concatenate(([NEG], S[:-1] + sc))
        ih_ext = Ih + ge_h
        ih_open = S + go_h
        newIh = np.maximum(ih_ext, ih_open)
        newIh[0] = NEG
        Q = np.maximum(newM, newIh)
        Q[0] = 0.0  # free top row
        c = Q + go_v - (idx + 1) * g
        cmax = np.maximum.accumulate(c)
        newIv = np.full(m + 1, NEG, dtype=dtype)
        newIv[1:] = cmax[:-1] + idx[1:] * g
        newS, which = _pick_best(newM, newIh, newIv)
        newS[0] = 0.0
        which[0] = MAT_M
        pb = which[1:].astype(np.uint8)
        pb |= (ih_ext[1:] >= ih_open[1:]).astype(np.uint8) << 2
        # Iv-extend bit for row i: extension wins if Iv[i-1]+ge_v >= Snew[i-1]+go_v
        sv_prev = np.maximum(Q[:-1], newIv[:-1])
        sv_prev[0] = 0.0
        pb |= (newIv[:-1] + ge_v >= sv_prev + go_v).astype(np.uint8) << 3
        ptr[j, :] = pb
        S, Ih, Iv = newS, newIh, newIv
        bottom[j] = S[m]

    j_end = int(np.argmax(bottom))
    score = dtype(bottom[j_end])

    # --- traceback -------------------------------------------------------
    # determine end matrix at (m, j_end)
    ops = []  # list of 'D' (diag), 'H' (gap in b), 'V' (gap in a), backward
    i, j = m, j_end
    # recompute matrices at the end cell: we only stored best/pointers, so
    # walk using pointer bits.  Current matrix: best of the end cell.
    cur = int(ptr[j, i - 1] & 0x3) if i >= 1 else MAT_M
    while i > 0:
        byte = int(ptr[j, i - 1])
        if cur == MAT_M:
            ops.append("D")
            i -= 1
            j -= 1
            cur = int(ptr[j, i - 1] & 0x3) if i >= 1 else MAT_M
        elif cur == MAT_H:
            ops.append("H")
            ext = (byte >> 2) & 1
            j -= 1
            if ext:
                cur = MAT_H
            else:
                cur = int(ptr[j, i - 1] & 0x3) if i >= 1 else MAT_M
        else:  # MAT_V
            ops.append("V")
            ext = (byte >> 3) & 1
            i -= 1
            if ext:
                cur = MAT_V
            else:
                cur = int(ptr[j, i - 1] & 0x3) if i >= 1 else MAT_M
    j_begin = j
    ops.reverse()

    # --- view positions --------------------------------------------------
    a_idx = np.zeros(n, dtype=np.uint64)
    b_idx = np.zeros(m, dtype=np.uint64)
    col = 0
    ai = 0
    bi = 0
    for _ in range(j_begin):  # leading free region: a vs gaps in b
        a_idx[ai] = col
        ai += 1
        col += 1
    for op in ops:
        if op == "D":
            a_idx[ai] = col
            b_idx[bi] = col
            ai += 1
            bi += 1
        elif op == "H":
            a_idx[ai] = col
            ai += 1
        else:
            b_idx[bi] = col
            bi += 1
        col += 1
    while ai < n:  # trailing free region
        a_idx[ai] = col
        ai += 1
        col += 1
    if full:
        return float(score), a_idx, b_idx, j_begin, j_end
    return float(score), a_idx, b_idx


def detect_range_np(signal, segment, params: AlignParams = AlignParams(),
                    pre_trim: int = 0, post_trim: int = 0, dtype=np.float64):
    """Replicates reference ``repeatCounter.__detect_range__`` (STRique.py:538-548).

    Returns (per-sample score, segment_begin, segment_end) in signal coords.
    """
    score, a_idx, b_idx = semiglobal_align_np(signal, segment, params, dtype=dtype)
    a_idx = a_idx.astype(np.int64)
    b_idx = b_idx.astype(np.int64)
    seg_begin = int(np.abs(a_idx - b_idx[0]).argmin())
    seg_end = int(np.abs(a_idx - b_idx[-1]).argmin())
    if seg_end > seg_begin:
        score = score / (seg_end - seg_begin)
    else:
        score = 0.0
    seg_begin = int(np.abs(a_idx - b_idx[0 + pre_trim]).argmin())
    seg_end = int(np.abs(a_idx - b_idx[-1 - post_trim]).argmin())
    return score, seg_begin, seg_end


# ---------------------------------------------------------------------------
# Viterbi oracle
# ---------------------------------------------------------------------------

def viterbi_np(observations, log_start, log_trans, log_end, mu, sigma, is_uniform, log_uni):
    """Dense log-space Viterbi with traceback (float64).

    States are emitting-only (silent states eliminated at compile time,
    see strique_tpu.hmm.compile).  Emissions: Normal(mu, sigma) logpdf or
    a constant ``log_uni`` for uniform states.  Returns (logp, path).
    Ties broken towards the lowest state index.
    """
    obs = np.asarray(observations, dtype=np.float64)
    T = len(obs)
    S = len(log_start)
    bp = np.zeros((T, S), dtype=np.int32)

    def emit(x):
        norm = -0.5 * np.log(2 * np.pi * sigma**2) - 0.5 * ((x - mu) / sigma) ** 2
        return np.where(is_uniform, log_uni, norm)

    score = log_start + emit(obs[0])
    for t in range(1, T):
        cand = score[:, None] + log_trans  # (u, v)
        bp[t] = np.argmax(cand, axis=0)
        score = cand[bp[t], np.arange(S)] + emit(obs[t])
    final = score + log_end
    last = int(np.argmax(final))
    logp = float(final[last])
    path = np.zeros(T, dtype=np.int32)
    path[T - 1] = last
    for t in range(T - 1, 0, -1):
        path[t - 1] = bp[t, path[t]]
    return logp, path


# ---------------------------------------------------------------------------
# whole-read oracle
# ---------------------------------------------------------------------------

def detect_np(pm, tc, raw, params: AlignParams = AlignParams()):
    """Float64 oracle for one read: preprocessing -> DP bounds -> Viterbi.

    Mirrors ``RepeatCounter.detect`` semantics (reference
    STRique.py:581-616) sharing no device code: exact NumPy
    preprocessing, the full-matrix f64 DP (:func:`detect_range_np`) and
    the dense f64 Viterbi (:func:`viterbi_np`).  ``tc`` is one strand's
    ``TargetClassifier``.  Returns (count, score_prefix, score_suffix).
    """
    from ..pore_model import mean_abs_dev
    from . import signal as signal_ops
    from .viterbi import count_repeats

    raw = np.asarray(raw, np.float64)
    flt = signal_ops.medfilt3(raw)
    morph = signal_ops.quantize_morph_np(flt, float(np.median(flt)), mean_abs_dev(flt))
    morph = signal_ops.open_close_np(morph)
    morph = pm.normalize2model(morph, mode="minmax")
    flt = pm.normalize2model(flt, mode="minmax")
    trim_prefix = len(tc.prefix_ext) - len(tc.prefix)
    trim_suffix = len(tc.suffix_ext) - len(tc.suffix)
    sp, prefix_begin, _ = detect_range_np(
        morph, np.asarray(tc.prefix_ext, np.float64), params, pre_trim=trim_prefix)
    ss, _, suffix_end = detect_range_np(
        morph, np.asarray(tc.suffix_ext, np.float64), params, post_trim=trim_suffix)
    if not (prefix_begin < suffix_end and sp > 0 and ss > 0):
        return 0, sp, ss
    chm = tc.repeat_hmm
    seg = flt[prefix_begin:suffix_end]
    _, path = viterbi_np(seg, chm.log_start, chm.log_trans, chm.log_end,
                         chm.mu, chm.sigma, chm.is_uniform, chm.log_uni)
    return count_repeats(path, len(seg), chm), sp, ss
