"""Semi-global affine alignment of a flank template into a raw signal.

Replaces the reference's native SeqAn DP engine (reference
src/align_raw.h:106-158, src/score_distance.h:115-122).  Three
implementations of one recurrence, with identical float32 value
streams:

  * :func:`align_scan` — the plain reference: ``lax.scan`` over signal
    columns carrying the three Gotoh state vectors over template rows;
    the within-column vertical-gap recursion is folded into an
    associative prefix max (``lax.cummax``).  Pointers are a (N, M)
    uint8 plane.  Runs wherever there is no CUDA kernel.
  * :func:`align_diag` — the same DP swept over anti-diagonals, with
    the column cummax carried as a running per-row value and 4-bit
    pointer codes packed 8 steps per int32 word (NOTES.md, "wavefront
    recurrence").  It is the executable specification of the CUDA
    kernel's output layout, in plain ``lax``.
  * the CUDA kernel behind :func:`strique_tpu.ops.cuda.wave_forward`,
    which computes exactly what :func:`align_diag` computes, one thread
    block per (read, template) row; the production path on a GPU.

Free end gaps on the signal axis only (template fully aligned), matching
``AlignConfig<true,false,false,true>`` of the reference
(src/align_raw.h:134-135).  Tie-breaking: leftmost end column, matrix
preference M > V > H, gap extension over opening.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import platform
from .reference import AlignParams, MAT_M, MAT_H, MAT_V

# plain numpy scalar: a module-level jnp constant would initialize the XLA
# backend at import time, breaking jax.distributed.initialize() ordering
NEG = np.float32(-1e30)
ROW_ALIGN = 128  # template rows per launch are padded to a multiple of this

# DP-cell accounting (BASELINE.md north star: DP cell-updates/s).  Host
# counters of the cells each dispatch issues, computed from its shapes;
# bench.py snapshots them around timed passes.
KERNEL_STATS = {"cells": 0, "calls": 0}


def _count_cells(rows: int, steps: int, lanes: int) -> None:
    KERNEL_STATS["cells"] += int(rows) * int(steps) * int(lanes)
    KERNEL_STATS["calls"] += 1


def reset_kernel_stats() -> None:
    KERNEL_STATS["cells"] = 0
    KERNEL_STATS["calls"] = 0


def kernel_stats() -> dict:
    return dict(KERNEL_STATS)


def row_pad(m_max: int) -> int:
    """Padded template-row count MP of a launch whose longest template is ``m_max``."""
    return -(-(m_max + 1) // ROW_ALIGN) * ROW_ALIGN


def count_issued_cells_estimate(B: int, npad: int, m_pre: int, m_suf: int) -> None:
    """Account the DP cells one batch's flank alignment issues.

    The jitted pipelines trace their align dispatch once, so this counts
    from the launch shape at the host call site: on the CUDA path 2B
    rows x (N + MP) diagonal steps x MP rows; on the scan path B reads x
    N columns x (m + 1) rows per flank.
    """
    if platform.align_impl() == "cuda":
        mp = row_pad(max(m_pre, m_suf))
        _count_cells(2 * B, npad + mp, mp)
        return
    for m in (m_pre, m_suf):
        _count_cells(B, npad, m + 1)


@partial(jax.jit, static_argnames=("params", "with_traceback"))
def align_scan(signal, n_actual, template, params: AlignParams, with_traceback: bool = True):
    """Run the DP over ``signal`` (padded to static length) vs ``template``.

    Args:
      signal: (N,) float32, padded; only the first ``n_actual`` entries are real.
      n_actual: scalar int32, true signal length.
      template: (M,) float32 synthetic flank signal.
    Returns dict with ``score`` (f32), ``j_end`` (i32), and, when
    ``with_traceback``, ``is_gap`` (M, bool) / ``jpos`` (M, i32): per
    template element, whether it was consumed in a vertical gap and the
    signal index it maps to (left-neighbor index for gap elements).
    """
    signal = signal.astype(jnp.float32)
    template = template.astype(jnp.float32)
    m = template.shape[0]
    go_h = jnp.float32(params.gap_open_h)
    go_v = jnp.float32(params.gap_open_v)
    ge_h = jnp.float32(params.gap_extension_h)
    ge_v = jnp.float32(params.gap_extension_v)
    off = jnp.float32(params.dist_offset)
    dmin = jnp.float32(params.dist_min)
    g = jnp.maximum(ge_v, go_v)
    idx = jnp.arange(m + 1, dtype=jnp.float32)

    # column j=0.  The `0 * signal[0]` term is a no-op numerically but makes
    # the scan carry init depend on the (per-shard varying) signal, so the
    # kernel stays usable inside shard_map (varying-manual-axes typing).
    S0 = jnp.concatenate([jnp.zeros((1,), jnp.float32), go_v + ge_v * jnp.arange(m, dtype=jnp.float32)])
    S0 = S0 + 0.0 * signal[0]
    Ih0 = jnp.full((m + 1,), NEG) + 0.0 * signal[0]
    Iv0 = S0.at[0].set(NEG)

    def step(carry, xj):
        S, Ih, Iv = carry
        aj, j = xj
        diff = jnp.abs(aj - template)
        sc = jnp.maximum(off - jnp.power(diff, jnp.float32(1.2)), dmin)
        newM = jnp.concatenate([jnp.full((1,), NEG), S[:-1] + sc])
        ih_ext = Ih + ge_h
        ih_open = S + go_h
        newIh = jnp.maximum(ih_ext, ih_open).at[0].set(NEG)
        Q = jnp.maximum(newM, newIh).at[0].set(0.0)
        c = Q + go_v - (idx + 1.0) * g
        cmax = jax.lax.cummax(c)
        newIv = jnp.concatenate([jnp.full((1,), NEG), cmax[:-1] + idx[1:] * g])
        newS = jnp.maximum(jnp.maximum(newM, newIh), newIv).at[0].set(0.0)
        # best-matrix bits with preference M > V > H
        which = jnp.where(newM >= newS, MAT_M, jnp.where(newIv >= newS, MAT_V, MAT_H)).astype(jnp.uint8)
        pb = which[1:]
        pb = pb | ((ih_ext[1:] >= ih_open[1:]).astype(jnp.uint8) << 2)
        sv_prev = jnp.maximum(Q, newIv).at[0].set(0.0)[:-1]
        pb = pb | ((newIv[:-1] + ge_v >= sv_prev + go_v).astype(jnp.uint8) << 3)
        bottom = jnp.where(j <= n_actual, newS[m], NEG)
        ys = (pb, bottom) if with_traceback else (bottom,)
        return (newS, newIh, newIv), ys

    n = signal.shape[0]
    cols = jnp.arange(1, n + 1, dtype=jnp.int32)
    carry, ys = jax.lax.scan(step, (S0, Ih0, Iv0), (signal, cols))
    if with_traceback:
        ptrs, bottom = ys
    else:
        (bottom,) = ys
    bottom = jnp.concatenate([S0[m:], bottom])  # include column 0
    j_end = jnp.argmax(bottom).astype(jnp.int32)
    score = bottom[j_end]
    out = {"score": score, "j_end": j_end}
    if not with_traceback:
        return out
    out.update(traceback_pointers(ptrs, j_end, m))
    return out


def traceback_pointers(ptrs, j_end, m: int, packed=False, m_start=None):
    """Walk the 4-bit pointer array back from cell (m, j_end).

    ``ptrs``: (N, MP) with MP >= m; byte at [j-1, i-1] describes DP cell
    (row i, column j).  With ``packed='diag'`` (the layout of
    :func:`align_diag` and the CUDA kernel), the code of cell (i, j)
    sits at diagonal step t = i + j - 1: word [t//8, i], nibble t % 8 —
    and the V-extend bit lives at its SOURCE cell (bit 3 of (i, j)
    answers "does Iv(i+1, j) extend from here"), so the walk reads it
    from the cell it steps to.  Returns per-template-element gap flags
    and signal positions plus ``j_begin``.  ``m_start`` (traced)
    overrides the walk's start row for per-row template lengths; ``m``
    stays the static output size (entries at indices >= m_start are
    unused).
    """
    if packed == "diag":
        def lookup(jc, ic):
            t = jnp.maximum(ic + jc - 1, 0)
            word = ptrs[t // 8, ic]
            nib = (word >> (4 * (t % 8))) & 15
            return jnp.where(jc > 0, nib.astype(jnp.uint8), jnp.uint8(MAT_V | 8))
    else:
        def lookup(jc, ic):
            return jnp.where(jc > 0, ptrs[jnp.maximum(jc - 1, 0), ic - 1].astype(jnp.uint8),
                             jnp.uint8(MAT_V | 8))

    iota_m = jnp.arange(m, dtype=jnp.int32)

    def cond(state):
        i, j, cur, byte, is_gap, jpos = state
        return i > 0

    def body(state):
        # one lookup per step (the fetched next-cell byte is carried), and
        # masked dense row updates instead of scatters inside the vmapped loop
        i, j, cur, byte, is_gap, jpos = state
        is_m = cur == MAT_M
        is_h = cur == MAT_H
        is_v = cur == MAT_V
        # template element i-1 is consumed on diagonal or vertical moves
        consume = is_m | is_v
        sel = consume & (iota_m == i - 1)
        is_gap = jnp.where(sel, is_v, is_gap)
        jpos = jnp.where(sel, j - 1, jpos)
        ni = jnp.where(is_h, i, i - 1)
        nj = jnp.where(is_v, j, j - 1)
        nbyte = lookup(nj, ni)
        # diag layout: the V-extend bit lives at its source cell (the one
        # being stepped to); the unpacked layout keeps it at the current
        # cell.  Same value either way.
        vext_src = nbyte if packed == "diag" else byte
        ext = jnp.where(is_h, (byte >> 2) & 1, (vext_src >> 3) & 1)
        stay = (~is_m) & (ext == 1)
        ncur = jnp.where(stay, cur, jnp.where(ni > 0, (nbyte & 3).astype(jnp.int32), MAT_M))
        return ni, nj, ncur, nbyte, is_gap, jpos

    # inits are tainted with j_end for shard_map varying-axes typing (no-ops)
    i0 = (jnp.int32(m) if m_start is None else m_start.astype(jnp.int32)) + 0 * j_end
    byte0 = lookup(j_end, i0)
    cur0 = (byte0 & 3).astype(jnp.int32)
    is_gap0 = jnp.zeros((m,), dtype=bool) | (j_end < 0)
    jpos0 = jnp.zeros((m,), dtype=jnp.int32) + 0 * j_end
    _, j_begin, _, _, is_gap, jpos = jax.lax.while_loop(
        cond, body, (i0, j_end, cur0, byte0, is_gap0, jpos0))
    return {"is_gap": is_gap, "jpos": jpos, "j_begin": j_begin}


def pad_template_rows(templates, mp: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Per-row templates -> ((R, MP) rows with +1e30 pads, (R,) lengths).

    Row r holds template r at rows 1..m_r (row 0 is the DP's empty
    prefix); pads never win a match.
    """
    ms = np.array([len(t) for t in templates], np.int32)
    mp = mp or row_pad(int(ms.max()))
    out = np.full((len(templates), mp), 1e30, np.float32)
    for r, t in enumerate(templates):
        out[r, 1 : len(t) + 1] = np.asarray(t, np.float32)
    return out, ms


@partial(jax.jit, static_argnames=("params",))
def align_diag(signals, n_actual, tmpl_rows, m_rows, params: AlignParams):
    """Forward DP over anti-diagonals for R rows with per-row templates.

    signals: (R, N) f32; n_actual, m_rows: (R,) i32; tmpl_rows: (R, MP)
    f32 as built by :func:`pad_template_rows`.  Step t computes every
    cell (i, j) with i + j - 1 == t; the vertical-gap prefix max rides
    as a running value C(i, j) = max(C(i-1, j), Q(i, j) + go_v - (i+1)g)
    taken from the previous diagonal, so each step needs only shifted
    neighbours.  Returns (ptr, score, j_end): ptr (ceil((N+MP)/8), R, MP)
    int32 with the code of cell (i, j) in word [(i+j-1)//8, r, i],
    nibble (i+j-1) % 8; score/j_end the leftmost best bottom-row cell,
    the virtual column 0 included.  The CUDA kernel's outputs agree on
    every word a traceback can read.
    """
    R, N = signals.shape
    mp = tmpl_rows.shape[1]
    nd8 = -(-(N + mp) // 8)
    go_h = np.float32(params.gap_open_h)
    go_v = np.float32(params.gap_open_v)
    ge_h = np.float32(params.gap_extension_h)
    ge_v = np.float32(params.gap_extension_v)
    off = np.float32(params.dist_offset)
    dmin = np.float32(params.dist_min)
    g = np.float32(max(params.gap_extension_v, params.gap_open_v))
    signals = signals.astype(jnp.float32)
    n_actual = n_actual.astype(jnp.int32)
    m_rows = m_rows.astype(jnp.int32)
    lane_i = jnp.arange(mp, dtype=jnp.int32)[None, :]
    lane = lane_i.astype(jnp.float32)
    row0 = lane_i == 0
    col0 = jnp.where(row0, 0.0, go_v + ge_v * (lane - 1.0))
    msel = lane_i == m_rows[:, None]

    def shift1(x):
        return jnp.concatenate([jnp.full((R, 1), NEG), x[:, :-1]], axis=1)

    def diag_step(carry, t):
        S1, S2, Ih, C = carry
        a = jnp.take_along_axis(signals, jnp.clip(t - lane_i, 0, N - 1) + 0 * m_rows[:, None],
                                axis=1)
        diff = jnp.abs(a - tmpl_rows)
        sc = jnp.maximum(off - jnp.power(diff, np.float32(1.2)), dmin)
        ih_ext = Ih + ge_h
        ih_open = S1 + go_h
        newIh = jnp.maximum(ih_ext, ih_open)
        newM = shift1(S2) + sc
        Q = jnp.where(row0, 0.0, jnp.maximum(newM, newIh))
        cvec = Q + go_v - (lane + 1.0) * g
        C_sh = shift1(C)  # C(i-1, j): the column max down to row i-1
        newC = jnp.maximum(C_sh, cvec)
        newIv = C_sh + lane * g
        newS = jnp.maximum(Q, newIv)
        which = jnp.where(newM >= newS, MAT_M, jnp.where(newIv >= newS, MAT_V, MAT_H))
        code = (which | ((ih_ext >= ih_open).astype(jnp.int32) << 2)
                | ((newIv + ge_v >= newS + go_v).astype(jnp.int32) << 3))
        # cell (t+1, 0) enters the band: pin its column-0 boundary
        bmask = lane_i == t + 1
        newS = jnp.where(bmask, col0, newS)
        newIh = jnp.where(bmask, NEG, newIh)
        j = t + 1 - m_rows
        live = (j >= 1) & (j <= n_actual)
        bval = jnp.where(live, jnp.max(jnp.where(msel, newS, NEG), axis=1), NEG)
        return (newS, S1, newIh, newC), (code, bval)

    def word_step(carry, w):
        acc = jnp.zeros((R, mp), jnp.int32)
        bvals = []
        for u in range(8):
            carry, (code, bval) = diag_step(carry, w * 8 + u)
            acc = acc | (code << (4 * u))
            bvals.append(bval)
        return carry, (acc, jnp.stack(bvals, axis=1))

    init = (jnp.where(row0, 0.0, NEG) + jnp.zeros((R, 1), jnp.float32)
            + 0.0 * signals[:, :1],
            jnp.full((R, mp), NEG) + 0.0 * signals[:, :1],
            jnp.full((R, mp), NEG) + 0.0 * signals[:, :1],
            jnp.full((R, mp), NEG) + 0.0 * signals[:, :1])
    _, (ptr, bsteps) = jax.lax.scan(word_step, init, jnp.arange(nd8, dtype=jnp.int32))
    bottom = jnp.transpose(bsteps, (1, 0, 2)).reshape(R, nd8 * 8)
    # leftmost best over columns, virtual column 0 (b0) first: argmax in
    # step space is argmax in column space (a monotonic shift per row)
    b0 = go_v + ge_v * (m_rows.astype(jnp.float32) - 1.0)
    best = jnp.concatenate([b0[:, None], bottom], axis=1)
    k = jnp.argmax(best, axis=1).astype(jnp.int32)
    score = jnp.take_along_axis(best, k[:, None], axis=1)[:, 0]
    j_end = jnp.where(k == 0, 0, k - m_rows).astype(jnp.int32)
    return ptr, score, j_end


@partial(jax.jit, static_argnames=("m_max",))
def traceback_diag(ptr, j_end, m_rows, m_max: int):
    """Vmapped :func:`traceback_pointers` over the rows of a diagonal plane."""
    return jax.vmap(lambda p, je, mr: traceback_pointers(p, je, m_max, packed="diag",
                                                         m_start=mr),
                    in_axes=(1, 0, 0))(ptr, j_end, m_rows)


def align_rows(signals, n_actual, tmpl_rows_np, m_rows_np, params: AlignParams,
               impl: str) -> dict:
    """Align R rows, each against its own template, on the diagonal layout.

    ``impl``: "cuda" (the CUDA forward and traceback kernels) or "diag"
    (:func:`align_diag` + the lax traceback).  Rows run in launches as
    wide as the pointer budget allows (:func:`platform.launch_rows`).
    Returns dict of (R, ...) arrays (score, j_end, is_gap, jpos, j_begin)
    with is_gap/jpos sized to the longest template.
    """
    R, N = signals.shape
    mp = tmpl_rows_np.shape[1]
    m_max = int(np.max(m_rows_np))
    width = platform.launch_rows(R, N, mp)
    outs = []
    for r0 in range(0, R, width):
        sl = slice(r0, min(r0 + width, R))
        tr = jnp.asarray(tmpl_rows_np[sl])
        mr = jnp.asarray(m_rows_np[sl])
        if impl == "cuda":
            from . import cuda

            outs.append(cuda.align_rows(signals[sl], n_actual[sl], tr, mr, params, m_max))
        else:
            ptr, score, j_end = align_diag(signals[sl], n_actual[sl], tr, mr, params)
            tb = traceback_diag(ptr, j_end, mr, m_max)
            outs.append({"score": score, "j_end": j_end, **tb})
    if len(outs) == 1:
        return outs[0]
    return {k: jnp.concatenate([o[k] for o in outs]) for k in outs[0]}


def align_fused_pair(signals, n_actual, t_pre, t_suf, params: AlignParams,
                     impl: str = "auto"):
    """Both flank alignments of a batch.

    On the diagonal layout ("cuda"/"diag") both flanks run as ONE stream
    of 2B rows with per-row templates ([read0 x prefix .. readB x prefix,
    read0 x suffix ..]), so a 64-read batch fills 128 thread blocks in
    one launch.  On the scan path ("xla") each flank is its own vmapped
    scan.  Returns (pre, suf) dicts shaped like :func:`align_core`'s.
    """
    if impl == "auto":
        impl = platform.align_impl()
    signals = jnp.asarray(signals, jnp.float32)
    n_actual = jnp.asarray(n_actual, jnp.int32)
    t_pre = np.asarray(t_pre, np.float32)
    t_suf = np.asarray(t_suf, np.float32)
    if impl == "xla":
        return (align_core(signals, n_actual, t_pre, params, impl),
                align_core(signals, n_actual, t_suf, params, impl))
    B = signals.shape[0]
    rows_np, ms = pad_template_rows([t_pre, t_suf])
    rows2 = np.repeat(rows_np, B, axis=0)
    ms2 = np.repeat(ms, B)
    out = align_rows(jnp.concatenate([signals, signals]),
                     jnp.concatenate([n_actual, n_actual]), rows2, ms2, params, impl)
    pre = {k: (v[:B, : len(t_pre)] if v.ndim == 2 else v[:B]) for k, v in out.items()}
    suf = {k: (v[B:, : len(t_suf)] if v.ndim == 2 else v[B:]) for k, v in out.items()}
    return pre, suf


def align_core(signals, n_actual, template_np: np.ndarray, params: AlignParams,
               impl: str = "auto"):
    """Batched alignment on local data — traceable inside jit/shard_map.

    signals: (B, N).  ``impl``: "auto" (:func:`platform.align_impl`),
    "xla" (vmapped :func:`align_scan`), "diag" or "cuda" (the diagonal
    layout, see :func:`align_rows`).  ``template_np`` must be a host
    numpy array (its length is static).  Returns dict of per-read arrays
    (score, j_end, is_gap, jpos, j_begin).
    """
    if impl == "auto":
        impl = platform.align_impl()
    template_np = np.asarray(template_np, np.float32)
    if impl in ("cuda", "diag"):
        B = signals.shape[0]
        rows_np, ms = pad_template_rows([template_np])
        return align_rows(jnp.asarray(signals, jnp.float32), jnp.asarray(n_actual, jnp.int32),
                          np.repeat(rows_np, B, axis=0), np.repeat(ms, B), params, impl)
    if impl != "xla":
        raise ValueError(f"unknown align impl {impl!r}")
    template = jnp.asarray(template_np, jnp.float32)
    inner = jax.vmap(lambda s, n: align_scan(s, n, template, params, True))
    return inner(signals, n_actual)


def align_batch(signals, n_actual, template, params: AlignParams, impl: str = "auto",
                mesh=None):
    """Batched alignment front-end.

    With ``mesh``, the batch is sharded over the mesh's ``data`` axis via
    ``shard_map`` (B padded to a multiple of the axis size; template
    replicated); each shard runs the same implementation the
    single-device path uses.
    Returns dict of per-read arrays (score, j_end, is_gap, jpos, j_begin).
    """
    signals = jnp.asarray(signals, jnp.float32)
    n_actual = jnp.asarray(n_actual, jnp.int32)
    template_np = np.asarray(template, np.float32)
    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        from ..parallel.mesh import shard_map

        B = signals.shape[0]
        dp = mesh.shape["data"]
        bpad = (-B) % dp
        if bpad:
            signals = jnp.pad(signals, ((0, bpad), (0, 0)))
            n_actual = jnp.pad(n_actual, (0, bpad), constant_values=1)
        fn = shard_map(
            lambda s, n: align_core(s, n, template_np, params, impl),
            mesh, in_specs=(P("data"), P("data")), out_specs=P("data"))
        out = fn(signals, n_actual)
        return {k: v[:B] for k, v in out.items()}
    return align_core(signals, n_actual, template_np, params, impl)


def _nearest_positions(is_gap: np.ndarray, jpos: np.ndarray, n: int) -> np.ndarray:
    """Per template element, the nearest signal index in alignment view space.

    Replicates ``argmin(|a_idx - b_idx[k]|)`` of the reference
    (scripts/STRique.py:540-547) without materializing view-position
    arrays: matched elements map exactly; elements inside a vertical gap
    run of length L at left-neighbor j map to j if (r+1) <= (L-r) for
    in-run offset r (first-index tie-breaking of argmin), else j+1.
    """
    m = len(jpos)
    pos = jpos.astype(np.int64).copy()
    g = np.asarray(is_gap, dtype=bool)
    if g.any():
        # a gap run starts where the predecessor is non-gap or maps to a
        # different left neighbor; offsets within each run decide the
        # argmin tie-break
        jp = jpos.astype(np.int64)
        start = g & ~(np.concatenate(([False], g[:-1]))
                      & (np.concatenate(([np.int64(-1)], jp[:-1])) == jp))
        run_id = np.cumsum(start) - 1  # valid where g
        starts_idx = np.flatnonzero(start)
        lengths = np.bincount(run_id[g])
        r = np.arange(m) - starts_idx[np.maximum(run_id, 0)]
        L = lengths[np.maximum(run_id, 0)]
        pos[g] = np.where((r + 1) <= (L - r), jp, jp + 1)[g]
    return np.clip(pos, 0, n - 1)


def detect_range(signal_padded, n_actual: int, template, params: AlignParams,
                 pre_trim: int = 0, post_trim: int = 0):
    """Device-aligned equivalent of reference ``__detect_range__`` (STRique.py:538-548).

    Returns (per-sample score, segment_begin, segment_end) in signal coords.
    """
    res = align_scan(jnp.asarray(signal_padded), jnp.int32(n_actual), jnp.asarray(template), params)
    is_gap = np.asarray(res["is_gap"])
    jpos = np.asarray(res["jpos"])
    pos = _nearest_positions(is_gap, jpos, int(n_actual))
    seg_begin = int(pos[0])
    seg_end = int(pos[-1])
    score = float(res["score"])
    if seg_end > seg_begin:
        score = score / (seg_end - seg_begin)
    else:
        score = 0.0
    return score, int(pos[pre_trim]), int(pos[len(pos) - 1 - post_trim])
