"""Log-space Viterbi decoding on the device.

Replaces pomegranate's Cython silent-state Viterbi (invoked at reference
scripts/STRique.py:434 and :493) with a max-plus scan over a dense
log-transition matrix produced by the HMM compiler
(:mod:`strique_tpu.hmm.graph` eliminates silent states at build time, so
the runtime recursion is a single fused broadcast-add + max per step).
Backpointers stream to device memory as int16; the path is recovered by
a reverse ``lax.scan`` of gathers on device.  When the HMM factors
(:mod:`strique_tpu.hmm.factor`), :func:`viterbi_scan_factored` runs the
O(S log S) factored step instead, and on a GPU its CUDA twin
(``ops.cuda.viterbi_factored_batch``) runs the whole batch in one kernel;
:func:`viterbi_batch` picks.

Emissions are computed on the fly per time step from per-state
(mu, sigma) / uniform constants — no (T, S) emission matrix is ever
materialized in device memory.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# plain numpy scalar: a module-level jnp constant would initialize the XLA
# backend at import time, breaking jax.distributed.initialize() ordering
NEG = np.float32(-1e30)
_LOG2PI = float(np.log(2.0 * np.pi))


def emission_logp(x, mu, sigma, is_uniform, log_uni):
    """Per-state emission log-prob of scalar/vector observation ``x``."""
    norm = -0.5 * _LOG2PI - jnp.log(sigma) - 0.5 * jnp.square((x - mu) / sigma)
    return jnp.where(is_uniform, log_uni, norm)


@partial(jax.jit, static_argnames=())
def viterbi_scan(obs, t_actual, log_start, log_trans, log_end, mu, sigma, is_uniform, log_uni):
    """Viterbi decode of ``obs`` (padded to static T) over S states.

    Args:
      obs: (T,) float32 observations; entries at t >= t_actual are padding.
      t_actual: scalar int32 true length (>= 1).
      log_start/log_end: (S,) float32. log_trans: (S, S) float32, row=source.
    Returns (logp, path): float32 Viterbi log-probability and (T,) int32
    state path (entries beyond t_actual repeat the final state).
    Ties break towards the lowest state index.
    """
    S = log_start.shape[0]
    obs = obs.astype(jnp.float32)
    iota = jnp.arange(S, dtype=jnp.int32)

    # Running rescaling: subtracting the per-step max keeps the score vector
    # near zero, so float32 retains full precision on the margins that decide
    # each argmax (unscaled scores reach ~-1e5 where the f32 ulp would exceed
    # typical transition-probability margins).  The subtracted mass
    # accumulates separately and only affects the reported logp, which
    # callers recompute in float64 from the path anyway.
    score0 = log_start + emission_logp(obs[0], mu, sigma, is_uniform, log_uni)
    shift0 = jnp.max(score0)
    score0 = score0 - shift0

    def step(carry, xt):
        score, acc = carry
        x, t = xt
        cand = score[:, None] + log_trans  # (u, v)
        best = jnp.max(cand, axis=0)
        bp = jnp.argmax(cand, axis=0).astype(jnp.int16)
        new = best + emission_logp(x, mu, sigma, is_uniform, log_uni)
        shift = jnp.max(new)
        live = t < t_actual
        score = jnp.where(live, new - shift, score)
        acc = jnp.where(live, acc + shift, acc)
        bp = jnp.where(live, bp, iota.astype(jnp.int16))
        return (score, acc), bp

    ts = jnp.arange(1, obs.shape[0], dtype=jnp.int32)
    (score, acc), bps = jax.lax.scan(step, (score0, shift0), (obs[1:], ts))
    final = score + log_end
    last = jnp.argmax(final).astype(jnp.int32)
    logp = final[last] + acc

    def back(state, bp_t):
        prev = bp_t[state].astype(jnp.int32)
        return prev, state

    first, rev_path = jax.lax.scan(back, last, bps, reverse=True)
    path = jnp.concatenate([first[None], rev_path])
    return logp, path


@partial(jax.jit, static_argnames=())
def viterbi_scan_batch(obs, t_actual, log_start, log_trans, log_end, mu, sigma,
                       is_uniform, log_uni):
    """Vmapped viterbi_scan over a (B, T) batch in one dispatch."""
    return jax.vmap(lambda o, t: viterbi_scan(
        o, t, log_start, log_trans, log_end, mu, sigma, is_uniform, log_uni))(obs, t_actual)


# ---------------------------------------------------------------------------
# structure-factored kernel (hmm/factor.py)
# ---------------------------------------------------------------------------

def stage_factored(F, sp: int | None = None):
    """FactoredHMM -> (static spec, weight arrays) for the jitted kernels.

    -inf weights are clipped to the finite NEG sentinel and vectors are
    zero-padded (with NEG) to ``sp`` lanes.  Returns
    ``(spec, weights)`` where ``spec`` is a hashable nested tuple of
    lane offsets — ``(diag_offs, ((entry_offs, exit_offs), ...))`` — and
    ``weights`` is the flat tuple of float32 arrays consumed in spec
    order: diag w's, then per chain its entry w's, ramp, exit w's.
    """
    sp = sp or F.n_states
    neg = float(NEG)

    def prep(w):
        out = np.full(sp, neg, np.float32)
        out[: F.n_states] = np.maximum(w, neg)
        return out

    weights = []
    diag_offs = []
    for o, w in F.diags:
        diag_offs.append(o)
        weights.append(prep(w))
    chain_spec = []
    for ch in F.chains:
        entry_offs = []
        for o, w in ch.entries:
            entry_offs.append(o)
            weights.append(prep(w))
        ramp = np.zeros(sp, np.float32)
        ramp[: F.n_states] = ch.ramp
        ramp[F.n_states :] = ch.ramp[-1] if len(ch.ramp) else 0.0
        weights.append(ramp)
        exit_offs = []
        for o, w in ch.exits:
            exit_offs.append(o)
            weights.append(prep(w))
        chain_spec.append((tuple(entry_offs), tuple(exit_offs)))
    spec = (tuple(diag_offs), tuple(chain_spec))
    return spec, tuple(weights)


def factored_transition(spec, weights, score):
    """One max-plus transition step against the factored structure.

    score: (..., SP) previous scores; returns (..., SP) pre-emission
    ``out[v] = max_u score[u] + log_trans[u, v]``.  Lane shifts are
    circular (jnp.roll): every finite weight has an in-range
    destination by construction, and wrapped lanes carry the NEG
    sentinel, so wrap-around never creates a winning candidate.
    Mirrors hmm.factor.apply_factored (the f64 oracle semantics).
    """
    diag_offs, chain_spec = spec
    it = iter(weights)
    out = jnp.full_like(score, NEG)
    for o in diag_offs:
        out = jnp.maximum(out, jnp.roll(score + next(it), o, axis=-1))
    for entry_offs, exit_offs in chain_spec:
        inj = jnp.full_like(score, NEG)
        for o in entry_offs:
            inj = jnp.maximum(inj, jnp.roll(score + next(it), o, axis=-1))
        ramp = next(it)
        h = jax.lax.cummax(inj - ramp, axis=inj.ndim - 1) + ramp
        for o in exit_offs:
            out = jnp.maximum(out, jnp.roll(h + next(it), o, axis=-1))
    return out


@partial(jax.jit, static_argnames=("spec",))
def viterbi_scan_factored(obs, t_actual, log_start, log_trans, log_end, mu, sigma,
                          is_uniform, log_uni, spec, *weights):
    """Viterbi decode with the factored forward recursion.

    Forward streams the rescaled score rows (T, S); the backward pass
    recomputes the winning predecessor per visited state from the dense
    matrix column (first max by state index), the rule NOTES.md calls
    "recompute backward".  The CUDA kernel computes exactly this.
    Outputs match :func:`viterbi_scan` up to float32 summation-order
    effects on chain-routed transitions (tests/test_factor_kernels.py).
    """
    S = log_start.shape[0]
    obs = obs.astype(jnp.float32)

    score0 = log_start + emission_logp(obs[0], mu, sigma, is_uniform, log_uni)
    shift0 = jnp.max(score0)
    score0 = score0 - shift0

    def step(carry, xt):
        score, acc = carry
        x, t = xt
        best = factored_transition(spec, weights, score)
        new = best + emission_logp(x, mu, sigma, is_uniform, log_uni)
        shift = jnp.max(new)
        live = t < t_actual
        score = jnp.where(live, new - shift, score)
        acc = jnp.where(live, acc + shift, acc)
        return (score, acc), score

    ts = jnp.arange(1, obs.shape[0], dtype=jnp.int32)
    (score, acc), rows = jax.lax.scan(step, (score0, shift0), (obs[1:], ts))
    rows = jnp.concatenate([score0[None], rows[:-1]])  # rows[t] = score at t-1
    final = score + log_end
    last = jnp.argmax(final).astype(jnp.int32)
    logp = final[last] + acc

    # walk t = T-1 .. 1; rows[t-1] holds the scores the forward maxed over
    def back(state, inp):
        sc_prev, t = inp
        out = state
        cand = sc_prev + log_trans[:, state]
        prev = jnp.argmax(cand).astype(jnp.int32)
        state = jnp.where(t < t_actual, prev, state)
        return state, out

    first, rev_path = jax.lax.scan(back, last, (rows, ts), reverse=True)
    path = jnp.concatenate([first[None], rev_path])
    return logp, path


def viterbi_scan_factored_batch(obs, t_actual, chm_dev, spec, weights):
    """Vmapped factored decode over a (B, T) batch in one dispatch.

    chm_dev: the dense device tensors tuple as passed to viterbi_scan
    (log_start, log_trans, log_end, mu, sigma, is_uniform, log_uni) —
    the dense matrix is still needed for the recompute-backward.
    """
    return jax.vmap(lambda o, t: viterbi_scan_factored(
        o, t, *chm_dev, spec, *weights))(obs, t_actual)


def viterbi_batch(obs, t_actual, chm_dev, factored):
    """Decode a (B, T) batch: (logp, path).

    ``factored``: ``(spec, weights)`` from :func:`stage_factored`, or None
    for HMMs that do not factor (they take the dense
    :func:`viterbi_scan_batch`).  Factored HMMs run the CUDA kernel on a
    GPU and :func:`viterbi_scan_factored_batch` elsewhere.
    """
    from .. import platform

    if factored is None:
        return viterbi_scan_batch(obs, t_actual, *chm_dev)
    spec, weights = factored
    if platform.viterbi_impl() == "cuda":
        from . import cuda

        return cuda.viterbi_factored_batch(obs, t_actual, chm_dev, spec, weights)
    return viterbi_scan_factored_batch(obs, t_actual, chm_dev, spec, weights)


def path_logp_f64(obs: np.ndarray, path: np.ndarray, chm) -> float:
    """Recompute the log-probability of a decoded path in float64 on host.

    Float64 throughout (vectorized over time), so reported log_p values
    track pomegranate's float64 accumulation to ~1e-10 relative.
    """
    obs = np.asarray(obs, dtype=np.float64)
    path = np.asarray(path)[: len(obs)]
    mu = chm.mu[path]
    sigma = chm.sigma[path]
    norm = -0.5 * np.log(2 * np.pi * sigma**2) - 0.5 * ((obs - mu) / sigma) ** 2
    emit = np.where(chm.is_uniform[path], chm.log_uni[path], norm)
    lp = chm.log_start[path[0]] + emit.sum() + chm.log_end[path[-1]]
    lp += chm.log_trans[path[:-1], path[1:]].sum()
    return float(lp)


# ---------------------------------------------------------------------------
# decode helpers
# ---------------------------------------------------------------------------

def count_repeats(path: np.ndarray, t_actual: int, chm) -> int:
    """Repeat count from a flanked-HMM path (reference STRique.py:374-378,433-441).

    count = visits of the d1/d2 dummy states - repeat_offset + flanking_count.
    """
    path = np.asarray(path)[:t_actual]
    visits = int(chm.meta["count_states"][path].sum())
    return visits - chm.meta["repeat_offset"] + chm.meta["flanking_count"]


def repeat_sample_mask(path: np.ndarray, t_actual: int, chm) -> np.ndarray:
    """Boolean mask of samples decoded into repeat states (reference :607-608)."""
    path = np.asarray(path)[:t_actual]
    return chm.meta["repeat_states"][path]


def mod_pattern(path: np.ndarray, t_actual: int, chm) -> str:
    """Methylation pattern string from a mod-HMM path (reference :492-500).

    Samples between s0/e0 anchors form one repeat unit; the unit's first
    state decides '1' (mod) vs '0' (canonical).
    """
    path = np.asarray(path)[:t_actual]
    anchor = chm.meta["anchor_states"][path]
    mod = chm.meta["mod_states"][path]
    # a unit starts at each non-anchor sample whose predecessor is an
    # anchor (or at t=0); its first state decides the call — vectorized
    # (per-sample Python iteration was an O(T)-per-read host hot spot on
    # 40k-sample repeat segments)
    in_unit = ~anchor
    starts = in_unit & ~np.concatenate(([False], in_unit[:-1]))
    bits = mod[starts].astype(np.uint8) + ord("0")
    return bits.tobytes().decode("ascii")
