"""EXPERIMENTAL: state-sharded (tensor-parallel) Viterbi.

Not part of the product surface.  Every HMM this framework builds
(profile/repeat/flanked/mod over 50 bp flanks, reference
scripts/STRique.py:201-500) has a few hundred states: the factored
Viterbi (ops/viterbi.py and its CUDA kernel) holds the whole state row in
one thread block, and the production scaling axis is data parallelism
over reads (parallel/mesh.py).  This module is kept only as a capability
sketch for hypothetical state spaces beyond one device; its costs — a
per-step ``all_gather`` of the full score row and dense (T, S_local)
int16 backpointers — are exactly what the production kernels avoid, and
no supported workload justifies them.  See NOTES.md ("sharded_viterbi
resolution").
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.viterbi import emission_logp
from .mesh import Mesh, shard_map, P


def _tp_viterbi_shard(obs, t_actual, log_start_l, log_trans_l, log_end_l,
                      mu_l, sigma_l, is_uniform_l, log_uni_l, axis: str):
    """Per-shard body: owns S_local state columns of the transition matrix.

    Carry is the FULL (replicated) score vector; each step computes the
    max-plus update for the local columns and all-gathers the pieces.
    """
    T = obs.shape[0]
    s_local = log_trans_l.shape[1]
    iota_l = jnp.arange(s_local, dtype=jnp.int32)

    def emit_l(x):
        return emission_logp(x, mu_l, sigma_l, is_uniform_l, log_uni_l)

    score_l0 = log_start_l + emit_l(obs[0])
    score0 = jax.lax.all_gather(score_l0, axis, tiled=True)  # (S,)
    shift0 = jnp.max(score0)
    score0 = score0 - shift0

    def step(carry, xt):
        score, acc = carry  # score: full (S,), small magnitude
        x, t = xt
        cand = score[:, None] + log_trans_l  # (S, S_local)
        best_l = jnp.max(cand, axis=0)
        bp_l = jnp.argmax(cand, axis=0).astype(jnp.int16)
        new_l = best_l + emit_l(x)
        new = jax.lax.all_gather(new_l, axis, tiled=True)  # (S,) — ICI collective
        shift = jnp.max(new)
        live = t < t_actual
        score = jnp.where(live, new - shift, score)
        acc = jnp.where(live, acc + shift, acc)
        my_base = jax.lax.axis_index(axis) * s_local
        bp_l = jnp.where(live, bp_l, (iota_l + my_base).astype(jnp.int16))
        return (score, acc), bp_l

    ts = jnp.arange(1, T, dtype=jnp.int32)
    (score, acc), bps_l = jax.lax.scan(step, (score0, shift0), (obs[1:], ts))
    # final: local candidates, reduce across shards
    final_l = score[jax.lax.axis_index(axis) * s_local + iota_l] + log_end_l
    best_val_l = jnp.max(final_l)
    best_idx_l = jax.lax.axis_index(axis) * s_local + jnp.argmax(final_l).astype(jnp.int32)
    vals = jax.lax.all_gather(best_val_l, axis)  # (n_shards,)
    idxs = jax.lax.all_gather(best_idx_l, axis)
    k = jnp.argmax(vals)
    logp = vals[k] + acc
    last = idxs[k]
    return logp[None], last[None], bps_l  # bp shard (T-1, S_local)


def sharded_viterbi(mesh: Mesh, obs, t_actual, log_start, log_trans, log_end,
                    mu, sigma, is_uniform, log_uni, data_axis: str = "data",
                    model_axis: str = "model"):
    """Viterbi over a 2-D (reads x states) mesh.

    obs: (B, T) observations sharded over ``data``; the (S, S) transition
    matrix is sharded column-wise over ``model`` and its rows replicated.
    Returns (logp (B,), path (B, T)).
    """
    def one_read(o, t, ls, lt, le, m, s, u, lu):
        return _tp_viterbi_shard(o, t, ls, lt, le, m, s, u, lu, model_axis)

    def shard_fn(obs_b, t_b, ls, lt, le, m, s, u, lu):
        f = jax.vmap(lambda o, t: one_read(o, t, ls, lt, le, m, s, u, lu))
        return f(obs_b, t_b)

    fn = shard_map(
        shard_fn, mesh,
        in_specs=(P(data_axis), P(data_axis), P(model_axis), P(None, model_axis),
                  P(model_axis), P(model_axis), P(model_axis), P(model_axis), P(model_axis)),
        out_specs=(P(data_axis), P(data_axis), P(data_axis, None, model_axis)),
        check=False,
    )
    logp, last, bps = fn(obs, t_actual, log_start, log_trans, log_end,
                         mu, sigma, is_uniform, log_uni)
    logp = logp[:, 0]
    last = last[:, 0]

    # traceback on the reassembled full backpointers (per read)
    def back_one(last_i, bps_i):
        def back(state, bp_t):
            prev = bp_t[state].astype(jnp.int32)
            return prev, state

        first, rev = jax.lax.scan(back, last_i, bps_i, reverse=True)
        return jnp.concatenate([first[None], rev])

    path = jax.vmap(back_one)(last, bps)
    return logp, path
