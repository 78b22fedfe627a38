"""Randomized-parameter parity sweeps.

The config JSON admits arbitrary user gap/sigma values
(reference configs/STRique.json:2-31); the fixed three-variant parity
tests leave param-space corners uncovered — the diagonal sweep's
cummax-folding identity flips sign with g = max(ge_v, go_v), and
dist_min > 0 changes the score floor.  These seeded sweeps pin:

  * align: the column scan and the anti-diagonal sweep BIT-identical
    (scores, end columns, gap flags, warp positions) over sampled
    AlignParams corners;
  * align vs the float64 oracle: score/segment parity on single reads;
  * Viterbi: dense and factored scans vs the dense float64 oracle over
    perturbed HMM configs (sigma scale/offset, e1_ratio, leave_repeat).

Everything is seeded — any mismatch reproduces deterministically.
"""
import numpy as np
import pytest

from strique_tpu.ops.reference import AlignParams, semiglobal_align_np
from strique_tpu.synthetic import default_assets

# corner values for each axis; the sweep combines explicit corners with
# seeded random draws.  Positive gap "costs" (rewards) are legal inputs
# and must at least stay kernel-consistent.
_GAPS_H = (-16.0, -1.0, -0.25, 0.0, 0.5)
_GAPS_V = (-16.0, -4.0, -0.5, 0.0, 1.0)
_OFFSETS = (0.0, 4.0, 16.0, 32.0)
_DMINS = (0.0, 2.0, 8.0, -4.0)


def _sample_params(rng, n_random=12):
    """Deterministic corner set + seeded random draws (~26 configs)."""
    out = [
        AlignParams(),  # reference defaults
        AlignParams(dist_min=8.0),                      # dist_min > 0
        AlignParams(dist_min=8.0, dist_offset=0.0),     # floor always wins
        AlignParams(dist_min=-4.0),
        AlignParams(gap_open_v=-4.0, gap_extension_v=-16.0),   # g = go_v branch
        AlignParams(gap_open_h=-0.25, gap_extension_h=-16.0),  # bound from go_h
        AlignParams(gap_open_h=0.5, gap_extension_h=0.5),      # positive h gaps
        AlignParams(gap_open_v=1.0, gap_extension_v=0.0),      # positive v gaps
        AlignParams(gap_open_h=0.0, gap_extension_h=0.0),      # free h gaps
        AlignParams(gap_open_v=0.0, gap_extension_v=0.0),      # free v gaps
        AlignParams(dist_offset=32.0, gap_open_v=-32.0, gap_extension_v=-32.0),
        AlignParams(gap_open_h=-16.0, gap_extension_h=-16.0,
                    gap_open_v=-0.5, gap_extension_v=-0.5),    # steep h, shallow v
        AlignParams(dist_offset=0.0),
        AlignParams(gap_open_v=-16.0, gap_extension_v=-0.5),   # reopening never pays
    ]
    for _ in range(n_random):
        out.append(AlignParams(
            dist_offset=float(rng.choice(_OFFSETS)),
            dist_min=float(rng.choice(_DMINS)),
            gap_open_h=float(rng.choice(_GAPS_H)),
            gap_extension_h=float(rng.choice(_GAPS_H)),
            gap_open_v=float(rng.choice(_GAPS_V)),
            gap_extension_v=float(rng.choice(_GAPS_V)),
        ))
    # dedupe, keep order
    seen, uniq = set(), []
    for p in out:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def _fuzz_reads(rng, B, N, M):
    template = rng.uniform(60, 120, M).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B // 2):  # half the reads carry a planted noisy match
        st = int(rng.integers(0, N - 2 * M))
        signals[i, st : st + M] = template + rng.normal(0, 0.5, M).astype(np.float32)
    na = rng.integers(N // 2, N - 4, B).astype(np.int32)
    return signals, na, template


@pytest.mark.parametrize("chunk", range(3))
def test_align_param_fuzz_diag_bit_parity(chunk):
    """The column scan and the anti-diagonal sweep (the CUDA kernel's
    executable spec) must agree BITWISE for every sampled config: scores,
    end columns, gap flags, warp positions and begin columns."""
    from strique_tpu.ops.align import align_batch

    rng = np.random.default_rng(1005)
    params = _sample_params(rng)
    B, N, M = 8, 256, 20
    for k, p in enumerate(params):
        signals, na, template = _fuzz_reads(rng, B, N, M)
        if k % 3 != chunk:
            continue
        ref = align_batch(signals, na, template, p, impl="xla")
        got = align_batch(signals, na, template, p, impl="diag")
        for key in ("score", "j_end", "is_gap", "jpos", "j_begin"):
            np.testing.assert_array_equal(
                np.asarray(ref[key]), np.asarray(got[key]),
                err_msg=f"config {k} {p} field {key}")


def test_align_param_fuzz_vs_f64_oracle():
    """The f32 kernel stream vs the float64 SeqAn-semantics oracle:
    same end/begin columns and warp path, scores to f32 tolerance."""
    from strique_tpu.ops.align import align_batch

    rng = np.random.default_rng(1013)
    params = _sample_params(rng, n_random=8)
    B, N, M = 8, 192, 16
    for k, p in enumerate(params):
        signals, na, template = _fuzz_reads(rng, B, N, M)
        got = align_batch(signals, na, template, p, impl="xla")
        for i in range(B):
            n = int(na[i])
            s_o, a_idx, b_idx, j_begin_o, j_end_o = semiglobal_align_np(
                signals[i, :n].astype(np.float64), template.astype(np.float64), p,
                full=True)
            scale = max(abs(s_o), 1.0)
            assert abs(float(got["score"][i]) - s_o) / scale < 1e-4, (k, i, p)
            a_idx = a_idx.astype(np.int64)
            b_idx = b_idx.astype(np.int64)
            assert int(got["j_end"][i]) == j_end_o, (k, i, p)
            assert int(got["j_begin"][i]) == j_begin_o, (k, i, p)
            # per-template-element warp parity: the signal index each
            # consumed template element maps to
            is_gap = np.asarray(got["is_gap"][i][:M])
            jpos = np.asarray(got["jpos"][i][:M])
            a_pos = {int(c): int(j) for j, c in enumerate(a_idx)}
            for t in range(M):
                col = int(b_idx[t])
                if col in a_pos:  # diagonal: template element t on a signal sample
                    assert not is_gap[t], (k, i, t, p)
                    assert int(jpos[t]) == a_pos[col], (k, i, t, p)
                else:  # vertical gap element
                    assert is_gap[t], (k, i, t, p)


def test_viterbi_hmm_config_fuzz_vs_oracle():
    """Dense and factored Viterbi vs the dense float64 oracle over perturbed
    HMM configs (the user-tunable surface of configs/STRique.json HMM
    section): log-p to tolerance, d1/d2 visit counts exact."""
    import jax.numpy as jnp

    from strique_tpu.hmm.models import build_flanked_repeat
    from strique_tpu.ops.reference import viterbi_np
    from strique_tpu.ops.viterbi import (count_repeats, stage_factored, viterbi_scan,
                                         viterbi_scan_factored)
    from strique_tpu.pore_model import PoreModel

    pm = PoreModel(default_assets().model)
    row = open(default_assets().repeat_config).read().strip().split("\n")[1].split()
    repeat, prefix, suffix = row[4], row[5][-30:], row[6][:30]
    rng = np.random.default_rng(1021)
    configs = [
        {},
        {"seq_std_scale": 0.5, "rep_std_scale": 2.0},
        {"seq_std_offset": 1.0, "rep_std_offset": 2.0},
        {"e1_ratio": 0.5},
        {"e1_ratio": 0.0},
        {"leave_repeat": 0.1},
        {"leave_repeat": 1e-5},
        {"skip": 0.9},
        {"match_loop": 0.5, "match_match": 0.3, "match_insert": 0.15,
         "match_delete": 0.05},
    ]
    for _ in range(4):
        configs.append({
            "seq_std_scale": float(rng.uniform(0.3, 3.0)),
            "rep_std_scale": float(rng.uniform(0.3, 3.0)),
            "seq_std_offset": float(rng.uniform(0.0, 3.0)),
            "e1_ratio": float(rng.uniform(0.0, 1.0)),
            "leave_repeat": float(10 ** rng.uniform(-5, -0.7)),
        })
    n_units = 5
    for k, cfg in enumerate(configs):
        chm = build_flanked_repeat(repeat, prefix, suffix, pm, config=cfg)
        seq = prefix + repeat * n_units + suffix
        sig = pm.generate_signal(seq, samples=8, noise=True,
                                 rng=np.random.default_rng(40 + k)).astype(np.float32)
        T = len(sig)
        tpad = -(-T // 256) * 256
        obs = np.zeros(tpad, np.float32)
        obs[:T] = sig
        lp_o, path_o = viterbi_np(sig.astype(np.float64), chm.log_start, chm.log_trans,
                                  chm.log_end, chm.mu, chm.sigma, chm.is_uniform, chm.log_uni)
        dev = (jnp.asarray(chm.log_start, jnp.float32), jnp.asarray(chm.log_trans, jnp.float32),
               jnp.asarray(chm.log_end, jnp.float32), jnp.asarray(chm.mu, jnp.float32),
               jnp.asarray(chm.sigma, jnp.float32), jnp.asarray(chm.is_uniform),
               jnp.asarray(chm.log_uni, jnp.float32))
        lp_s, path_s = viterbi_scan(jnp.asarray(obs), jnp.int32(T), *dev)
        if chm.factored is not None:
            spec, weights = stage_factored(chm.factored)
            lp_p, path_p = viterbi_scan_factored(jnp.asarray(obs), jnp.int32(T), *dev, spec,
                                                 *map(jnp.asarray, weights))
        else:  # graphs that do not factor decode densely in production too
            lp_p, path_p = lp_s, path_s
        scale = max(abs(lp_o), 1.0)
        assert abs(float(lp_s) - lp_o) / scale < 1e-4, (k, cfg)
        assert abs(float(lp_p) - lp_o) / scale < 1e-4, (k, cfg)
        # d1/d2 visit counts (the detection output) must agree exactly
        n_o = count_repeats(path_o, T, chm)
        n_s = count_repeats(np.asarray(path_s), T, chm)
        n_p = count_repeats(np.asarray(path_p), T, chm)
        assert n_o == n_s == n_p, (k, cfg, n_o, n_s, n_p)
        # kernel paths must agree with each other bitwise
        np.testing.assert_array_equal(np.asarray(path_s)[:T], np.asarray(path_p)[:T],
                                      err_msg=f"config {k} {cfg}")
