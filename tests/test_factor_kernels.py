"""Factored Viterbi kernels vs the dense kernels.

The factored forward recursion (ops.viterbi.factored_transition) changes
float32 summation order on chain-routed transitions, so path agreement
is validated empirically: repeat COUNTS must be exact on synthetic
signals with known truth (the same oracle the reference's own tests use,
reference scripts/STRique_test.py:47-63), and log-probabilities must
match to float32 accumulation noise.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from strique_tpu.hmm.models import build_flanked_repeat
from strique_tpu.ops import viterbi as V
from strique_tpu.pore_model import PoreModel
from strique_tpu.synthetic import default_assets

MODEL = default_assets().model
PREFIX = "CGGCAGCCGAACCCCAAACAGCCACCCGCCAGGATGCCGCCTCCTCACTCACC"
SUFFIX = "TAGCGCGACTCCTGAGTTCCAGAGCTTGCTACAGGCTGCGGTTGTTTCCCACC"


@pytest.fixture(scope="module")
def pm():
    return PoreModel(MODEL)


@pytest.fixture(scope="module")
def chm(pm):
    c = build_flanked_repeat("GGCCCC", PREFIX, SUFFIX, pm)
    assert c.factored is not None
    return c


def _dev(chm):
    return (jnp.asarray(chm.log_start, jnp.float32),
            jnp.asarray(np.maximum(chm.log_trans, V.NEG), jnp.float32),
            jnp.asarray(chm.log_end, jnp.float32),
            jnp.asarray(chm.mu, jnp.float32),
            jnp.asarray(chm.sigma, jnp.float32),
            jnp.asarray(chm.is_uniform),
            jnp.asarray(chm.log_uni, jnp.float32))


def _signals(pm, chm, counts, samples=6):
    sigs, lens = [], []
    for n in counts:
        seq = PREFIX + "GGCCCC" * n + SUFFIX
        sig = pm.generate_signal(seq, samples=samples)
        sigs.append(sig)
        lens.append(len(sig))
    T = max(lens)
    obs = np.zeros((len(sigs), T), np.float32)
    for i, s in enumerate(sigs):
        obs[i, : len(s)] = s
    return obs, np.array(lens, np.int32)


def test_factored_transition_matches_dense_rows(chm):
    """One factored step == dense broadcast-add-max, on-device f32."""
    spec, weights = V.stage_factored(chm.factored)
    rng = np.random.default_rng(3)
    S = chm.n_states
    score = jnp.asarray(rng.normal(size=(8, S)) * 5.0, jnp.float32)
    got = np.asarray(V.factored_transition(spec, tuple(map(jnp.asarray, weights)), score))
    trans = jnp.asarray(np.maximum(chm.log_trans, V.NEG), jnp.float32)
    want = np.asarray(jnp.max(score[:, :, None] + trans[None], axis=1))
    live = want > 0.5 * V.NEG
    # identical set of reachable cells; values equal to f32 reassociation noise
    assert np.array_equal(got > 0.5 * V.NEG, live)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-4)


def test_factored_scan_counts_exact(pm, chm):
    counts = [5, 11, 23]
    obs, lens = _signals(pm, chm, counts)
    dev = _dev(chm)
    spec, weights = V.stage_factored(chm.factored)
    weights = tuple(map(jnp.asarray, weights))
    _, paths_d = V.viterbi_scan_batch(jnp.asarray(obs), jnp.asarray(lens), *dev)
    logp_f, paths_f = V.viterbi_scan_factored_batch(
        jnp.asarray(obs), jnp.asarray(lens), dev, spec, weights)
    paths_d, paths_f = np.asarray(paths_d), np.asarray(paths_f)
    for i, n in enumerate(counts):
        cd = V.count_repeats(paths_d[i], int(lens[i]), chm)
        cf = V.count_repeats(paths_f[i], int(lens[i]), chm)
        assert cd == n, f"dense kernel count {cd} != truth {n}"
        assert cf == cd, f"count drift on read {i}: dense {cd} vs factored {cf}"
        # logp must agree with the f64 recompute of the factored path
        lp64 = V.path_logp_f64(obs[i, : lens[i]], paths_f[i], chm)
        assert np.isclose(float(logp_f[i]), lp64, rtol=1e-3)
        agree = (paths_d[i, : lens[i]] == paths_f[i, : lens[i]]).mean()
        assert agree > 0.99, f"path agreement {agree:.4f} on read {i}"


def test_factored_scan_noisy_counts(pm, chm):
    """Noisy signals: both kernels must still produce identical counts."""
    rng = np.random.default_rng(11)
    seq = PREFIX + "GGCCCC" * 9 + SUFFIX
    sigs = [pm.generate_signal(seq, samples=6, noise=True, rng=rng) for _ in range(4)]
    T = max(len(s) for s in sigs)
    obs = np.zeros((len(sigs), T), np.float32)
    for i, s in enumerate(sigs):
        obs[i, : len(s)] = s
    lens = np.array([len(s) for s in sigs], np.int32)
    dev = _dev(chm)
    spec, weights = V.stage_factored(chm.factored)
    weights = tuple(map(jnp.asarray, weights))
    _, paths_d = V.viterbi_scan_batch(jnp.asarray(obs), jnp.asarray(lens), *dev)
    _, paths_f = V.viterbi_scan_factored_batch(
        jnp.asarray(obs), jnp.asarray(lens), dev, spec, weights)
    for i in range(len(sigs)):
        cd = V.count_repeats(np.asarray(paths_d[i]), int(lens[i]), chm)
        cf = V.count_repeats(np.asarray(paths_f[i]), int(lens[i]), chm)
        assert cd == cf


@pytest.mark.parametrize("kind", ["flanked", "mod"])
def test_factored_scan_matches_dense_and_f64_oracle(pm, chm, kind):
    """viterbi_scan_factored vs viterbi_scan vs the float64 viterbi_np: the
    recompute-backward path is an optimum (its f64 log-p equals the
    oracle's) and decodes the oracle's count / mod pattern."""
    from strique_tpu.hmm.models import build_repeat_mod
    from strique_tpu.ops.reference import viterbi_np

    rng = np.random.default_rng(21)
    if kind == "flanked":
        model = chm
        sigs = [pm.generate_signal(PREFIX + "GGCCCC" * n + SUFFIX, samples=6, noise=True,
                                   rng=rng) for n in (4, 13)]
    else:
        pmm = PoreModel(default_assets().mod_model)
        model = build_repeat_mod("GGCCCC", pm, pmm)
        sigs = [g.generate_signal("GGCCCC" * 8, samples=6, noise=True, rng=rng)
                for g in (pm, pmm)]
    assert model.factored is not None
    T = max(len(s) for s in sigs) + 19  # padding must not leak into the paths
    obs = np.zeros((len(sigs), T), np.float32)
    for i, s in enumerate(sigs):
        obs[i, : len(s)] = s
    lens = np.array([len(s) for s in sigs], np.int32)
    dev = _dev(model)
    spec, weights = V.stage_factored(model.factored)
    _, paths_f = V.viterbi_scan_factored_batch(jnp.asarray(obs), jnp.asarray(lens), dev,
                                               spec, tuple(map(jnp.asarray, weights)))
    _, paths_d = V.viterbi_scan_batch(jnp.asarray(obs), jnp.asarray(lens), *dev)
    decode = V.count_repeats if kind == "flanked" else V.mod_pattern
    for i in range(len(sigs)):
        t = int(lens[i])
        pf, pd = np.asarray(paths_f[i]), np.asarray(paths_d[i])
        lp_o, path_o = viterbi_np(obs[i, :t].astype(np.float64), model.log_start,
                                  model.log_trans, model.log_end, model.mu, model.sigma,
                                  model.is_uniform, model.log_uni)
        assert decode(pf, t, model) == decode(pd, t, model) == decode(path_o, t, model)
        assert abs(V.path_logp_f64(obs[i, :t], pf, model) - lp_o) <= 1e-6 * abs(lp_o)
        assert np.all(pf[t:] == pf[t - 1])
