"""Structure factorization of compiled HMMs (hmm/factor.py).

The factorizer must reproduce the dense silent-eliminated transition
matrix exactly (f64 round-off) for every model family the pipeline
builds, and must decline gracefully on shapes outside the supported
structure so kernels can fall back to the dense path.
"""
import numpy as np
import pytest

from strique_tpu.hmm.factor import FactoredHMM, apply_factored, factorize
from strique_tpu.hmm.graph import HmmGraph
from strique_tpu.hmm.models import build_flanked_repeat, build_repeat_mod
from strique_tpu.pore_model import PoreModel
from strique_tpu.synthetic import default_assets

MODEL = default_assets().model
MODEL_MOD = default_assets().mod_model
PREFIX = "CGGCAGCCGAACCCCAAACAGCCACCCGCCAGGATGCCGCCTCCTCACTCACC"
SUFFIX = "TAGCGCGACTCCTGAGTTCCAGAGCTTGCTACAGGCTGCGGTTGTTTCCCACC"


@pytest.fixture(scope="module")
def pm():
    return PoreModel(MODEL)


def _check_equiv(chm):
    F = chm.factored
    assert isinstance(F, FactoredHMM)
    S = chm.n_states
    basis = np.full((S, S), -np.inf)
    np.fill_diagonal(basis, 0.0)
    recon = apply_factored(F, basis)
    fin = np.isfinite(chm.log_trans)
    assert np.array_equal(np.isfinite(recon), fin)
    np.testing.assert_allclose(recon[fin], chm.log_trans[fin], rtol=1e-9, atol=1e-9)
    return F


def test_flanked_repeat_factors(pm):
    chm = build_flanked_repeat("GGCCCC", PREFIX, SUFFIX, pm)
    F = _check_equiv(chm)
    # the O(S^2) triangular closure mass must ride the chain flows, not
    # explode into per-pair diagonals
    assert F.stats["n_chains"] == 2
    assert F.n_rolls <= 20
    assert F.stats["chain_covered"] > 0.8 * F.stats["dense_finite"]


def test_short_repeat_factors(pm):
    # repeat shorter than the k-mer exercises the interpolation/extension path
    chm = build_flanked_repeat("CGG", PREFIX[:16], SUFFIX[:16], pm)
    _check_equiv(chm)


def test_mod_hmm_factors(pm):
    chm = build_repeat_mod("GGCCCC", pm, PoreModel(MODEL_MOD))
    F = _check_equiv(chm)
    assert F.stats["n_chains"] == 0  # no_silent profiles: diagonals only


def test_random_step_equivalence(pm):
    """Factored one-step propagation == dense broadcast-add-max on random rows."""
    chm = build_flanked_repeat("GGCCCC", PREFIX, SUFFIX, pm)
    rng = np.random.default_rng(7)
    S = chm.n_states
    score = rng.normal(size=(16, S)) * 10.0
    got = apply_factored(chm.factored, score)
    want = (score[:, :, None] + chm.log_trans[None, :, :]).max(axis=1)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9, atol=1e-9)


def test_declines_on_chain_to_chain():
    """Two delete chains linked through a free silent must fall back to dense."""
    g = HmmGraph()
    ems = [g.add_normal(f"m{i:02d}", float(i), 1.0) for i in range(12)]
    c1 = [g.add_silent(f"a{i:02d}d") for i in range(5)]
    c2 = [g.add_silent(f"b{i:02d}d") for i in range(5)]
    mid1 = g.add_silent("mid1")
    mid2 = g.add_silent("mid2")  # two free hops so neither chain absorbs them
    for i in range(4):
        g.add_edge(c1[i], c1[i + 1], 0.5)
        g.add_edge(c2[i], c2[i + 1], 0.5)
    for i in range(5):
        g.add_edge(ems[i], c1[i], 0.1)
        g.add_edge(c1[i], ems[i + 1], 0.4)
        g.add_edge(ems[6 + i // 2], c2[i], 0.1)
        g.add_edge(c2[i], ems[5 + i // 2], 0.4)
    g.add_edge(c1[4], mid1, 0.1)
    g.add_edge(mid1, mid2, 1.0)
    g.add_edge(mid2, c2[0], 1.0)
    for e in ems:
        g.add_edge(e, e, 0.5)
    g.add_edge(g.start, ems[0], 1.0)
    g.add_edge(ems[-1], g.end, 0.1)
    chm = g.compile()
    assert chm.factored is None  # declined, dense fallback still correct
    assert np.isfinite(chm.log_trans).any()
