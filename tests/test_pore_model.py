"""Pore model parity tests vs the reference formulas (scripts/STRique.py:113-195)."""
import numpy as np
import pytest

from strique_tpu.pore_model import PoreModel, mean_abs_dev
from strique_tpu.synthetic import default_assets

MODEL = default_assets().model
MOD_MODEL = default_assets().mod_model


@pytest.fixture(scope="module")
def pm():
    return PoreModel(MODEL)


def test_model_stats(pm):
    means = np.array([v[0] for v in pm.model_dict.values()])
    stdvs = np.array([v[1] for v in pm.model_dict.values()])
    assert pm.kmer == 6
    assert len(pm.model_dict) == 4096
    assert pm.model_median == np.median(means)
    assert np.isclose(pm.model_MAD, np.mean(np.abs(means - np.median(means))))
    i, j = np.argmin(means), np.argmax(means)
    assert np.isclose(pm.model_min, means[i] - 6 * stdvs[i])
    assert np.isclose(pm.model_max, means[j] + 6 * stdvs[j])


def test_normalize_median(pm):
    rng = np.random.default_rng(0)
    sig = rng.uniform(300, 700, 5000)
    out = pm.normalize2model(sig, mode="median")
    # reference formula (STRique.py:173-179)
    med, mad = np.median(sig), np.mean(np.abs(sig - np.median(sig)))
    exp = (sig - med) / mad * pm.model_MAD + pm.model_median
    exp = np.clip(exp, pm.model_min + 0.5, pm.model_max - 0.5)
    np.testing.assert_allclose(out, exp, rtol=1e-12)


def test_normalize_minmax(pm):
    rng = np.random.default_rng(1)
    sig = rng.normal(500, 60, 8000)
    out = pm.normalize2model(sig, mode="minmax")
    # reference formula (STRique.py:152-160,178-179)
    model_values = np.array([v[0] for v in pm.model_dict.values()])
    q5s, q95s = np.percentile(sig, [1, 99])
    q5m, q95m = np.percentile(model_values, [1, 99])
    m5s, m95s = np.median(sig[sig < q5s]), np.median(sig[sig > q95s])
    m5m, m95m = np.median(model_values[model_values < q5m]), np.median(model_values[model_values > q95m])
    exp = (sig - (m5s + (m95s - m5s) / 2)) / ((m95s - m5s) / 2)
    exp = exp * ((m95m - m5m) / 2) + (m5m + (m95m - m5m) / 2)
    exp = np.clip(exp, pm.model_min + 0.5, pm.model_max - 0.5)
    np.testing.assert_allclose(out, exp, rtol=1e-9)


def test_scale2stdv(pm):
    pm_mod = PoreModel(MOD_MODEL)
    s = pm_mod.scale2stdv(pm)
    exp = np.median([v[1] for v in pm.model_dict.values()]) / np.median(
        [v[1] for v in pm_mod.model_dict.values()])
    assert np.isclose(s, exp)


def test_generate_signal(pm):
    sig = pm.generate_signal("ACGTACGTACGT", samples=4)
    assert len(sig) == (12 - 6 + 1) * 4
    means, _ = pm.kmer_levels("ACGTACGTACGT")
    np.testing.assert_array_equal(sig, np.repeat(means, 4))


def test_mad(pm):
    x = np.array([1.0, 2.0, 10.0])
    assert mean_abs_dev(x) == np.mean(np.abs(x - 2.0))


def test_normalize_entropy_mode(pm):
    """Entropy mode: change-point-masked median/MAD normalization
    (reference STRique.py:161-172)."""
    rng = np.random.default_rng(4)
    # two-level signal with change points
    sig = np.concatenate([rng.normal(400, 5, 3000), rng.normal(600, 5, 3000)])
    out = pm.normalize2model(sig, mode="entropy")
    assert out.shape == sig.shape
    assert np.all(out >= pm.model_min + 0.5 - 1e-9)
    assert np.all(out <= pm.model_max - 0.5 + 1e-9)
    # normalized signal must land in model space
    assert pm.model_min < np.median(out) < pm.model_max
