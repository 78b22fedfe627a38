"""Native C++ host runtime parity vs the NumPy/JAX implementations."""
import numpy as np
import pytest

from strique_tpu import native
from strique_tpu.ops.reference import AlignParams, detect_range_np
from strique_tpu.pore_model import PoreModel, mean_abs_dev
from strique_tpu.synthetic import default_assets

pytestmark = pytest.mark.skipif(not native.available(), reason="native lib not built")

MODEL = default_assets().model


def test_native_preprocess_matches_numpy():
    from strique_tpu.ops import signal as sig_ops
    from strique_tpu.ops.prep import model_const

    pm = PoreModel(MODEL)
    rng = np.random.default_rng(0)
    raw = rng.integers(400, 800, 5000).astype(np.int16)
    morph_n, flt_n = native.preprocess_read(raw, model_const(pm))
    rawd = raw.astype(np.float64)
    flt = sig_ops.medfilt3(rawd)
    q = sig_ops.quantize_morph_np(flt, float(np.median(flt)), mean_abs_dev(flt))
    morph = sig_ops.open_close_np(q)
    np.testing.assert_allclose(morph_n, pm.normalize2model(morph, mode="minmax"), rtol=1e-12)
    np.testing.assert_allclose(flt_n, pm.normalize2model(flt, mode="minmax"), rtol=1e-12)


def test_native_align_matches_oracle():
    rng = np.random.default_rng(1)
    p = AlignParams()
    for trial in range(5):
        n, m = int(rng.integers(100, 300)), int(rng.integers(10, 40))
        a = rng.uniform(60, 120, n)
        b = rng.uniform(60, 120, m)
        score, pos, gap = native.align_semiglobal(a, b, p)
        # oracle detect_range gives begin/end from the same pos semantics
        s_o, b_o, e_o = detect_range_np(a, b, p, pre_trim=2, post_trim=3)
        span = int(pos[-1]) - int(pos[0])
        s_n = score / span if span > 0 else 0.0
        assert np.isclose(s_n, s_o, atol=1e-3), f"trial {trial}"
        assert int(pos[2]) == b_o and int(pos[m - 1 - 3]) == e_o, f"trial {trial}"


def test_native_align_finds_planted():
    rng = np.random.default_rng(2)
    p = AlignParams()
    a = rng.uniform(60, 120, 400)
    b = a[100:160] + rng.normal(0, 0.4, 60)
    score, pos, gap = native.align_semiglobal(a, b, p)
    assert abs(int(pos[0]) - 100) <= 1
    assert abs(int(pos[-1]) - 159) <= 1
