"""The CUDA kernels (ops/cuda.py, native/strique_cuda.cu).

CPU tier: what surrounds the kernels — the factored-program encoding,
the build command, and that a failed build raises.  Card tier (``gpu``
marker, skips without an NVIDIA GPU): each kernel against its plain
``lax`` reference on the same card, at real template widths.
"""
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest

from strique_tpu.ops import cuda
from strique_tpu.ops.reference import AlignParams


def test_factored_program_layout():
    spec = ((-12, 0, 1), (((3, 4), (-2,)), ((5,), (6, 7))))
    prog = cuda.factored_program(spec)
    assert prog.dtype == np.int32
    assert list(prog) == [3, 2, 2, 1, 1, 2, -12, 0, 1, 3, 4, -2, 5, 6, 7]


def test_factored_program_rejects_oversized_specs():
    spec = (tuple(range(cuda.MAX_ROLLS + 1)), ())
    with pytest.raises(ValueError, match="taps"):
        cuda.factored_program(spec)


def test_factored_program_of_real_hmm(assets):
    from strique_tpu.hmm.models import build_flanked_repeat
    from strique_tpu.ops.viterbi import stage_factored
    from strique_tpu.pore_model import PoreModel

    row = assets.row()
    chm = build_flanked_repeat(row[4], row[5][-50:], row[6][:50], PoreModel(assets.model))
    spec, weights = stage_factored(chm.factored)
    prog = cuda.factored_program(spec)
    n_diag, n_chain = prog[0], prog[1]
    n_taps = n_diag + sum(prog[2 + 2 * c] + prog[3 + 2 * c] for c in range(n_chain))
    assert len(prog) == 2 + 2 * n_chain + n_taps
    assert len(weights) == n_taps + n_chain  # one ramp row per chain


def test_build_command_targets_hopper(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\nexit 0\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    cmd = cuda.build_command()
    assert cmd[0] == str(fake)
    assert "-gencode=arch=compute_90a,code=sm_90a" in cmd
    assert "--fmad=false" in cmd and cmd[-1] == cuda.SOURCE


def test_failed_build_raises(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda, "LIBRARY", str(tmp_path / "build" / "lib.so"))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        cuda.build(force=True)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda, "CUDA_ROOTS", ())
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.nvcc()


# ---------------------------------------------------------------------------
# card tier
# ---------------------------------------------------------------------------

def _flank_batch(assets, B, seed):
    from strique_tpu.detect.counter import RepeatCounter
    from strique_tpu.pore_model import PoreModel
    from strique_tpu.synthetic import locus_read

    pm = PoreModel(assets.model)
    rc = RepeatCounter(assets.model)
    row = assets.row()
    rc.add_target("c9orf72", *row[4:7])
    tc = rc.targets["c9orf72"][0]
    rng = np.random.default_rng(seed)
    sigs = []
    for i in range(B):
        bb = "".join(rng.choice(list("ACGT"), 400))
        sigs.append(locus_read(pm, row, 10 + 3 * i, bb, rng=rng, noise=True).astype(np.float32))
    N = -(-max(len(s) for s in sigs) // 128) * 128
    sig = np.zeros((B, N), np.float32)
    for i, s in enumerate(sigs):
        sig[i, : len(s)] = s
    na = np.array([len(s) for s in sigs], np.int32)
    na[-1] = 5  # a degenerate row
    return sig, na, tc.prefix_ext, tc.suffix_ext


@pytest.mark.gpu
def test_wave_kernel_matches_scan_on_card(gpu, assets):
    from strique_tpu.ops import align as A

    sig, na, t_pre, t_suf = _flank_batch(assets, 12, 3)
    p = AlignParams()
    pre, suf = A.align_fused_pair(jnp.asarray(sig), jnp.asarray(na), t_pre, t_suf, p,
                                  impl="cuda")
    for got, t in ((pre, t_pre), (suf, t_suf)):
        ref = A.align_core(jnp.asarray(sig), jnp.asarray(na), t, p, impl="xla")
        for k in ("j_end", "jpos", "is_gap", "j_begin"):
            np.testing.assert_array_equal(np.asarray(ref[k]), np.asarray(got[k]), err_msg=k)
        # same expression trees, no FMA contraction on either side; pow and
        # abs are IEEE-rounded libdevice calls in both
        np.testing.assert_allclose(np.asarray(ref["score"]), np.asarray(got["score"]),
                                   rtol=1e-6, atol=1e-3)


@pytest.mark.gpu
def test_traceback_kernel_matches_lax_walk_on_card(gpu, assets):
    from strique_tpu.ops import align as A

    sig, na, t_pre, t_suf = _flank_batch(assets, 8, 5)
    rows, ms = A.pad_template_rows([t_pre, t_suf])
    rows2 = jnp.asarray(np.repeat(rows, 8, axis=0))
    ms2 = jnp.asarray(np.repeat(ms, 8))
    sig2 = jnp.asarray(np.concatenate([sig, sig]))
    na2 = jnp.asarray(np.concatenate([na, na]))
    ptr, score, j_end = cuda.wave_forward(sig2, na2, rows2, ms2, AlignParams())
    m_max = int(ms.max())
    got = cuda.traceback(ptr, j_end, ms2, m_max)
    ref = A.traceback_diag(ptr, j_end, ms2, m_max)
    for k in ("is_gap", "jpos", "j_begin"):
        np.testing.assert_array_equal(np.asarray(ref[k]), np.asarray(got[k]), err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["flanked", "mod"])
def test_viterbi_kernel_matches_factored_scan_on_card(gpu, assets, kind):
    from strique_tpu.hmm.models import build_flanked_repeat, build_repeat_mod
    from strique_tpu.ops import viterbi as V
    from strique_tpu.pore_model import PoreModel

    pm, pmm = PoreModel(assets.model), PoreModel(assets.mod_model)
    row = assets.row()
    rep, pre, suf = row[4], row[5][-50:], row[6][:50]
    rng = np.random.default_rng(9)
    if kind == "flanked":
        chm = build_flanked_repeat(rep, pre, suf, pm)
        sigs = [pm.generate_signal(pre + rep * n + suf, samples=6, noise=True, rng=rng)
                for n in (4, 9, 30, 17)]
    else:
        chm = build_repeat_mod(rep, pm, pmm)
        sigs = [g.generate_signal(rep * 12, samples=6, noise=True, rng=rng)
                for g in (pm, pmm, pm, pmm)]
    T = max(len(s) for s in sigs) + 37
    obs = np.zeros((len(sigs), T), np.float32)
    for i, s in enumerate(sigs):
        obs[i, : len(s)] = s
    lens = np.array([len(s) for s in sigs], np.int32)
    dev = tuple(jnp.asarray(x) for x in (
        chm.log_start.astype(np.float32), chm.log_trans.astype(np.float32),
        chm.log_end.astype(np.float32), chm.mu.astype(np.float32),
        chm.sigma.astype(np.float32), chm.is_uniform, chm.log_uni.astype(np.float32)))
    spec, weights = V.stage_factored(chm.factored)
    weights = tuple(map(jnp.asarray, weights))
    lp_r, path_r = V.viterbi_scan_factored_batch(jnp.asarray(obs), jnp.asarray(lens), dev,
                                                 spec, weights)
    lp_k, path_k = cuda.viterbi_factored_batch(jnp.asarray(obs), jnp.asarray(lens), dev,
                                               spec, weights)
    np.testing.assert_array_equal(np.asarray(path_r), np.asarray(path_k))
    np.testing.assert_allclose(np.asarray(lp_r), np.asarray(lp_k), rtol=1e-6)


@pytest.mark.gpu
def test_counter_counts_exact_on_card(gpu, assets):
    from strique_tpu.detect.counter import RepeatCounter
    from strique_tpu.pore_model import PoreModel
    from strique_tpu.synthetic import locus_read

    pm = PoreModel(assets.model)
    rc = RepeatCounter(assets.model)
    row = assets.row()
    rc.add_target("c9orf72", *row[4:7])
    rng = np.random.default_rng(13)
    units = [12, 40, 75, 100, 20, 60, 33, 90]
    bb = "".join(rng.choice(list("ACGT"), 1600))
    sigs = [locus_read(pm, row, n, bb, rng=rng, noise=True) for n in units]
    assert [r[0] for r in rc.detect_many("c9orf72", sigs, "+")] == units
    if os.environ.get("STRIQUE_TEST_DEVICE") == "gpu":
        assert cuda.load()["path"] == cuda.LIBRARY
