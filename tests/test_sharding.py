"""Multi-device sharding tests on the virtual 8-CPU mesh.

Data-parallel alignment and 2-D (reads x states) sharded Viterbi must
reproduce the single-device kernels exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from strique_tpu.ops.align import align_scan
from strique_tpu.ops.reference import AlignParams
from strique_tpu.ops.viterbi import viterbi_scan
from strique_tpu.parallel.experimental import sharded_viterbi
from strique_tpu.parallel.mesh import batched_align, make_mesh
from strique_tpu.synthetic import default_assets

@pytest.fixture(autouse=True)
def eight_devices():
    """These cases shard over 8 devices (the CPU tier's virtual mesh)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")


def test_mesh_construction():
    mesh = make_mesh()
    assert mesh.shape["data"] == len(jax.devices())
    mesh2 = make_mesh({"data": 4, "model": 2})
    assert mesh2.shape == {"data": 4, "model": 2}


def test_batched_align_matches_single():
    rng = np.random.default_rng(0)
    B, N, M = 8, 256, 24
    params = AlignParams()
    template = rng.uniform(60, 120, M).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    n_actual = rng.integers(150, 250, B).astype(np.int32)
    mesh = make_mesh({"data": 8})
    out = batched_align(mesh, jnp.asarray(signals), jnp.asarray(n_actual),
                        jnp.asarray(template), params)
    for i in range(B):
        ref = align_scan(jnp.asarray(signals[i]), jnp.int32(n_actual[i]),
                         jnp.asarray(template), params)
        assert np.isclose(float(out["score"][i]), float(ref["score"]), atol=1e-4)
        assert int(out["j_end"][i]) == int(ref["j_end"])
        np.testing.assert_array_equal(np.asarray(out["jpos"][i]), np.asarray(ref["jpos"]))


def test_sharded_viterbi_matches_single():
    from tests.test_viterbi import random_hmm

    rng = np.random.default_rng(1)
    B, T, S = 4, 48, 16  # S divisible by model axis
    hmm = random_hmm(rng, S)
    obs = rng.uniform(60, 120, (B, T)).astype(np.float32)
    t_actual = np.array([48, 40, 33, 48], dtype=np.int32)
    dev = [jnp.asarray(x, jnp.float32) if x.dtype != bool else jnp.asarray(x) for x in hmm]
    mesh = make_mesh({"data": 4, "model": 2})
    logp, path = sharded_viterbi(mesh, jnp.asarray(obs), jnp.asarray(t_actual), *dev)
    for i in range(B):
        lp_ref, p_ref = viterbi_scan(jnp.asarray(obs[i]), jnp.int32(t_actual[i]), *dev)
        assert np.isclose(float(logp[i]), float(lp_ref), rtol=1e-5), f"read {i}"
        np.testing.assert_array_equal(
            np.asarray(path[i])[: t_actual[i]], np.asarray(p_ref)[: t_actual[i]], err_msg=f"read {i}")


def test_counter_with_mesh_matches_single_device():
    """detect_many over a data-sharded mesh reproduces single-device results."""
    import numpy as np

    from strique_tpu.detect.counter import RepeatCounter
    from strique_tpu.pore_model import PoreModel

    MODEL = default_assets().model
    row = open(default_assets().repeat_config).read().strip().split("\n")[1].split()
    repeat, prefix, suffix = row[4], row[5], row[6]
    pm = PoreModel(MODEL)
    rng = np.random.default_rng(3)
    backbone = "".join(rng.choice(list("ACTG"), 800))
    sigs = []
    expected = []
    for i in (11, 17, 23, 29):
        seq = backbone[:400] + prefix + repeat * i + suffix + backbone[-400:]
        sigs.append(pm.generate_signal(seq, samples=8))
        expected.append(i)
    single = RepeatCounter(MODEL)
    single.add_target("c9", repeat, prefix, suffix)
    res_single = single.detect_many("c9", sigs, "+")
    meshed = RepeatCounter(MODEL, mesh=make_mesh({"data": 4}, jax.devices()[:4]))
    meshed.add_target("c9", repeat, prefix, suffix)
    res_mesh = meshed.detect_many("c9", sigs, "+")
    for e, rs, rm in zip(expected, res_single, res_mesh):
        assert rs[0] == e and rm[0] == e
        assert rs[4:6] == rm[4:6]  # offset/ticks identical
        assert abs(rs[1] - rm[1]) < 1e-3 and abs(rs[2] - rm[2]) < 1e-3
