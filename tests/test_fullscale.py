"""Reference-scale synthetic count exactness.

The same assertions the reference's CI makes (scripts/STRique_test.py):
GGCCCC and GCG repeats at 100/200/300 units, short-flank reads at
10..90 units — every count must be exact.
"""
import numpy as np
import pytest

from strique_tpu.detect.counter import RepeatCounter
from strique_tpu.pore_model import PoreModel
from strique_tpu.synthetic import default_assets

MODEL = default_assets().model
ROWS = open(default_assets().repeat_config).read().strip().split("\n")
C9 = ROWS[1].split()
FM = ROWS[2].split()


@pytest.fixture(scope="module")
def env():
    pm = PoreModel(MODEL)
    rng = np.random.default_rng(42)
    backbone = "".join(rng.choice(list("ACTG"), 2000))
    return pm, backbone


def test_hexamer_100_300(env):
    pm, backbone = env
    dt = RepeatCounter(MODEL)
    dt.add_target("c9orf72", C9[4], C9[5], C9[6])
    sigs = []
    for i in (100, 200, 300):
        seq = backbone[:1000] + C9[5] + C9[4] * i + C9[6] + backbone[-1000:]
        sigs.append(pm.generate_signal(seq, samples=8))
    for i, sig in zip((100, 200, 300), sigs):
        n = dt.detect("c9orf72", sig, "+")[0]
        assert n == i


def test_trimer_interpolation_100_300(env):
    pm, backbone = env
    dt = RepeatCounter(MODEL)
    dt.add_target("fmr1", "GCG", FM[5], FM[6])
    for i in (100, 200, 300):
        seq = backbone[:1000] + FM[5] + "GCG" * i + FM[6] + backbone[-1000:]
        n = dt.detect("fmr1", pm.generate_signal(seq, samples=8), "+")[0]
        assert n == i


def test_short_flanks_10_90(env):
    pm, backbone = env
    dt = RepeatCounter(MODEL)
    dt.add_target("c9orf72", C9[4], C9[5], C9[6])
    sigs = [pm.generate_signal(C9[5] + C9[4] * i + C9[6], samples=8)
            for i in range(10, 100, 10)]
    # batched: all nine variable-length reads in one detect_many call
    results = dt.detect_many("c9orf72", sigs, "+")
    for i, res in zip(range(10, 100, 10), results):
        assert res[0] == i
