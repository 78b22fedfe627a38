"""Split detection pipeline (morph-only upload + segment-only Viterbi).

The split path is the production default: phase 1 uploads the morph
channel at 1 byte/sample and computes segment bounds on device (40-byte
/read D2H), phase 2 ships only the host-sliced repeat segments for the
Viterbi.  These tests pin its parity against the fused path, the NumPy
no-native prep fallback, the three-stage stream scheduler, and the
methylation decode.
"""
import numpy as np
import pytest

import strique_tpu.native as native_lib
from strique_tpu.detect.counter import RepeatCounter, reverse_complement
from strique_tpu.detect.stream import StreamScheduler
from strique_tpu.pore_model import PoreModel
from strique_tpu.synthetic import default_assets

MODEL = default_assets().model
MOD_MODEL = default_assets().mod_model
ROW = open(default_assets().repeat_config).read().strip().split("\n")[1].split()
REPEAT, PREFIX, SUFFIX = ROW[4], ROW[5], ROW[6]


@pytest.fixture(scope="module")
def pm():
    return PoreModel(MODEL)


def _reads(pm, rng, nreps, bb_n=1500, strand="+"):
    out = []
    for nrep in nreps:
        bb = "".join(rng.choice(list("ACTG"), 2 * bb_n))
        seq = bb[:bb_n] + (PREFIX + REPEAT * nrep + SUFFIX if nrep else "") + bb[bb_n:]
        if strand == "-":
            seq = reverse_complement(seq)
        out.append(pm.generate_signal(seq, samples=8, noise=True, rng=rng))
    return out


def test_split_numpy_prep_matches_native(pm):
    """The no-native (pure NumPy) split prep must be bit-identical to the
    native single-pass prep end to end, log_p included."""
    if not native_lib.available():
        pytest.skip("native library unavailable; nothing to compare")
    rng = np.random.default_rng(3)
    reads = _reads(pm, rng, (20, 35, 0))
    rc = RepeatCounter(MODEL)
    rc.add_target("c9", REPEAT, PREFIX, SUFFIX)
    a = rc.detect_many("c9", reads, "+")

    import unittest.mock as um

    with um.patch.object(native_lib, "available", lambda: False):
        rc_np = RepeatCounter(MODEL)
        rc_np.add_target("c9", REPEAT, PREFIX, SUFFIX)
        b = rc_np.detect_many("c9", reads, "+")
    assert a == b


def test_detect_middle_is_idempotent(pm):
    rng = np.random.default_rng(4)
    reads = _reads(pm, rng, (15,))
    rc = RepeatCounter(MODEL)
    rc.add_target("c9", REPEAT, PREFIX, SUFFIX)
    state = rc.detect_submit("c9", reads, "+")
    state = rc.detect_middle(state)
    state2 = rc.detect_middle(state)  # no-op second call
    assert state2 is state
    res = rc.detect_finish(state)
    assert res[0][0] == 15


def test_scheduler_three_stage_per_read_retry(pm):
    """A read whose finish poisons the whole batch must cost only itself:
    the scheduler retries the batch per read (reference STRique.py:764-768)."""
    rng = np.random.default_rng(5)
    reads = _reads(pm, rng, (10, 20, 30, 40, 25, 35))
    rc = RepeatCounter(MODEL)
    rc.add_target("c9", REPEAT, PREFIX, SUFFIX)
    expected = [r[0] for r in rc.detect_many("c9", reads, "+")]

    calls = {"n": 0}
    orig = RepeatCounter.detect_middle

    def poisoned(self, state):
        if state.get("split") and "bounds" not in state and state["B"] > 1:
            calls["n"] += 1
            raise RuntimeError("injected batch fault")
        return orig(self, state)

    import unittest.mock as um

    res = {}
    with um.patch.object(RepeatCounter, "detect_middle", poisoned):
        sched = StreamScheduler(rc, lambda ctx, out: res.__setitem__(ctx, out),
                                batch_size=3)
        for i, r in enumerate(reads):
            sched.add(i, "c9", "+", r)
        sched.close()
    assert calls["n"] >= 1, "fault was never injected"
    assert sorted(res) == list(range(len(reads)))
    assert [res[i][0] for i in range(len(reads))] == expected


def test_split_mod_detection(pm):
    """Methylation calling under the split pipeline: canonical vs mCpG
    generated reads must separate with exact counts (reference
    STRique.py:605-609 mod flow).

    Separation is judged as bench.py's mod stream judges it, at a 0.5
    per-read rate.  Under the seeded mCpG model a noisy mCpG read calls
    55-80% of its units methylated (noise-free: 100%), so the 0.7 bar
    that the reference's r9.4 mCpG table cleared does not apply; the
    canonical read must still call fewer than 30%."""
    pm_mod = PoreModel(MOD_MODEL)
    rc = RepeatCounter(MODEL, mod_model_file=MOD_MODEL)
    rc.add_target("c9", REPEAT, PREFIX, SUFFIX)
    assert rc.split
    rng = np.random.default_rng(6)
    bb = "".join(rng.choice(list("ACTG"), 400))
    n_rep = 12
    seq = bb[:200] + PREFIX + REPEAT * n_rep + SUFFIX + bb[200:]
    sigs = [pm.generate_signal(seq, samples=8, noise=True, rng=rng),
            pm_mod.generate_signal(seq, samples=8, noise=True, rng=rng)]
    res = rc.detect_many("c9", sigs, "+")
    for r, kind in zip(res, ("canonical", "mod")):
        assert r[0] == n_rep, f"{kind}: count {r[0]} != {n_rep}"
        assert r[6] not in ("-", "")
    assert res[0][6].count("1") / len(res[0][6]) < 0.3
    assert res[1][6].count("1") / len(res[1][6]) > 0.5


def test_scheduler_mod_pipeline(pm):
    """The 4-stage scheduler (submit -> middle -> mod_submit -> finish)
    must produce identical results to direct detect_many with a mod
    model: the mod Viterbi dispatch moves into the overlapped pipeline
    (detect_mod_submit) instead of detect_finish's tail, and batches in
    flight must not cross-contaminate (reference STRique.py:605-609)."""
    pm_mod = PoreModel(MOD_MODEL)
    rc = RepeatCounter(MODEL, mod_model_file=MOD_MODEL)
    rc.add_target("c9", REPEAT, PREFIX, SUFFIX)
    rng = np.random.default_rng(11)
    bb = "".join(rng.choice(list("ACTG"), 400))
    reads = []
    for i in range(6):
        n_rep = (10, 14)[i % 2]
        seq = bb[:200] + PREFIX + REPEAT * n_rep + SUFFIX + bb[200:]
        gen = pm if i % 2 == 0 else pm_mod
        reads.append((n_rep, gen.generate_signal(seq, samples=8, noise=True, rng=rng)))
    direct = rc.detect_many("c9", [s for _, s in reads], "+")
    res = {}
    sched = StreamScheduler(rc, lambda ctx, out: res.__setitem__(ctx, out),
                            batch_size=2, depth=2)
    for i, (_, sig) in enumerate(reads):
        sched.add(i, "c9", "+", sig)
    sched.close()
    assert len(sched.modq) == 0 and len(sched.ready) == 0
    for i, (n_rep, _) in enumerate(reads):
        assert res[i] is not None
        assert res[i][0] == n_rep
        assert res[i][6] not in ("-", "")
        # batch size 2 puts each read in its own device batch pair; the
        # scheduler path must agree with the direct path field-for-field
        assert res[i] == direct[i]
