"""End-to-end synthetic count-exactness tests.

Mirrors the reference test strategy (scripts/STRique_test.py:45-124):
synthetic signals from the pore model with a known number of inserted
repeat units must be counted exactly.  Counts are reduced vs the
reference's 100..300 to keep CI fast; the same code paths are exercised.
"""
import numpy as np
import pytest

from strique_tpu.detect.counter import RepeatCounter
from strique_tpu.pore_model import PoreModel
from strique_tpu.synthetic import default_assets

MODEL = default_assets().model
MOD_MODEL = default_assets().mod_model

PREFIX_C9 = ("CGGCAGCCGAACCCCAAACAGCCACCCGCCAGGATGCCGCCTCCTCACTCACCCACTCGCCACCGCCTGCGCC"
             "TCCGCCGCCGCGGGCGCAGGCACCGCAACCGCAGCCCCGCCCCGGGCCCGCCCCCGGGCCCGCCCCGACCACGCCCC")
SUFFIX_C9 = ("TAGCGCGCGACTCCTGAGTTCCAGAGCTTGCTACAGGCTGCGGTTGTTTCCCTCCTTGTTTTCTTCTGGTTAA"
             "TCTTTATCAGGTCTTTTCTTGTTCACCCTCAGCGAGTACTGTGAGAGCAAGTAGTGGGGAGAGAGGGTGGGAAAAAC")
PREFIX_FMR1 = ("AGCGGGCCGGGGGTTCGGCCTCAGTCAGGCGCTCAGCTCCGTTTCGGTTTCACTTCCGGTGGAGGGCCGCC"
               "TCTGAGCGGGCGGCGGGCCGACGGCGAGCGCGGGCGGCGGCGGTGACGGAGGCGCCGCTGCCAGGGGGCGTGCGGCAGC")
SUFFIX_FMR1 = ("GAGGCGGCGGCGGCGGCGGCGGCGGCGGCGGCTGGGCCTCGAGCGCCCGCAGCCCACCTCTCGGGGGCGGG"
               "CTCCCGGCGCTAGCAGGGCTGAAGAGAAGATGGAGGAGCTGGTGGTGGAAGTGCGGGGCTCCAATGGCGCTTTCTACAA")


@pytest.fixture(scope="module")
def pm():
    return PoreModel(MODEL)


@pytest.fixture(scope="module")
def backbone():
    rng = np.random.default_rng(1234)
    return "".join(rng.choice(list("ACTG"), 2000))


def _run(counter, pm, seq, target, strand="+", samples=8, noise=False, gen_pm=None, rng=None):
    sig = (gen_pm or pm).generate_signal(seq, samples=samples, noise=noise, rng=rng)
    return counter.detect(target, sig, strand)


def test_detection_hexamer(pm, backbone):
    """GGCCCC repeat counted exactly (reference STRique_test.py:47-63)."""
    dt = RepeatCounter(MODEL)
    dt.add_target("c9orf72", "GGCCCC", PREFIX_C9, SUFFIX_C9)
    for i in (25, 40):
        seq = backbone[:1000] + PREFIX_C9 + "GGCCCC" * i + SUFFIX_C9 + backbone[-1000:]
        n, sp, ss, p, off, ticks, mod = _run(dt, pm, seq, "c9orf72")
        assert n == i
        assert sp > 4.0 and ss > 4.0
        assert mod == "-"


def test_interpolation_short_repeat(pm, backbone):
    """3-mer repeat (shorter than the 6-mer model) exercises the
    wrap-around extension / repeat_offset path (reference :67-83)."""
    dt = RepeatCounter(MODEL)
    dt.add_target("fmr1", "GCG", PREFIX_FMR1, SUFFIX_FMR1)
    for i in (30, 45):
        seq = backbone[:1000] + PREFIX_FMR1 + "GCG" * i + SUFFIX_FMR1 + backbone[-1000:]
        n, *_ = _run(dt, pm, seq, "fmr1")
        assert n == i


def test_normalization_short_flanks(pm):
    """No backbone, flanks only (reference :86-101)."""
    dt = RepeatCounter(MODEL)
    dt.add_target("c9orf72", "GGCCCC", PREFIX_C9, SUFFIX_C9)
    for i in (10, 30):
        seq = PREFIX_C9 + "GGCCCC" * i + SUFFIX_C9
        n, *_ = _run(dt, pm, seq, "c9orf72")
        assert n == i


def test_minus_strand(pm, backbone):
    """Reverse-complement reads counted through the minus-strand models."""
    from strique_tpu.detect.counter import reverse_complement

    dt = RepeatCounter(MODEL)
    dt.add_target("c9orf72", "GGCCCC", PREFIX_C9, SUFFIX_C9)
    i = 25
    seq = backbone[:500] + PREFIX_C9 + "GGCCCC" * i + SUFFIX_C9 + backbone[-500:]
    n, *_ = _run(dt, pm, reverse_complement(seq), "c9orf72", strand="-")
    assert n == i


def test_modification(pm, backbone):
    """Noisy canonical vs 5mC signals; count exact, pattern plausible
    (reference :104-124)."""
    pm_mod = PoreModel(MOD_MODEL)
    dt = RepeatCounter(MODEL, mod_model_file=MOD_MODEL)
    dt.add_target("c9orf72", "GGCCCC", PREFIX_C9, SUFFIX_C9)
    rng = np.random.default_rng(7)
    i = 25
    seq = backbone[:1000] + PREFIX_C9 + "GGCCCC" * i + SUFFIX_C9 + backbone[-1000:]
    n, sp, ss, p, off, ticks, mod_base = _run(dt, pm, seq, "c9orf72", noise=True, rng=rng)
    assert n == i
    assert set(mod_base) <= {"0", "1"}
    n2, *_rest, mod_mod = _run(dt, pm, seq, "c9orf72", noise=True, gen_pm=pm_mod, rng=rng)
    assert n2 == i
    # the mCpG-generated signal should trigger more 'mod' unit calls
    assert mod_mod.count("1") >= mod_base.count("1")


def test_pomegranate_compat_mode(pm, backbone):
    """Opt-in pomegranate-compat bake artifact: +ln(10) per dummy visit.

    The flag must (a) shift exactly the dummy emissions by ln(10) and
    nothing else, and (b) keep clean-signal synthetic counts exact (the
    reference passes its own synthetic suite with the baked model, so a
    correct compat model must too).  See PARITY.md.
    """
    from strique_tpu.hmm.models import build_flanked_repeat

    lit = build_flanked_repeat("GGCCCC", PREFIX_C9[-50:], SUFFIX_C9[:50], pm)
    cmp_ = build_flanked_repeat("GGCCCC", PREFIX_C9[-50:], SUFFIX_C9[:50], pm,
                                {"pomegranate_compat": True})
    d = cmp_.log_uni - lit.log_uni
    assert np.allclose(d[cmp_.meta["count_states"]], np.log(10.0))
    assert np.all(d[~cmp_.meta["count_states"]] == 0.0)
    np.testing.assert_array_equal(lit.log_trans, cmp_.log_trans)

    dt = RepeatCounter(MODEL, hmm_config={"pomegranate_compat": True})
    dt.add_target("c9orf72", "GGCCCC", PREFIX_C9, SUFFIX_C9)
    for i in (25, 40):
        seq = backbone[:1000] + PREFIX_C9 + "GGCCCC" * i + SUFFIX_C9 + backbone[-1000:]
        n, sp, ss, p, off, ticks, mod = _run(dt, pm, seq, "c9orf72")
        assert n == i


def test_ragged_bench_miss_is_model_inherent():
    """Regression pin for the single ragged-bench miscount (read 166).

    tools/adjudicate_ragged.py adjudicated it against the independent
    float64 oracle engine (full-matrix f64 DP + dense f64 Viterbi): the
    oracle decodes count=151 for the inserted-150 read — the miss is the
    true Viterbi optimum of that noisy signal, not a kernel defect.
    This pins the adjudicated kernel result so drift is caught.
    """
    import os

    from strique_tpu.detect.counter import RepeatCounter

    ref_model = os.path.join(os.environ.get("STRIQUE_REFERENCE_DIR", ""), "models",
                             "r9_4_450bps.model")
    if not os.path.isfile(ref_model):
        pytest.skip("the pinned signal was generated from the reference's r9.4 pore model "
                    "(models/r9_4_450bps.model; set STRIQUE_REFERENCE_DIR)")
    fix = np.load(os.path.join(os.path.dirname(__file__), "data",
                               "ragged_miss_166.npz"))
    counter = RepeatCounter(ref_model)
    counter.add_target("c9orf72", "GGCCCC", PREFIX_C9, SUFFIX_C9)
    n, sp, ss, *_ = counter.detect("c9orf72", fix["signal"].astype(np.float64),
                                   str(fix["strand"]))
    assert int(fix["inserted"]) == 150
    assert n == 151  # adjudicated optimum (oracle-identical), not 150
    assert sp > 4.0 and ss > 4.0


def test_multi_target_prep_shared_once(monkeypatch):
    """A read intersecting two targets preps ONCE: the shared prep token
    caches the morph/LUT/flt buffers, the second target's batch memcpys
    them, and results are identical to unshared submission (the
    reference re-preps per target, scripts/STRique.py:702-704)."""
    import numpy as np

    from strique_tpu import native as native_lib
    from strique_tpu.detect.counter import RepeatCounter
    from strique_tpu.detect.stream import StreamScheduler
    from strique_tpu.pore_model import PoreModel

    row = open(default_assets().repeat_config).read().strip().split("\n")[1].split()
    repeat, prefix, suffix = row[4], row[5], row[6]
    pm = PoreModel(MODEL)
    rng = np.random.default_rng(55)
    bb = "".join(rng.choice(list("ACTG"), 1200))
    seq = bb[:600] + prefix + repeat * 11 + suffix + bb[-600:]
    raw = pm.generate_signal(seq, samples=8)

    counter = RepeatCounter(MODEL)
    counter.add_target("locusA", repeat, prefix, suffix)
    counter.add_target("locusB", repeat, prefix, suffix)

    calls = {"native": 0, "numpy": 0}
    if native_lib.available():
        orig = native_lib.preprocess_read_lut

        def counting(*a, **k):
            calls["native"] += 1
            return orig(*a, **k)

        monkeypatch.setattr(native_lib, "preprocess_read_lut", counting)
    else:
        from strique_tpu.ops import signal as signal_ops

        orig = signal_ops.medfilt3

        def counting(*a, **k):
            calls["numpy"] += 1
            return orig(*a, **k)

        monkeypatch.setattr(
            __import__("strique_tpu.detect.counter", fromlist=["signal_ops"]).signal_ops,
            "medfilt3", counting)

    # unshared baseline
    base = {}
    sched = StreamScheduler(counter, lambda c, o: base.__setitem__(c, o), batch_size=4)
    sched.add("A", "locusA", "+", raw)
    sched.add("B", "locusB", "+", raw)
    sched.close()
    n_unshared = calls["native"] + calls["numpy"]
    assert n_unshared == 2  # re-prepped per target without a token

    calls["native"] = calls["numpy"] = 0
    shared = {}
    sched = StreamScheduler(counter, lambda c, o: shared.__setitem__(c, o), batch_size=4)
    token = {}
    sched.add("A", "locusA", "+", raw, prep_token=token)
    sched.add("B", "locusB", "+", raw, prep_token=token)
    sched.close()
    assert calls["native"] + calls["numpy"] == 1  # prepped once, reused once
    assert "prep" in token
    # identical results through the shared path
    assert shared["A"] == base["A"]
    assert shared["B"] == base["B"]
    assert shared["A"][0] == 11
