"""End-to-end pipeline tests: batched dispatcher, CLI count over synthetic
fast5 + SAM, plot output, config parsing, logger."""
import os

import h5py
import numpy as np
import pytest

from strique_tpu.pore_model import PoreModel
from strique_tpu.synthetic import default_assets

MODEL = default_assets().model
ROW = open(default_assets().repeat_config).read().strip().split("\n")[1].split()
REPEAT, PREFIX, SUFFIX = ROW[4], ROW[5], ROW[6]


def make_single_f5(path, read_id, signal):
    with h5py.File(path, "w") as f:
        g = f.create_group("Raw/Reads/Read_1")
        g.attrs["read_id"] = np.bytes_(read_id.encode())
        g.create_dataset("Signal", data=np.asarray(signal, np.int16))


@pytest.fixture(scope="module")
def synthetic_run(tmp_path_factory):
    """A tiny sequencing run: 3 reads with known repeat counts + SAM."""
    d = tmp_path_factory.mktemp("run")
    pm = PoreModel(MODEL)
    rng = np.random.default_rng(0)
    backbone = "".join(rng.choice(list("ACTG"), 1000))
    counts = {"read-a": 12, "read-b": 20, "read-c": 16}
    for rid, n in counts.items():
        seq = backbone[:500] + PREFIX + REPEAT * n + SUFFIX + backbone[-500:]
        sig = pm.generate_signal(seq, samples=8)
        # signals are in pA model space; store as int16 counts scaled up
        make_single_f5(d / f"{rid}.fast5", rid, (sig * 10).astype(np.int16))
    from strique_tpu.io import fast5

    fofn = d / "reads.fofn"
    fofn.write_text("\n".join(fast5.index(str(d))) + "\n")
    # repeat config for the c9orf72 locus; SAM rows spanning it
    repeat_tsv = d / "repeats.tsv"
    repeat_tsv.write_text(
        "chr\tbegin\tend\tname\trepeat\tprefix\tsuffix\n"
        f"chr9\t27573527\t27573544\tc9orf72\t{REPEAT}\t{PREFIX}\t{SUFFIX}\n")
    sam = d / "algn.sam"
    lines = ["@HD\tVN:1.6"]
    for rid in counts:
        lines.append(f"{rid}\t0\tchr9\t27541232\t60\t40000M\t*\t0\t0\t*\t*")
    sam.write_text("\n".join(lines) + "\n")
    return d, fofn, repeat_tsv, sam, counts


def test_count_cli_batched(synthetic_run):
    d, fofn, repeat_tsv, sam, counts = synthetic_run
    from strique_tpu.cli import main

    out = d / "counts.tsv"
    rc = main(["count", str(fofn), MODEL, str(repeat_tsv), "--algn", str(sam),
               "--out", str(out), "--batch", "4"])
    assert rc == 0
    rows = [l.split("\t") for l in out.read_text().strip().split("\n")[1:]]
    assert len(rows) == 3
    got = {r[0]: int(r[3]) for r in rows}
    assert got == counts


def test_detect_batch_matches_detect(synthetic_run):
    d, fofn, repeat_tsv, sam, counts = synthetic_run
    from strique_tpu.detect.detector import RepeatDetector
    from strique_tpu.utils.config import parse_config

    config = parse_config(str(repeat_tsv))
    rd = RepeatDetector(config["repeat"], MODEL, str(fofn))
    lines = [l for l in open(sam) if not l.startswith("@")]
    batched = rd.detect_batch(lines)
    for line, bres in zip(lines, batched):
        sres = rd.detect(line)
        assert (bres is None) == (sres is None)
        if bres:
            assert bres["target_counts"] == sres["target_counts"]


def test_plot_cli_writes_png(synthetic_run, tmp_path):
    d, fofn, repeat_tsv, sam, counts = synthetic_run
    from strique_tpu.cli import main

    counts_tsv = d / "counts.tsv"
    if not counts_tsv.exists():
        pytest.skip("count test must run first")
    out_dir = tmp_path / "plots"
    rc = main(["plot", str(fofn), "--counts", str(counts_tsv), "--output", str(out_dir)])
    assert rc == 0
    pngs = list(out_dir.glob("*.png"))
    assert len(pngs) == 3


def test_stream_scheduler_buckets(synthetic_run):
    """The bucket-stream scheduler must reproduce direct batched detection
    exactly across mixed strands, lengths (multiple jit buckets) and
    partial queues, with one callback per submitted read."""
    from strique_tpu.detect.counter import RepeatCounter, reverse_complement, signal_bucket
    from strique_tpu.detect.stream import StreamScheduler

    pm = PoreModel(MODEL)
    counter = RepeatCounter(MODEL)
    counter.add_target("c9", REPEAT, PREFIX, SUFFIX)
    rng = np.random.default_rng(8)
    reads = []
    for i in range(10):
        n = int(rng.integers(5, 25))
        bb = "".join(rng.choice(list("ACTG"), (i % 3 + 1) * 700))
        seq = bb[: len(bb) // 2] + PREFIX + REPEAT * n + SUFFIX + bb[len(bb) // 2 :]
        strand = "+" if i % 2 == 0 else "-"
        if strand == "-":
            seq = reverse_complement(seq)
        reads.append((strand, n, pm.generate_signal(seq, samples=8)))
    assert len({signal_bucket(len(s)) for _, _, s in reads}) > 1  # really multi-bucket

    res = {}
    sched = StreamScheduler(counter, lambda ctx, out: res.__setitem__(ctx, out),
                            batch_size=4)
    for i, (strand, _, sig) in enumerate(reads):
        sched.add(i, "c9", strand, sig)
    sched.close()
    assert sorted(res) == list(range(len(reads)))
    for i, (strand, n, sig) in enumerate(reads):
        direct = counter.detect("c9", sig, strand)
        assert res[i][0] == direct[0] == n
        assert res[i] == direct, f"read {i}: {res[i]} != {direct}"


def test_run_pipeline_fault_isolation(synthetic_run):
    """A bad SAM line must not kill the pipeline (reference :764-768)."""
    d, fofn, repeat_tsv, sam, counts = synthetic_run
    from strique_tpu.detect.detector import RepeatDetector
    from strique_tpu.parallel.dispatcher import run_pipeline
    from strique_tpu.utils.config import parse_config

    class SinkWriter:
        rows = []

        def write_line(self, target_counts=()):
            self.rows.extend(target_counts)

    config = parse_config(str(repeat_tsv))
    rd = RepeatDetector(config["repeat"], MODEL, str(fofn))
    lines = [l for l in open(sam) if not l.startswith("@")]
    lines.insert(1, "total garbage\n")
    lines.insert(2, "missing-read\t0\tchr9\t27541232\t60\t40000M\t*\t0\t0\t*\t*\n")
    w = SinkWriter()
    n = run_pipeline(iter(lines), rd, w, batch_size=2)
    assert n == 5
    assert len(w.rows) == 3


def test_parse_config_roundtrip(tmp_path):
    from strique_tpu.utils.config import parse_config

    cfg = parse_config(default_assets().repeat_config,
                       default_assets().params)
    assert set(cfg["repeat"]) == {"c9orf72", "fmr1"}
    assert cfg["align"]["samples"] == 6
    assert cfg["HMM"]["match_loop"] == 0.75
    chrom, begin, end, repeat, prefix, suffix = cfg["repeat"]["c9orf72"]
    assert chrom == "chr9" and repeat == "GGCCCC"
    bad = tmp_path / "bad.json"
    bad.write_text('{"align": 5}')
    with pytest.raises(SystemExit):
        parse_config(default_assets().repeat_config, str(bad))


def test_logger_levels(capsys, tmp_path):
    from strique_tpu.utils import logging as ulog

    logf = tmp_path / "log.txt"
    ulog.init(file=str(logf), log_level="warning")
    ulog.log("visible", ulog.LogLevel.Warning)
    ulog.log("hidden", ulog.LogLevel.Debug)
    ulog.close()
    text = logf.read_text()
    assert "visible" in text and "hidden" not in text
    assert "[WARNING]" in text


def test_logger_file_sink_failure_falls_back_to_stderr(capsys, tmp_path):
    """An unwritable log file must not silently drop messages: the line
    falls back to stderr (advisor round-4 low — the swallow-all except
    only concerns redirected stream sinks closing under us)."""
    from strique_tpu.utils import logging as ulog

    logf = tmp_path / "dir" / "log.txt"
    ulog.init(file=None, log_level="info")
    # inject a file sink whose parent does not exist -> open() OSErrors
    ulog._state["sinks"] = [str(logf)]
    ulog.log("must-not-vanish", ulog.LogLevel.Error)
    ulog.close()
    assert "must-not-vanish" in capsys.readouterr().err


def test_count_cli_resume(synthetic_run, tmp_path):
    """--resume appends and skips already-counted reads."""
    d, fofn, repeat_tsv, sam, counts = synthetic_run
    from strique_tpu.cli import main

    out = tmp_path / "counts.tsv"
    # first run: only read-a (truncate SAM)
    sam1 = tmp_path / "one.sam"
    lines = [l for l in open(sam)]
    sam1.write_text("".join(lines[:2]))
    assert main(["count", str(fofn), MODEL, str(repeat_tsv), "--algn", str(sam1),
                 "--out", str(out)]) == 0
    assert len(out.read_text().strip().split("\n")) == 2
    # resume with the full SAM: the counted read is skipped, others added
    assert main(["count", str(fofn), MODEL, str(repeat_tsv), "--algn", str(sam),
                 "--out", str(out), "--resume"]) == 0
    rows = out.read_text().strip().split("\n")
    assert len(rows) == 4  # header + 3 reads, no duplicates
    ids = [r.split("\t")[0] for r in rows[1:]]
    assert sorted(ids) == sorted(counts)


def test_masker_cli_end_to_end(synthetic_run, tmp_path):
    """Count -> mask: the masker extracts counted reads and deletes the
    [offset, offset+ticks) repeat span from each raw signal (reference
    scripts/fast5Masker.py:45-92)."""
    d, fofn, repeat_tsv, sam, counts = synthetic_run
    from strique_tpu.cli import main as cli_main
    from strique_tpu.io import fast5
    from strique_tpu.io.masker import main as masker_main

    out = tmp_path / "counts.tsv"
    assert cli_main(["count", str(fofn), MODEL, str(repeat_tsv),
                     "--algn", str(sam), "--out", str(out)]) == 0
    rows = [l.split("\t") for l in out.read_text().strip().split("\n")[1:]]
    spans = {r[0]: (int(r[7]), int(r[8])) for r in rows}
    assert all(t > 0 for _, t in spans.values())

    masked_dir = tmp_path / "masked"
    assert masker_main([str(fofn), str(out), str(masked_dir)]) == 0
    src = fast5.Fast5Index(str(fofn))
    dst = fast5.Fast5Index(str(masked_dir / "reads.fofn"))
    for rid, (offset, ticks) in spans.items():
        orig = src.get_raw(rid)
        masked = dst.get_raw(rid)
        assert len(masked) == len(orig) - ticks, rid
        # the repeat span is excised: prefix and suffix survive verbatim
        np.testing.assert_array_equal(masked[:offset], orig[:offset])
        np.testing.assert_array_equal(masked[offset:], orig[offset + ticks:])


def test_count_cli_mod_model(tmp_path):
    """CLI --mod_model end to end: canonical and mCpG-generated reads get
    exact counts and cleanly separated methylation patterns (reference
    STRique.py:605-609, count --mod_model flag :908).

    The reads come from seed 9: under the seeded mCpG model, the
    canonical counting HMM decodes some mCpG reads (seeds 7 and 8) one
    unit long, and the float64 oracle engine decodes the same count, so
    those draws test the pore model rather than the pipeline."""
    from strique_tpu.cli import main as cli_main
    from strique_tpu.io import fast5

    mod_model = default_assets().mod_model
    pm = PoreModel(MODEL)
    pm_mod = PoreModel(mod_model)
    rng = np.random.default_rng(9)
    backbone = "".join(rng.choice(list("ACTG"), 800))
    n_rep = 13
    seq = backbone[:400] + PREFIX + REPEAT * n_rep + SUFFIX + backbone[-400:]
    for rid, gen in (("mod-can", pm), ("mod-5mc", pm_mod)):
        sig = gen.generate_signal(seq, samples=8, noise=True, rng=rng)
        make_single_f5(tmp_path / f"{rid}.fast5", rid, (sig * 10).astype(np.int16))
    fofn = tmp_path / "reads.fofn"
    fofn.write_text("\n".join(fast5.index(str(tmp_path))) + "\n")
    repeat_tsv = tmp_path / "repeats.tsv"
    repeat_tsv.write_text(
        "chr\tbegin\tend\tname\trepeat\tprefix\tsuffix\n"
        f"chr9\t27573527\t27573544\tc9orf72\t{REPEAT}\t{PREFIX}\t{SUFFIX}\n")
    sam = tmp_path / "algn.sam"
    sam.write_text("@HD\tVN:1.6\n" + "".join(
        f"{rid}\t0\tchr9\t27541232\t60\t40000M\t*\t0\t0\t*\t*\n"
        for rid in ("mod-can", "mod-5mc")))
    out = tmp_path / "counts.tsv"
    assert cli_main(["count", str(fofn), MODEL, str(repeat_tsv),
                     "--algn", str(sam), "--out", str(out),
                     "--mod_model", mod_model]) == 0
    rows = [l.split("\t") for l in out.read_text().strip().split("\n")[1:]]
    got = {r[0]: (int(r[3]), r[9]) for r in rows}
    assert got["mod-can"][0] == n_rep and got["mod-5mc"][0] == n_rep
    rate = lambda p: p.count("1") / max(len(p), 1)
    assert rate(got["mod-can"][1]) < 0.3, got["mod-can"][1]
    assert rate(got["mod-5mc"][1]) > 0.7, got["mod-5mc"][1]


@pytest.fixture(scope="module")
def dual_locus_run(tmp_path_factory):
    """Two loci (c9orf72 + fmr1), reads on both strands."""
    from strique_tpu.detect.counter import reverse_complement
    from strique_tpu.io import fast5

    rows = open(default_assets().repeat_config).read().strip().split("\n")
    d = tmp_path_factory.mktemp("dual")
    pm = PoreModel(MODEL)
    rng = np.random.default_rng(1)
    backbone = "".join(rng.choice(list("ACTG"), 800))
    loci = {}
    for row in rows[1:]:
        c = row.split()
        loci[c[3]] = (c[0], int(c[1]), int(c[2]), c[4], c[5], c[6])
    expect = {}
    sam_lines = ["@HD\tVN:1.6"]
    for k, (name, n, strand) in enumerate([("c9orf72", 14, "+"), ("c9orf72", 18, "-"),
                                           ("fmr1", 25, "+"), ("fmr1", 30, "-")]):
        chrom, begin, end, repeat, prefix, suffix = loci[name]
        seq = backbone[:400] + prefix + repeat * n + suffix + backbone[-400:]
        if strand == "-":
            seq = reverse_complement(seq)
        rid = f"dual-{k}-{name}{strand}"
        sig = pm.generate_signal(seq, samples=8)
        make_single_f5(d / f"{rid}.fast5", rid, (sig * 10).astype(np.int16))
        expect[rid] = (name, strand, n)
        flag = 16 if strand == "-" else 0
        sam_lines.append(f"{rid}\t{flag}\t{chrom}\t{begin - 20000}\t60\t41000M\t*\t0\t0\t*\t*")
    fofn = d / "reads.fofn"
    fofn.write_text("\n".join(fast5.index(str(d))) + "\n")
    sam = d / "algn.sam"
    sam.write_text("\n".join(sam_lines) + "\n")
    return d, fofn, sam, expect


def test_multi_locus_both_strands(dual_locus_run):
    """Batched pipeline across two targets and both strands, with IO threads."""
    d, fofn, sam, expect = dual_locus_run
    from strique_tpu.cli import main

    out = d / "counts.tsv"
    rc = main(["count", str(fofn), MODEL,
               default_assets().repeat_config,
               "--algn", str(sam), "--out", str(out), "--batch", "3", "--t", "4"])
    assert rc == 0
    rows = [l.split("\t") for l in out.read_text().strip().split("\n")[1:]]
    got = {r[0]: (r[1], r[2], int(r[3])) for r in rows}
    assert got == expect


def test_per_read_threaded_path(dual_locus_run):
    """io_threads > 1 with batch_size 1 exercises the threaded worker pool."""
    d, fofn, sam, expect = dual_locus_run
    from strique_tpu.detect.detector import RepeatDetector
    from strique_tpu.parallel.dispatcher import run_pipeline
    from strique_tpu.utils.config import parse_config

    class SinkWriter:
        def __init__(self):
            self.rows = []

        def write_line(self, target_counts=()):
            self.rows.extend(target_counts)

    config = parse_config(default_assets().repeat_config)
    rd = RepeatDetector(config["repeat"], MODEL, str(fofn))
    lines = [l for l in open(sam) if not l.startswith("@")]
    w = SinkWriter()
    n = run_pipeline(iter(lines), rd, w, io_threads=3, batch_size=1)
    assert n == 4
    got = {r[0]: (r[1], r[2], r[3]) for r in w.rows}
    assert got == {rid: (t, s, n) for rid, (t, s, n) in expect.items()}


def test_count_cli_missing_files(tmp_path):
    from strique_tpu.cli import main

    assert main(["count", str(tmp_path / "nope.fofn"), MODEL,
                 default_assets().repeat_config]) == 1
    # bad model path
    fofn = tmp_path / "empty.fofn"
    fofn.write_text("")
    assert main(["count", str(fofn), str(tmp_path / "no.model"),
                 default_assets().repeat_config]) == 1


def test_index_recursive_and_prefix(tmp_path):
    from strique_tpu.io import fast5

    sub = tmp_path / "a" / "b"
    os.makedirs(sub)
    make_single_f5(sub / "r.fast5", "rec-read-1", np.arange(32, dtype=np.int16))
    flat = list(fast5.index(str(tmp_path)))
    assert flat == []  # non-recursive does not descend
    rec = list(fast5.index(str(tmp_path), recursive=True))
    assert rec == [f"a/b/r.fast5\trec-read-1"]
    pref = list(fast5.index(str(tmp_path), recursive=True, output_prefix="runX"))
    assert pref == [f"runX/a/b/r.fast5\trec-read-1"]


def test_plan_merged_batches():
    from strique_tpu.detect.stream import plan_merged_batches, _batch_cost

    # never worse than singleton flushes, covers every group exactly once
    cases = [
        [(12288, 7), (14336, 11), (20480, 10), (40960, 36), (98304, 19), (114688, 13)],
        [(2048, 1)],
        [(1024, 32), (1 << 20, 32)],   # merging can't help: keep separate
        [],
    ]
    for groups in cases:
        plan = plan_merged_batches(groups)
        covered = sorted(i for batch in plan for i in batch)
        assert covered == list(range(len(groups)))
        planned = sum(_batch_cost(max(groups[i][0] for i in b),
                                  sum(groups[i][1] for i in b)) for b in plan)
        single = sum(_batch_cost(b, n) for b, n in groups)
        assert planned <= single + 1e-9
    assert plan_merged_batches([(1024, 32), (1 << 20, 32)]) == [[0], [1]]


def test_stream_per_read_fault_isolation(synthetic_run):
    """One poisoned read in a batch must cost only itself: the scheduler
    retries the batch per read (reference STRique.py:764-768)."""
    from strique_tpu.detect.counter import RepeatCounter
    from strique_tpu.detect.stream import StreamScheduler

    pm = PoreModel(MODEL)
    counter = RepeatCounter(MODEL)
    counter.add_target("c9", REPEAT, PREFIX, SUFFIX)
    rng = np.random.default_rng(3)
    bb = "".join(rng.choice(list("ACTG"), 700))
    reads, expect = [], []
    for i in range(7):
        n = 10 + i
        seq = bb[:350] + PREFIX + REPEAT * n + SUFFIX + bb[-350:]
        reads.append(pm.generate_signal(seq, samples=8))
        expect.append(n)
    reads.insert(3, ["not-a-signal"])  # poisons np.asarray in submit
    expect.insert(3, None)

    res = {}
    sched = StreamScheduler(counter, lambda ctx, out: res.__setitem__(ctx, out),
                            batch_size=8)
    for i, sig in enumerate(reads):
        sched.add(i, "c9", "+", sig)
    sched.close()
    assert sorted(res) == list(range(8))
    assert res[3] is None
    for i, n in enumerate(expect):
        if n is not None:
            assert res[i] is not None and res[i][0] == n, (i, res[i])


def test_stream_finish_failure_retries_per_read(synthetic_run, monkeypatch):
    """A finish-time batch failure also falls back to per-read retry."""
    from strique_tpu.detect.counter import RepeatCounter
    from strique_tpu.detect.stream import StreamScheduler

    pm = PoreModel(MODEL)
    counter = RepeatCounter(MODEL)
    counter.add_target("c9", REPEAT, PREFIX, SUFFIX)
    rng = np.random.default_rng(4)
    bb = "".join(rng.choice(list("ACTG"), 700))
    reads = [pm.generate_signal(bb[:350] + PREFIX + REPEAT * (8 + i) + SUFFIX + bb[-350:],
                                samples=8) for i in range(4)]

    orig = RepeatCounter.detect_finish
    def flaky(self, state):
        if state["B"] > 1:
            raise RuntimeError("injected batch failure")
        return orig(self, state)
    monkeypatch.setattr(RepeatCounter, "detect_finish", flaky)

    res = {}
    sched = StreamScheduler(counter, lambda ctx, out: res.__setitem__(ctx, out),
                            batch_size=4)
    for i, sig in enumerate(reads):
        sched.add(i, "c9", "+", sig)
    sched.close()
    assert all(res[i] is not None and res[i][0] == 8 + i for i in range(4)), res


def test_warmup_cli(capsys):
    """`strique warmup` must pre-compile one full-path batch per
    target x strand x bucket and report cold vs hot cost per shape (the
    compile-cost answer the reference never needed — its engines have
    no compile step)."""
    from strique_tpu.cli import main

    rc = main(["warmup", MODEL,
               default_assets().repeat_config,
               "--config", default_assets().params,
               "--min_len", "4096", "--max_len", "4096", "--batch", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    rows = [l for l in out.splitlines() if "\tbucket=" in l]
    # 2 targets (c9orf72, fmr1) x 2 strands x 1 bucket
    assert len(rows) == 4, out
    assert all("cold=" in r and "hot=" in r for r in rows)
    assert "# warmed 4" in out
