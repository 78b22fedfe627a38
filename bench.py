"""End-to-end throughput benchmark: synthetic c9orf72 reads/sec on the GPU.

Workload: full detection path (host preprocessing + flank alignment DP +
HMM Viterbi + decode) on synthetic noisy reads of ~23k samples with 100
repeat units — the same per-read work the reference pipeline does
(reference scripts/STRique.py:581-616) at a typical read scale — plus a
ragged stream (50/100/150 units, 500-6000 bp backbones, both strands,
partial batches) and a canonical vs mCpG methylation stream.  All reads
come from the seeded pore models of ``strique_tpu.synthetic``.

Baseline (no published reference throughput exists; see BASELINE.md):
the repo's own single-threaded CPU implementations of the reference's
engines on this workload (tools/measure_baseline.py,
BASELINE_MEASURED.json), measured on a CPU host.

Prints one JSON line with the device it ran on.  Exits non-zero without
a GPU: a CPU run measures nothing a user pays for.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from strique_tpu.synthetic import C9_PREFIX as PREFIX
from strique_tpu.synthetic import C9_SUFFIX as SUFFIX

REPEAT = "GGCCCC"
SEED = 1234
UNIFORM_UNITS = 100
MOD_UNITS = 50


def _baseline_reads_per_sec() -> float:
    """Measured reference-engine baseline (tools/measure_baseline.py)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BASELINE_MEASURED.json")
    try:
        with open(path) as fp:
            return float(json.load(fp)["reference_reads_per_sec_derived"])
    except (OSError, KeyError, ValueError):
        return 2.78


def build_workloads(pm, pm_mod, n_uniform: int, n_ragged: int, n_mod: int,
                    seed: int = SEED) -> dict:
    """The three read sets, drawn in a fixed order from one seeded stream.

    uniform: one sequence (1000 bp backbone halves, 100 units), fresh noise
    per read, edge-padded to one length; ragged: (strand, units, signal)
    with 50/100/150 units, 500/2000/6000 bp backbones, alternating strands,
    shuffled; mod: 50 units, even reads canonical, odd reads mCpG.
    """
    import random

    from strique_tpu.detect.counter import reverse_complement

    rng = np.random.default_rng(seed)
    backbone = "".join(rng.choice(list("ACTG"), 2000))
    seq = backbone[:1000] + PREFIX + REPEAT * UNIFORM_UNITS + SUFFIX + backbone[-1000:]
    uniform = [pm.generate_signal(seq, samples=8, noise=True, rng=rng) for _ in range(n_uniform)]
    max_len = max(len(s) for s in uniform)
    uniform = [np.pad(s, (0, max_len - len(s)), mode="edge") for s in uniform]
    ragged = []
    for i in range(n_ragged):
        nrep = (50, 100, 150)[i % 3]
        bb_n = int(rng.choice((500, 2000, 6000)))
        bb = "".join(rng.choice(list("ACTG"), max(2 * bb_n, 2)))
        rseq = bb[:bb_n] + PREFIX + REPEAT * nrep + SUFFIX + bb[-bb_n:]
        strand = "+" if i % 2 == 0 else "-"
        if strand == "-":
            rseq = reverse_complement(rseq)
        ragged.append((strand, nrep, pm.generate_signal(rseq, samples=8, noise=True, rng=rng)))
    random.Random(5).shuffle(ragged)
    mseq = backbone[:1000] + PREFIX + REPEAT * MOD_UNITS + SUFFIX + backbone[-1000:]
    mod = [(pm if i % 2 == 0 else pm_mod).generate_signal(mseq, samples=8, noise=True, rng=rng)
           for i in range(n_mod)]
    mlen = max(len(s) for s in mod)
    mod = [np.pad(s, (0, mlen - len(s)), mode="edge") for s in mod]
    return {"uniform": uniform, "ragged": ragged, "mod": mod}


def uniform_pass(counter, sigs, batch: int) -> list:
    """Three-stage pipeline (submit -> middle -> finish): batch k's Viterbi
    and decode overlap batch k+1's prep and alignment.  Returns the rows."""
    rows, pending = [], []
    for b0 in range(0, len(sigs), batch):
        pending.append(counter.detect_submit("c9orf72", sigs[b0:b0 + batch], "+"))
        if len(pending) >= 2:
            pending[-2] = counter.detect_middle(pending[-2])
        if len(pending) >= 3:
            rows += counter.detect_finish(pending.pop(0))
    for state in pending:
        rows += counter.detect_finish(state)
    return rows


def stream_pass(counter, reads, batch: int) -> dict:
    """The production stream path: reads queue by (target, strand, bucket)
    and flush as full shape-homogeneous batches.  ``reads``: (strand,
    signal) pairs.  Returns {read index: row or None}."""
    from strique_tpu.detect.stream import StreamScheduler

    res = {}
    sched = StreamScheduler(counter, lambda ctx, out: res.__setitem__(ctx, out),
                            batch_size=batch)
    for i, (strand, sig) in enumerate(reads):
        sched.add(i, "c9orf72", strand, sig)
    sched.close()
    return res


def mod_score(res: dict, n: int) -> tuple[int, int]:
    """(exact counts, separated calls) of the mod stream: odd reads are mCpG."""
    ok = sep = 0
    for i in range(n):
        r = res.get(i)
        if r is None or r[0] != MOD_UNITS or not r[6] or r[6] == "-":
            continue
        ok += 1
        frac1 = r[6].count("1") / len(r[6])
        sep += int(frac1 > 0.5 if i % 2 else frac1 < 0.5)
    return ok, sep


def main():
    import jax

    from strique_tpu import platform
    from strique_tpu.detect.counter import RepeatCounter
    from strique_tpu.ops.align import kernel_stats, reset_kernel_stats
    from strique_tpu.pore_model import PoreModel
    from strique_tpu.synthetic import default_assets

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; found {dev.platform} ({dev.device_kind})")
    platform.enable_compile_cache()
    assets = default_assets()
    batch = int(os.environ.get("BENCH_BATCH", "64"))
    n_reads = int(os.environ.get("BENCH_READS", "128"))
    n_ragged = int(os.environ.get("BENCH_RAGGED_READS", "192"))
    n_mod = int(os.environ.get("BENCH_MOD_READS", "96"))
    n_timed = int(os.environ.get("BENCH_PASSES", "3"))

    pm, pm_mod = PoreModel(assets.model), PoreModel(assets.mod_model)
    w = build_workloads(pm, pm_mod, batch + n_reads, n_ragged, n_mod)
    counter = RepeatCounter(assets.model)
    counter.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    mod_counter = RepeatCounter(assets.model, mod_model_file=assets.mod_model)
    mod_counter.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    warm, sigs = w["uniform"][:batch], w["uniform"][batch:]
    ragged = [(s, sig) for s, _, sig in w["ragged"]]
    mods = [("+", sig) for sig in w["mod"]]

    t0 = time.perf_counter()
    counter.detect_many("c9orf72", warm, "+")
    uniform_pass(counter, sigs, batch)
    stream_pass(counter, ragged, batch)
    stream_pass(mod_counter, mods, batch)
    setup_s = time.perf_counter() - t0

    def timed(fn):
        dts, out = [], None
        for _ in range(n_timed):
            t = time.perf_counter()
            out = fn()
            dts.append(time.perf_counter() - t)
        return out, dts

    reset_kernel_stats()
    rows, dts = timed(lambda: uniform_pass(counter, sigs, batch))
    cells = kernel_stats()["cells"] // n_timed
    correct = sum(int(r[0] == UNIFORM_UNITS) for r in rows)
    res_r, dts_r = timed(lambda: stream_pass(counter, ragged, batch))
    ragged_ok = sum(int(res_r.get(i) is not None and res_r[i][0] == nrep)
                    for i, (_, nrep, _) in enumerate(w["ragged"]))
    res_m, dts_m = timed(lambda: stream_pass(mod_counter, mods, batch))
    mod_ok, mod_sep = mod_score(res_m, n_mod)

    med = lambda ts: sorted(ts)[len(ts) // 2]
    baseline = _baseline_reads_per_sec()
    result = {
        "metric": "reads_per_sec",
        "value": n_reads / med(dts),
        "unit": "reads/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "ragged_reads_per_sec": n_ragged / med(dts_r),
        "mod_reads_per_sec": n_mod / med(dts_m),
        "accuracy": {"uniform": f"{correct}/{n_reads}", "ragged": f"{ragged_ok}/{n_ragged}",
                     "mod": f"{mod_ok}/{n_mod}", "mod_separation": f"{mod_sep}/{n_mod}"},
        "timing": f"median_of_{n_timed}",
        "pass_seconds": {"uniform": dts, "ragged": dts_r, "mod": dts_m},
        "setup_seconds": setup_s,
        "align_cell_updates_per_sec": cells / med(dts),
        "baseline_reads_per_sec": baseline,
        "peak_bytes_in_use": (dev.memory_stats() or {}).get("peak_bytes_in_use"),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
