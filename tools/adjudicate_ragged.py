"""Adjudicate ragged-bench miscounts against the float64 oracle engine.

Regenerates bench.py's ragged read set (same seeds), runs every read
through the production counter, and for each read whose count differs
from the inserted repeat number, re-derives the result with the
independent float64 oracle chain — exact NumPy preprocessing, the
full-matrix float64 DP with SeqAn view-position semantics
(ops/reference.py::detect_range_np) and the dense float64 Viterbi
(ops/reference.py::viterbi_np), chained in ops/reference.py::detect_np.
Verdicts:

  * oracle count == kernel count != inserted n  ->  the miss is
    model-inherent (the true Viterbi optimum of the noisy signal), not a
    kernel defect;
  * oracle count != kernel count                ->  kernel bug: fix it.

Usage: python tools/adjudicate_ragged.py  (any backend; the GPU is faster)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_ragged_reads():
    """Rebuild bench.py's ragged read set (same seeds, same draw order)."""
    import bench
    from strique_tpu.pore_model import PoreModel
    from strique_tpu.synthetic import default_assets

    assets = default_assets()
    pm = PoreModel(assets.model)
    n_uniform = int(os.environ.get("BENCH_BATCH", "64")) + int(os.environ.get("BENCH_READS", "128"))
    n_ragged = int(os.environ.get("BENCH_RAGGED_READS", "192"))
    w = bench.build_workloads(pm, PoreModel(assets.mod_model), n_uniform, n_ragged, 1)
    return pm, w["ragged"]


def main():
    from strique_tpu import platform
    from strique_tpu.detect.counter import RepeatCounter
    from strique_tpu.detect.stream import StreamScheduler
    from strique_tpu.ops.reference import detect_np
    from strique_tpu.synthetic import default_assets

    platform.enable_compile_cache()
    pm, ragged = build_ragged_reads()
    counter = RepeatCounter(default_assets().model)
    counter.add_target("c9orf72", *default_assets().row()[4:7])

    res = {}
    sched = StreamScheduler(counter, lambda ctx, out: res.__setitem__(ctx, out),
                            batch_size=int(os.environ.get("BENCH_BATCH", "64")))
    for i, (strand, nrep, sig) in enumerate(ragged):
        sched.add(i, "c9orf72", strand, sig)
    sched.close()

    misses = [i for i, (_, nrep, _) in enumerate(ragged)
              if res.get(i) is None or res[i][0] != nrep]
    print(f"kernel pass: {len(ragged) - len(misses)}/{len(ragged)} exact; "
          f"misses at {misses}")
    for i in misses:
        strand, nrep, sig = ragged[i]
        got = None if res.get(i) is None else res[i][0]
        tc = counter.targets["c9orf72"][0 if strand == "+" else 1]
        oc, sp, ss = detect_np(pm, tc, sig)
        verdict = ("MODEL-INHERENT (oracle agrees with kernel)" if oc == got
                   else "KERNEL BUG (oracle disagrees)")
        print(f"read {i}: strand={strand} inserted={nrep} kernel={got} "
              f"oracle={oc} scores=({sp:.2f},{ss:.2f}) len={len(sig)} -> {verdict}")


if __name__ == "__main__":
    main()
