"""Per-batch stage timing of the bench's ragged phase.

Replicates bench.py's ragged stream through the production scheduler but
times every detect_submit (host prep + upload + dispatch) and
detect_finish (D2H wait + host decode) call, printing per-batch
(target, strand, B, bucket, submit_ms, finish_ms) and the phase totals.
Directs where the ragged wall time actually goes.

Usage: python tools/profile_ragged.py   (on the GPU)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from strique_tpu import platform
    from strique_tpu.detect.counter import RepeatCounter, signal_bucket
    from strique_tpu.detect.stream import StreamScheduler
    from strique_tpu.synthetic import default_assets
    from tools.adjudicate_ragged import build_ragged_reads

    platform.enable_compile_cache()
    pm, ragged = build_ragged_reads()
    counter = RepeatCounter(default_assets().model)
    counter.add_target("c9orf72", *default_assets().row()[4:7])

    events = []
    orig_submit = counter.detect_submit
    orig_finish = counter.detect_finish

    def timed_submit(target, raws, strand, preps=None):
        t0 = time.perf_counter()
        state = orig_submit(target, raws, strand, preps)
        state["_t_submit"] = (time.perf_counter() - t0) * 1e3
        state["_meta"] = (strand, len(raws), signal_bucket(max(len(r) for r in raws)))
        return state

    def timed_finish(state):
        t0 = time.perf_counter()
        outs = orig_finish(state)
        events.append((*state["_meta"], state["_t_submit"],
                       (time.perf_counter() - t0) * 1e3))
        return outs

    counter.detect_submit = timed_submit
    counter.detect_finish = timed_finish

    def ragged_pass():
        res = {}
        sched = StreamScheduler(counter, lambda ctx, out: res.__setitem__(ctx, out),
                                batch_size=int(os.environ.get("BENCH_BATCH", "64")))
        for i, (strand, nrep, sig) in enumerate(ragged):
            sched.add(i, "c9orf72", strand, sig)
        sched.close()
        return res

    ragged_pass()  # warm/compile
    events.clear()
    t0 = time.perf_counter()
    ragged_pass()
    wall = time.perf_counter() - t0

    tot_submit = sum(e[3] for e in events)
    tot_finish = sum(e[4] for e in events)
    print(f"{'strand':6s} {'B':>3s} {'bucket':>7s} {'submit_ms':>10s} {'finish_ms':>10s}")
    for strand, B, bucket, ts, tf in events:
        print(f"{strand:6s} {B:3d} {bucket:7d} {ts:10.1f} {tf:10.1f}")
    print(f"\nbatches: {len(events)}  wall {wall*1e3:.0f} ms  "
          f"submit {tot_submit:.0f} ms  finish {tot_finish:.0f} ms  "
          f"({len(ragged)/wall:.1f} reads/s)")


if __name__ == "__main__":
    main()
