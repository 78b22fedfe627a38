"""Multi-device scaling-efficiency benchmark (BASELINE.md north star:
>= 80% reads/s scaling efficiency across the mesh).

Sweeps the data-parallel degree over {1, 2, 4, ...} devices, running the
production fused detection pipeline (`RepeatCounter` with a data-only
``jax.sharding.Mesh``) on a synthetic c9orf72 workload, and reports
reads/s plus efficiency per point.

On a host without multiple accelerators this runs on a virtual CPU mesh
(``--xla_force_host_platform_device_count``): the harness then validates
the sharded execution path and its overheads, while the *parallel*
efficiency ceiling is min(n_devices, physical cores) — ideal throughput
is computed against that ceiling so the number stays meaningful on both
a small CPU host and a multi-GPU host.  Reads come from the seeded
assets of ``strique_tpu.synthetic``.

Prints one JSON line per sweep point and, with ``--out``, writes the
full sweep to that file.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from strique_tpu.synthetic import C9_PREFIX as PREFIX  # noqa: E402
from strique_tpu.synthetic import C9_SUFFIX as SUFFIX  # noqa: E402


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", default=None,
                    help="Comma-separated sweep points (default: powers of 2 up to all devices)")
    ap.add_argument("--per-device", type=int, default=int(os.environ.get("SCALE_PER_DEV", "8")),
                    help="Reads per device per batch")
    ap.add_argument("--batches", type=int, default=int(os.environ.get("SCALE_BATCHES", "3")),
                    help="Timed batches per sweep point")
    ap.add_argument("--repeats", type=int, default=20, help="Repeat units per synthetic read")
    ap.add_argument("--cpu", action="store_true",
                    help="sweep a virtual 8-device CPU mesh instead of the accelerators")
    ap.add_argument("--out", default=None, help="JSON file to write the sweep to")
    return ap.parse_args()


def main():
    args = parse_args()
    force_cpu = args.cpu
    if force_cpu:
        # XLA_FLAGS takes effect because backends initialize lazily
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    if force_cpu:
        jax.config.update("jax_platforms", "cpu")

    from strique_tpu import platform
    from strique_tpu.detect.counter import RepeatCounter
    from strique_tpu.parallel.mesh import make_mesh
    from strique_tpu.pore_model import PoreModel
    from strique_tpu.synthetic import default_assets

    platform.enable_compile_cache()
    model_file = default_assets().model
    all_devices = jax.devices()
    cores = os.cpu_count() or 1
    if args.devices:
        sweep = [int(x) for x in args.devices.split(",")]
    else:
        sweep = []
        n = 1
        while n <= len(all_devices):
            sweep.append(n)
            n *= 2

    pm = PoreModel(model_file)
    rng = np.random.default_rng(99)
    backbone = "".join(rng.choice(list("ACTG"), 1000))
    seq = backbone[:500] + PREFIX + "GGCCCC" * args.repeats + SUFFIX + backbone[-500:]
    max_batch = args.per_device * max(sweep)
    sigs = [pm.generate_signal(seq, samples=6, noise=True, rng=rng)
            for _ in range(max_batch)]
    n_len = max(len(s) for s in sigs)
    sigs = [np.pad(s, (0, n_len - len(s)), mode="edge") for s in sigs]

    points = []
    rps1 = None
    for n_dev in sweep:
        mesh = None
        if n_dev > 1:
            mesh = make_mesh({"data": n_dev}, all_devices[:n_dev])
        counter = RepeatCounter(model_file, mesh=mesh)
        counter.add_target("c9orf72", "GGCCCC", PREFIX, SUFFIX)
        B = args.per_device * n_dev
        batch = sigs[:B]
        counter.detect_many("c9orf72", batch, "+")  # compile + warm
        t0 = time.perf_counter()
        ok = 0
        for _ in range(args.batches):
            for res in counter.detect_many("c9orf72", batch, "+"):
                ok += int(res[0] == args.repeats)
        dt = time.perf_counter() - t0
        rps = args.batches * B / dt
        if rps1 is None:
            rps1 = rps
        ceiling = min(n_dev, cores) if platform.platform() == "cpu" else n_dev
        point = {
            "metric": "scaling_reads_per_sec",
            "devices": n_dev,
            "value": round(rps, 3),
            "unit": "reads/s",
            "efficiency_vs_linear": round(rps / (rps1 * n_dev), 4),
            "efficiency_vs_host_ceiling": round(rps / (rps1 * ceiling), 4),
            "accuracy": f"{ok}/{args.batches * B}",
            "backend": platform.platform(),
            "physical_cores": cores,
        }
        points.append(point)
        print(json.dumps(point), flush=True)

    if args.out:
        with open(args.out, "w") as fp:
            json.dump({"sweep": points}, fp, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
