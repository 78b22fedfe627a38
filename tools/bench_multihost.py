"""Combined multi-host x multi-device scaling run.

Runs the REAL CLI end-to-end (fast5 index -> count -> merged TSV) on a
synthetic workload in two configurations on the virtual CPU mesh:

  * 1 process x 8 devices  (the single-host baseline)
  * 2 processes x 4 devices (jax.distributed coordinator, SAM stride
    split, per-host shards, rank-0 merge)

and prints reads/s + efficiency of the 2x4 run vs the 1x8 run (and
writes them to ``--out`` when given).  Counts must be exact in both
configurations and the merged file must contain every read exactly once.

Both configurations share the host's CPU cores, so the efficiency
quantifies the *process-split overhead* (coordinator, stride, merge)
rather than device scaling — the axis the single-process sweep cannot
see.  Reads come from the seeded assets of ``strique_tpu.synthetic``.

Usage: python tools/bench_multihost.py [--reads N] [--repeats N] [--out FILE]
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

from strique_tpu.synthetic import default_assets  # noqa: E402

ASSETS = default_assets()
MODEL = ASSETS.model


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def build_workload(d: str, n_reads: int, repeats: int):
    import h5py

    from strique_tpu.io import fast5
    from strique_tpu.pore_model import PoreModel

    repeat, prefix, suffix = ASSETS.row()[4:7]
    pm = PoreModel(MODEL)
    rng = np.random.default_rng(77)
    backbone = "".join(rng.choice(list("ACTG"), 1000))
    counts = {}
    sam_rows = ["@HD\tVN:1.6"]
    for i in range(n_reads):
        rid = f"read-{i:03d}"
        n = repeats + (i % 3) * 4  # a few segment buckets
        counts[rid] = n
        seq = backbone[:500] + prefix + repeat * n + suffix + backbone[-500:]
        sig = pm.generate_signal(seq, samples=8, noise=True, rng=rng)
        with h5py.File(os.path.join(d, f"{rid}.fast5"), "w") as f:
            g = f.create_group("Raw/Reads/Read_1")
            g.attrs["read_id"] = np.bytes_(rid.encode())
            g.create_dataset("Signal", data=(sig * 10).astype(np.int16))
        sam_rows.append(f"{rid}\t0\tchr9\t27541232\t60\t40000M\t*\t0\t0\t*\t*")
    fofn = os.path.join(d, "reads.fofn")
    with open(fofn, "w") as fp:
        fp.write("\n".join(fast5.index(d)) + "\n")
    tsv = os.path.join(d, "repeats.tsv")
    with open(tsv, "w") as fp:
        fp.write("chr\tbegin\tend\tname\trepeat\tprefix\tsuffix\n"
                 f"chr9\t27573527\t27573544\tc9orf72\t{repeat}\t{prefix}\t{suffix}\n")
    sam = os.path.join(d, "algn.sam")
    with open(sam, "w") as fp:
        fp.write("\n".join(sam_rows) + "\n")
    return fofn, tsv, sam, counts


def run_config(fofn, tsv, sam, out, n_procs, n_devices, batch):
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORM_NAME": "cpu",
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={n_devices}",
    })
    base = [sys.executable, "-m", "strique_tpu.cli", "count", fofn, MODEL, tsv,
            "--algn", sam, "--out", out, "--devices", str(n_devices),
            "--batch", str(batch)]
    t0 = time.perf_counter()
    if n_procs == 1:
        procs = [subprocess.Popen(base, env=env, cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE)]
    else:
        port = _free_port()
        procs = [subprocess.Popen(
            base + ["--coordinator", f"localhost:{port}",
                    "--num_hosts", str(n_procs), "--host_id", str(i)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for i in range(n_procs)]
    logs = [p.communicate() for p in procs]
    dt = time.perf_counter() - t0
    for p, (_so, se) in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"count rc={p.returncode}: {se.decode()[-2000:]}")
    return dt


def check_output(out, counts) -> int:
    rows = [l.split("\t") for l in open(out).read().strip().split("\n")[1:]]
    assert sorted(r[0] for r in rows) == sorted(counts), "row set mismatch"
    return sum(int(int(r[3]) == counts[r[0]]) for r in rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=96)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--out", default=None, help="JSON file to write the summary to")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as d:
        fofn, tsv, sam, counts = build_workload(d, args.reads, args.repeats)
        results = []
        for name, procs, devs in (("1x8", 1, 8), ("2x4", 2, 4)):
            out = os.path.join(d, f"counts_{name}.tsv")
            run_config(fofn, tsv, sam, out, procs, devs, batch=8 * devs // 8 * 8)
            os.remove(out)
            dt = run_config(fofn, tsv, sam, out, procs, devs, batch=8 * devs // 8 * 8)
            ok = check_output(out, counts)
            rps = args.reads / dt
            results.append({"config": name, "processes": procs, "devices": devs,
                            "reads_per_sec": round(rps, 3),
                            "accuracy": f"{ok}/{args.reads}", "wall_s": round(dt, 2)})
            print(json.dumps(results[-1]), flush=True)
        eff = results[1]["reads_per_sec"] / results[0]["reads_per_sec"]
        summary = {
            "workload": {"reads": args.reads, "repeats_base": args.repeats,
                         "note": "end-to-end CLI incl. fast5 IO, index, SAM decode, "
                                 "shard merge; warm compile cache (2nd run timed)"},
            "configs": results,
            "efficiency_2x4_vs_1x8": round(eff, 4),
            "physical_cores": os.cpu_count(),
        }
        print(json.dumps(summary))
        if args.out:
            with open(args.out, "w") as fp:
                json.dump(summary, fp, indent=1)


if __name__ == "__main__":
    main()
