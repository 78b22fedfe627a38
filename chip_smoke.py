#!/usr/bin/env python3
"""Smoke run of the repeat-count path on an NVIDIA GPU, in one process.

    python3 chip_smoke.py               # one card, every phase below
    python3 chip_smoke.py --devices 4   # the 4-card data mesh vs one card, nothing else

Phases (one line each; any failure ends the run with a non-zero exit):
  1. build and load the CUDA kernel library (set-up time);
  2. kernel parity at bench widths (64-read batch, ~23k samples, ~870-
     sample flank templates): the flank-DP kernel vs ``align_scan`` on all
     128 (read, flank) rows and vs the float64 oracle on a few; the
     Viterbi kernel vs ``viterbi_scan_factored`` / ``viterbi_scan`` and
     the float64 oracle;
  3. hand-written kernel vs the plain version XLA compiles, per kernel
     and end to end through ``StreamScheduler`` on the ragged stream;
  4. counts through the normal entry points on the bench workloads
     (uniform 128 via detect_submit, ragged 192 via StreamScheduler, mod
     96), with reads/s and peak device memory;
  5. the repository's ``gpu``-marked tests, in this process;
  6. ``strique index`` + ``strique count`` on a seeded bulk fast5 + SAM
     (skipped, with a line saying so, when h5py is absent).

The last line of standard output is one JSON object naming the device.
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 64


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str, **fields) -> None:
    vals = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {vals}", flush=True)


def card_line() -> str:
    """Name and power limit from nvidia-smi (a child that never imports JAX)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip()


def timed(fn, reps: int = 3):
    """(result, first-call seconds incl. compile, median steady seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, first, sorted(ts)[len(ts) // 2]


def morph_signals(pm, raws, npad):
    """Align-stage input: the pipeline's morph channel, NumPy preprocessing."""
    import numpy as np

    from strique_tpu.ops import signal as so
    from strique_tpu.pore_model import mean_abs_dev

    out = np.zeros((len(raws), npad), np.float32)
    for i, raw in enumerate(raws):
        flt = so.medfilt3(np.asarray(raw, np.float64))
        m = so.open_close_np(so.quantize_morph_np(flt, float(np.median(flt)), mean_abs_dev(flt)))
        out[i, : len(raw)] = pm.normalize2model(m, mode="minmax")
    return out


def flank_phase(env, w):
    """Phases 2 and 3 for the flank DP on one full bench batch."""
    import jax.numpy as jnp
    import numpy as np

    from strique_tpu.detect.counter import signal_bucket
    from strique_tpu.ops import align as A
    from strique_tpu.ops import cuda
    from strique_tpu.ops.reference import semiglobal_align_np

    pm, tc, params = env["pm"], env["tc"], env["params"]
    raws = w["uniform"][:BATCH]
    npad = signal_bucket(max(len(r) for r in raws))
    sig = jnp.asarray(morph_signals(pm, raws, npad))
    na = jnp.asarray(np.array([len(r) for r in raws], np.int32))
    t_pre, t_suf = np.asarray(tc.prefix_ext, np.float32), np.asarray(tc.suffix_ext, np.float32)

    (pre, suf), k_first, k_s = timed(
        lambda: A.align_fused_pair(sig, na, t_pre, t_suf, params, impl="cuda"))
    (ref_pre, ref_suf), x_first, x_s = timed(
        lambda: A.align_fused_pair(sig, na, t_pre, t_suf, params, impl="xla"), reps=1)
    dscore, rows_same = 0.0, 0
    for got, ref in ((pre, ref_pre), (suf, ref_suf)):
        same = np.ones(BATCH, bool)
        for k in ("j_end", "jpos", "is_gap", "j_begin"):
            g, r = np.asarray(got[k]), np.asarray(ref[k])
            same &= (g == r).reshape(BATCH, -1).all(axis=1)
        rows_same += int(same.sum())
        dscore = max(dscore, float(np.abs(np.asarray(got["score"]) - np.asarray(ref["score"])).max()))
    if rows_same != 2 * BATCH:
        fail(f"flank DP: {2 * BATCH - rows_same} of {2 * BATCH} rows differ from align_scan")
    oracle_rows = 0
    for i in (0, BATCH - 1):
        n = int(na[i])
        s_o, _a, _b, jb, je = semiglobal_align_np(np.asarray(sig[i, :n], np.float64),
                                                   t_pre.astype(np.float64), params, full=True)
        if int(pre["j_end"][i]) != je or int(pre["j_begin"][i]) != jb:
            fail(f"flank DP row {i}: end/begin differ from the float64 oracle")
        if abs(float(pre["score"][i]) - s_o) > 1e-4 * max(abs(s_o), 1.0):
            fail(f"flank DP row {i}: score {float(pre['score'][i])} vs oracle {s_o}")
        oracle_rows += 1
    phase("flank_parity", rows_identical=f"{rows_same}/{2 * BATCH}",
          fields="j_end,jpos,is_gap,j_begin", max_abs_dscore=dscore,
          f64_oracle_rows=f"{oracle_rows}/{oracle_rows}", N=npad, M=f"{len(t_pre)},{len(t_suf)}")

    # the plain diagonal sweep XLA compiles, and the traceback split out
    rows, ms = A.pad_template_rows([t_pre, t_suf])
    rows2 = jnp.asarray(np.repeat(rows, BATCH, axis=0))
    ms2 = jnp.asarray(np.repeat(ms, BATCH))
    sig2, na2 = jnp.concatenate([sig, sig]), jnp.concatenate([na, na])
    (ptr, score, j_end), f_first, f_s = timed(
        lambda: cuda.wave_forward(sig2, na2, rows2, ms2, params))
    _, tbk_first, tbk_s = timed(lambda: cuda.traceback(ptr, j_end, ms2, int(ms.max())))
    _, tbx_first, tbx_s = timed(lambda: A.traceback_diag(ptr, j_end, ms2, int(ms.max())))
    (_p, d_score, d_jend), d_first, d_s = timed(
        lambda: A.align_diag(sig2, na2, rows2, ms2, params), reps=1)
    if not np.array_equal(np.asarray(d_jend), np.asarray(j_end)):
        fail("flank DP: kernel end columns differ from align_diag")
    cells = 2 * BATCH * (npad + rows.shape[1]) * rows.shape[1]
    phase("flank_timing", batch_reads=BATCH, kernel_fwd_tb_s=k_s, kernel_fwd_s=f_s,
          kernel_traceback_s=tbk_s, lax_traceback_s=tbx_s, xla_align_scan_s=x_s,
          xla_diag_sweep_s=d_s, issued_cells=cells, kernel_cell_updates_per_s=cells / f_s,
          setup_compile_s=f"kernel:{k_first - k_s:.2f},scan:{x_first - x_s:.2f},"
                          f"diag:{d_first - d_s:.2f}")
    return {"kernel_s": k_s, "xla_s": x_s, "diag_s": d_s}


def viterbi_phase(env, w):
    """Phases 2 and 3 for the Viterbi on bench-shaped repeat segments."""
    import jax.numpy as jnp
    import numpy as np

    from strique_tpu.detect.counter import pad_bucket
    from strique_tpu.ops import cuda
    from strique_tpu.ops import viterbi as V
    from strique_tpu.ops.reference import viterbi_np

    pm, tc, counter = env["pm"], env["tc"], env["counter"]
    chm = tc.repeat_hmm
    row = env["assets"].row()
    # the repeat segment the counter decodes: HMM flanks around 100 units
    seq = row[5][-50:] + row[4] * 100 + row[6][:50]
    rng = np.random.default_rng(77)
    segs = [pm.generate_signal(seq, samples=8, noise=True, rng=rng).astype(np.float32)
            for _ in range(BATCH)]
    T = pad_bucket(max(len(s) for s in segs))
    obs = np.zeros((BATCH, T), np.float32)
    for i, s in enumerate(segs):
        obs[i, : len(s)] = s
    lens = np.array([len(s) for s in segs], np.int32)
    dev = counter._device_hmm(chm)
    spec, weights = counter._factored(chm)
    obs_d, lens_d = jnp.asarray(obs), jnp.asarray(lens)
    (lp_k, path_k), k_first, k_s = timed(
        lambda: cuda.viterbi_factored_batch(obs_d, lens_d, dev, spec, weights))
    (lp_f, path_f), f_first, f_s = timed(
        lambda: V.viterbi_scan_factored_batch(obs_d, lens_d, dev, spec, weights), reps=1)
    (lp_d, path_d), d_first, d_s = timed(
        lambda: V.viterbi_scan_batch(obs_d, lens_d, *dev), reps=1)
    path_k, path_f, path_d = map(np.asarray, (path_k, path_f, path_d))
    same_f = sum(np.array_equal(path_k[i, : lens[i]], path_f[i, : lens[i]]) for i in range(BATCH))
    same_d = sum(np.array_equal(path_k[i, : lens[i]], path_d[i, : lens[i]]) for i in range(BATCH))
    rel = float(np.max(np.abs(np.asarray(lp_k) - np.asarray(lp_f)) / np.abs(np.asarray(lp_f))))
    counts_k = [V.count_repeats(path_k[i], int(lens[i]), chm) for i in range(BATCH)]
    counts_d = [V.count_repeats(path_d[i], int(lens[i]), chm) for i in range(BATCH)]
    if same_f != BATCH or rel > 1e-6:
        fail(f"viterbi: {BATCH - same_f} paths differ from viterbi_scan_factored (rel logp {rel})")
    if counts_k != counts_d:
        fail("viterbi: counts differ from the dense viterbi_scan")
    for i in (0, 1):
        t = int(lens[i])
        lp_o, path_o = viterbi_np(obs[i, :t].astype(np.float64), chm.log_start, chm.log_trans,
                                  chm.log_end, chm.mu, chm.sigma, chm.is_uniform, chm.log_uni)
        if V.count_repeats(path_o, t, chm) != counts_k[i]:
            fail(f"viterbi read {i}: count differs from the float64 oracle")
        if abs(V.path_logp_f64(obs[i, :t], path_k[i], chm) - lp_o) > 1e-6 * abs(lp_o):
            fail(f"viterbi read {i}: path log-p differs from the float64 oracle optimum")
    phase("viterbi_parity", paths_identical_factored=f"{same_f}/{BATCH}",
          paths_identical_dense=f"{same_d}/{BATCH}", counts_equal_dense=f"{BATCH}/{BATCH}",
          max_rel_dlogp=rel, f64_oracle_reads="2/2", T=T, states=chm.n_states)
    phase("viterbi_timing", batch_reads=BATCH, kernel_s=k_s, xla_factored_scan_s=f_s,
          xla_dense_scan_s=d_s,
          setup_compile_s=f"kernel:{k_first - k_s:.2f},factored:{f_first - f_s:.2f},"
                          f"dense:{d_first - d_s:.2f}")
    return {"kernel_s": k_s, "xla_s": f_s}


def e2e_phase(env, w):
    """Phase 3 end to end: the ragged stream with each kernel swapped for
    its plain XLA version, one at a time."""
    import bench
    from strique_tpu import platform
    from strique_tpu.detect.counter import RepeatCounter

    assets = env["assets"]
    reads = [(s, sig) for s, _, sig in w["ragged"]]
    out = {}
    real_align, real_vit = platform.align_impl, platform.viterbi_impl
    configs = (("kernels", real_align, real_vit), ("xla_align", lambda: "xla", real_vit),
               ("xla_viterbi", real_align, lambda: "xla"))
    try:
        for name, a_impl, v_impl in configs:
            platform.align_impl, platform.viterbi_impl = a_impl, v_impl
            c = RepeatCounter(assets.model)
            c.add_target("c9orf72", *assets.row()[4:7])
            t0 = time.perf_counter()
            bench.stream_pass(c, reads, BATCH)
            warm = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = bench.stream_pass(c, reads, BATCH)
            dt = time.perf_counter() - t0
            ok = sum(int(res.get(i) is not None and res[i][0] == n)
                     for i, (_, n, _) in enumerate(w["ragged"]))
            out[name] = {"s": dt, "ok": ok, "warm_s": warm}
    finally:
        platform.align_impl, platform.viterbi_impl = real_align, real_vit
    n = len(reads)
    phase("e2e_ragged", **{f"{k}_reads_per_s": n / v["s"] for k, v in out.items()},
          **{f"{k}_exact": f"{v['ok']}/{n}" for k, v in out.items()},
          setup_s=",".join(f"{k}:{v['warm_s']:.1f}" for k, v in out.items()))
    return out


def count_phase(env, w):
    """Phase 4: counts through the entry points users call."""
    import jax

    import bench
    from strique_tpu.ops.reference import detect_np

    counter, mod_counter = env["counter"], env["mod_counter"]
    dev = jax.devices()[0]
    sigs = w["uniform"][BATCH:]
    t0 = time.perf_counter()
    counter.detect_many("c9orf72", w["uniform"][:BATCH], "+")
    bench.uniform_pass(counter, sigs, BATCH)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = bench.uniform_pass(counter, sigs, BATCH)
    dt = time.perf_counter() - t0
    ok = sum(int(r[0] == bench.UNIFORM_UNITS) for r in rows)
    phase("count_uniform", exact=f"{ok}/{len(sigs)}", reads_per_s=len(sigs) / dt,
          setup_s=setup, peak_bytes_in_use=dev.memory_stats().get("peak_bytes_in_use"))
    if ok != len(sigs):
        fail(f"uniform stream: {ok}/{len(sigs)} exact")

    reads = [(s, sig) for s, _, sig in w["ragged"]]
    t0 = time.perf_counter()
    bench.stream_pass(counter, reads, BATCH)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = bench.stream_pass(counter, reads, BATCH)
    dt = time.perf_counter() - t0
    misses = [i for i, (_, n, _) in enumerate(w["ragged"])
              if res.get(i) is None or res[i][0] != n]
    phase("count_ragged", exact=f"{len(reads) - len(misses)}/{len(reads)}",
          reads_per_s=len(reads) / dt, setup_s=setup,
          peak_bytes_in_use=dev.memory_stats().get("peak_bytes_in_use"))
    for i in misses:
        strand, n, sig = w["ragged"][i]
        got = None if res.get(i) is None else res[i][0]
        tc = counter.targets["c9orf72"][0 if strand == "+" else 1]
        oc, sp, ss = detect_np(counter.pm, tc, sig)
        phase("ragged_miss", read=i, strand=strand, inserted=n, kernel=got, f64_oracle=oc,
              verdict="oracle agrees" if oc == got else "KERNEL DISAGREES")
        if oc != got:
            fail(f"ragged read {i}: the float64 oracle counts {oc}, the kernels {got}")
    if len(misses) > 1:
        fail(f"ragged stream: {len(misses)} misses")

    mods = [("+", sig) for sig in w["mod"]]
    t0 = time.perf_counter()
    bench.stream_pass(mod_counter, mods, BATCH)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = bench.stream_pass(mod_counter, mods, BATCH)
    dt = time.perf_counter() - t0
    ok, sep = bench.mod_score(res, len(mods))
    phase("count_mod", exact=f"{ok}/{len(mods)}", separated=f"{sep}/{len(mods)}",
          reads_per_s=len(mods) / dt, setup_s=setup,
          peak_bytes_in_use=dev.memory_stats().get("peak_bytes_in_use"))
    if ok != len(mods):
        fail(f"mod stream: {ok}/{len(mods)} exact")


def test_phase():
    """Phase 5: the gpu-marked tests, in this process (one JAX client per card)."""
    import pytest

    os.environ["STRIQUE_TEST_DEVICE"] = "gpu"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(ROOT, "tests", "test_cuda.py")])
    tail = [l for l in buf.getvalue().strip().splitlines() if l.strip()][-1:]
    phase("gpu_tests", rc=int(rc), summary=repr(tail[0] if tail else ""),
          seconds=time.perf_counter() - t0)
    if rc != 0:
        print(buf.getvalue(), file=sys.stderr)
        fail("gpu-marked tests failed")


def cli_phase(env):
    """Phase 6: index + count through the CLI on a seeded bulk fast5 + SAM."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("[cli] not run: h5py is absent on this machine", flush=True)
        return
    from strique_tpu.cli import main
    from strique_tpu.synthetic import write_run

    assets = env["assets"]
    with tempfile.TemporaryDirectory() as d:
        run = write_run(d, assets, n_reads=24)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["index", d])
        fofn = os.path.join(d, "reads.fofn")
        with open(fofn, "w") as fp:
            fp.write(buf.getvalue())
        out = os.path.join(d, "counts.tsv")
        t0 = time.perf_counter()
        rc = main(["count", fofn, assets.model, assets.repeat_config, "--algn", run["sam"],
                   "--config", assets.params, "--out", out, "--devices", "1"])
        dt = time.perf_counter() - t0
        if rc != 0:
            fail(f"strique count exited {rc}")
        with open(out) as fp:
            rows = [l.split("\t") for l in fp.read().strip().split("\n")[1:]]
    exact = sum(int(int(r[3]) == run["expected"][r[0]][1] and r[2] == run["expected"][r[0]][0])
                for r in rows)
    phase("cli", rows=len(rows), exact=f"{exact}/{len(run['expected'])}", seconds=dt)
    if exact != len(run["expected"]):
        fail(f"CLI count: {exact}/{len(run['expected'])} exact")


def mesh_phase(env, w, n_dev):
    """--devices N: the ragged stream on a data mesh vs one card, row for row."""
    import jax

    import bench
    from strique_tpu.detect.counter import RepeatCounter
    from strique_tpu.parallel.mesh import make_mesh

    assets = env["assets"]
    if len(jax.devices()) < n_dev:
        fail(f"--devices {n_dev}: only {len(jax.devices())} GPUs visible")
    reads = [(s, sig) for s, _, sig in w["ragged"]]
    results = {}
    for name, mesh in (("one", None), ("mesh", make_mesh({"data": n_dev}, jax.devices()[:n_dev]))):
        c = RepeatCounter(assets.model, mesh=mesh)
        c.add_target("c9orf72", *assets.row()[4:7])
        t0 = time.perf_counter()
        bench.stream_pass(c, reads, BATCH)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        results[name] = bench.stream_pass(c, reads, BATCH)
        results[name + "_s"] = time.perf_counter() - t0
        results[name + "_warm"] = warm
    same = sum(int(results["one"].get(i) == results["mesh"].get(i)) for i in range(len(reads)))
    ok = sum(int(results["mesh"].get(i) is not None and results["mesh"][i][0] == n)
             for i, (_, n, _) in enumerate(w["ragged"]))
    phase("mesh_ragged", devices=n_dev, rows_identical=f"{same}/{len(reads)}",
          exact=f"{ok}/{len(reads)}", one_card_reads_per_s=len(reads) / results["one_s"],
          mesh_reads_per_s=len(reads) / results["mesh_s"],
          setup_s=f"one:{results['one_warm']:.1f},mesh:{results['mesh_warm']:.1f}")
    if same != len(reads):
        fail(f"mesh rows differ from one card on {len(reads) - same} reads")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1: every phase on one card; N>1: only the N-card mesh phase")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "strique_tpu")):
        fail("run from a checkout of the repository (strique_tpu/ not found beside this script)")
    sys.path.insert(0, ROOT)
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"needs an NVIDIA GPU; JAX found {devs[0].platform} ({devs[0].device_kind})")
    print(card_line(), flush=True)

    from strique_tpu import platform
    from strique_tpu.ops import cuda

    platform.enable_compile_cache()
    t0 = time.perf_counter()
    info = cuda.load()
    phase("build", nvcc_s=info["build_s"], load_s=time.perf_counter() - t0 - info["build_s"],
          library=os.path.relpath(info["path"], ROOT))

    import bench
    from strique_tpu.detect.counter import RepeatCounter
    from strique_tpu.ops.reference import AlignParams
    from strique_tpu.pore_model import PoreModel
    from strique_tpu.synthetic import default_assets

    assets = default_assets()
    pm, pm_mod = PoreModel(assets.model), PoreModel(assets.mod_model)
    t0 = time.perf_counter()
    # bench's read sets: a warm batch + 128 timed uniform reads, 192 ragged, 96 mod
    w = bench.build_workloads(pm, pm_mod, BATCH + 128, 192, 96)
    counter = RepeatCounter(assets.model)
    counter.add_target("c9orf72", *assets.row()[4:7])
    env = {"assets": assets, "pm": pm, "counter": counter, "tc": counter.targets["c9orf72"][0],
           "params": AlignParams()}
    phase("workloads", uniform=len(w["uniform"]) - BATCH, ragged=len(w["ragged"]),
          mod=len(w["mod"]), seconds=time.perf_counter() - t0)

    if args.devices > 1:
        mesh_phase(env, w, args.devices)
    else:
        mod_counter = RepeatCounter(assets.model, mod_model_file=assets.mod_model)
        mod_counter.add_target("c9orf72", *assets.row()[4:7])
        env["mod_counter"] = mod_counter
        flank_phase(env, w)
        viterbi_phase(env, w)
        e2e_phase(env, w)
        count_phase(env, w)
        test_phase()
        cli_phase(env)

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {"platform": d[0].platform,
                                             "kind": d[0].device_kind, "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
