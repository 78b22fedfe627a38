"""Measure a defensible CPU baseline for the reference pipeline.

The reference (giesselmann/STRique) publishes no throughput numbers and
cannot be built here (its SeqAn/pybind11/ont_fast5_api submodules are
not checked out and pomegranate 0.10 is not installed), so the baseline
is *measured* from this repo's own CPU implementations of the same
engines on the exact bench.py workload, single-threaded, with explicit
credit factors where the reference's engine is plausibly faster:

  * host preprocessing — the reference runs scipy.medfilt + skimage
    morphology + NumPy percentile normalization on the host
    (reference scripts/STRique.py:590-597); our NumPy path computes the
    identical chain, so its time IS the reference's cost (no credit).
  * flank alignment — the reference calls SeqAn2 ``globalAlignment``
    once per flank through pybind11 (reference src/align_raw.h:117-158).
    SeqAn's SIMD batch mode does not apply to single pairwise calls, but
    we still credit SeqAn AVX2 x SEQAN_CREDIT over our -O3 -march=native
    scalar C++ DP (native/strique_native.cpp) to stay conservative.
  * Viterbi — the reference runs pomegranate's Cython sparse Viterbi
    (edge list); our NumPy f64 Viterbi is dense (S^2 per step).  We
    credit pomegranate the full sparsity ratio S / mean-in-degree,
    treating its per-edge Cython throughput as equal to our per-edge
    dense NumPy throughput (generous: scalar Cython loops are usually
    slower per edge than vectorized NumPy).

Writes BASELINE_MEASURED.json; bench.py uses its derived
reads-per-second as the vs_baseline denominator.
"""
import json
import os
import platform
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# single-core measurement
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"

import numpy as np

from strique_tpu import native as native_lib
from strique_tpu.hmm.models import build_flanked_repeat
from strique_tpu.ops import signal as signal_ops
from strique_tpu.ops.reference import AlignParams, semiglobal_align_np, viterbi_np
from strique_tpu.pore_model import PoreModel, mean_abs_dev
from strique_tpu.synthetic import C9_PREFIX as PREFIX
from strique_tpu.synthetic import C9_SUFFIX as SUFFIX
from strique_tpu.synthetic import default_assets

SEQAN_CREDIT = 4.0  # assumed max SeqAn AVX2 advantage over our scalar C++ DP


def main():
    repeats = 100
    n_reads = int(os.environ.get("BASELINE_READS", "4"))
    pm = PoreModel(default_assets().model)
    rng = np.random.default_rng(1234)
    backbone = "".join(rng.choice(list("ACTG"), 2000))
    seq = backbone[:1000] + PREFIX + "GGCCCC" * repeats + SUFFIX + backbone[-1000:]
    raws = [pm.generate_signal(seq, samples=8, noise=True, rng=rng) for _ in range(n_reads)]

    chm = build_flanked_repeat("GGCCCC", PREFIX[-50:], SUFFIX[:50], pm)
    hmm = (chm.log_start, chm.log_trans, chm.log_end, chm.mu, chm.sigma,
           chm.is_uniform, chm.log_uni)
    mean_in_degree = float(np.isfinite(chm.log_trans).sum(axis=0).mean())
    pomegranate_credit = chm.n_states / mean_in_degree

    t_pre = pm.generate_signal(PREFIX, samples=6).astype(np.float32)
    t_suf = pm.generate_signal(SUFFIX, samples=6).astype(np.float32)
    params = AlignParams()

    stages = {k: 0.0 for k in ("prep", "align_native", "align_oracle_np", "viterbi_np")}
    cells = 0
    viterbi_steps = 0

    for raw in raws:
        t0 = time.perf_counter()
        flt = signal_ops.medfilt3(raw.astype(np.float64))
        morph = signal_ops.quantize_morph_np(flt, float(np.median(flt)), mean_abs_dev(flt))
        morph = signal_ops.open_close_np(morph)
        morph_n = pm.normalize2model(morph, mode="minmax").astype(np.float32)
        flt_n = pm.normalize2model(flt, mode="minmax")
        stages["prep"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        _, pos_p, gap_p = native_lib.align_semiglobal(morph_n, t_pre, params)
        _, pos_s, gap_s = native_lib.align_semiglobal(morph_n, t_suf, params)
        stages["align_native"] += time.perf_counter() - t0
        cells += len(morph_n) * (len(t_pre) + len(t_suf))

        t0 = time.perf_counter()
        semiglobal_align_np(morph_n.astype(np.float64), t_pre.astype(np.float64), params)
        stages["align_oracle_np"] += time.perf_counter() - t0

        # 50bp-core trim: ext template 870 samples, core 45 kmers x 6 = 270
        begin, end = int(pos_p[len(t_pre) - 270]), int(pos_s[len(pos_s) - 1 - (len(t_suf) - 270)])
        seg = np.clip(flt_n[max(begin, 0):end], pm.model_min + 0.5, pm.model_max - 0.5)
        t0 = time.perf_counter()
        viterbi_np(seg, *hmm)
        stages["viterbi_np"] += time.perf_counter() - t0
        viterbi_steps += len(seg)

    per_read = {k: v / n_reads for k, v in stages.items()}
    ref_per_read = (per_read["prep"]
                    + per_read["align_native"] / SEQAN_CREDIT
                    + per_read["viterbi_np"] / pomegranate_credit)
    out = {
        "workload": {"repeats": repeats, "read_len": int(np.mean([len(r) for r in raws])),
                     "n_reads": n_reads, "viterbi_steps_per_read": viterbi_steps // n_reads},
        "host": {"cpu": platform.processor() or platform.machine(),
                 "cores": os.cpu_count(), "threads_used": 1},
        "stage_seconds_per_read": {k: round(v, 4) for k, v in per_read.items()},
        "native_align_cells_per_sec": round(cells / stages["align_native"] / 1e6, 1),
        "credits": {"seqan_over_native_cpp": SEQAN_CREDIT,
                    "pomegranate_sparsity": round(pomegranate_credit, 2),
                    "mean_in_degree": round(mean_in_degree, 1),
                    "n_states": chm.n_states},
        "reference_seconds_per_read_derived": round(ref_per_read, 4),
        "reference_reads_per_sec_derived": round(1.0 / ref_per_read, 3),
    }
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "BASELINE_MEASURED.json")
    with open(path, "w") as fp:
        json.dump(out, fp, indent=1)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
