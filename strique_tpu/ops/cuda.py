"""The CUDA kernels of ``native/strique_cuda.cu``, called through ``jax.ffi``.

Build: ``python -m strique_tpu.ops.cuda`` compiles the library with
``nvcc`` into ``native/build/`` (git-ignored); :func:`load` does the same
at first use when the library is missing or older than its source.
Build and load failures raise: on a GPU nothing falls back to the scans.

Two kernel families, each the hand-written twin of a plain ``lax``
reference that the CPU tests pin:

  * flank DP — :func:`align_rows` runs the anti-diagonal forward
    (``strique_wave_fwd``, the output of ``ops.align.align_diag``) and the
    one-thread-per-row traceback (``strique_traceback``, the walk of
    ``ops.align.traceback_pointers(packed="diag")``);
  * Viterbi — :func:`viterbi_factored_batch` runs the factored forward
    and the recompute-backward of ``ops.viterbi.viterbi_scan_factored``
    in one kernel per batch (``strique_viterbi``).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..platform import CHECKOUT

SOURCE = os.path.join(CHECKOUT, "native", "strique_cuda.cu")
BUILD_DIR = os.path.join(CHECKOUT, "native", "build")
LIBRARY = os.path.join(BUILD_DIR, "libstrique_cuda.so")
ARCH = "sm_90a"
TARGETS = {"strique_wave_fwd": "StriqueWaveFwd",
           "strique_traceback": "StriqueTraceback",
           "strique_viterbi": "StriqueViterbi"}
MAX_STATES = 1024   # one thread per HMM state, one block per read
MAX_ROLLS = 32      # lane-shift taps of a factored transition
MAX_CHAINS = 4
CUDA_ROOTS = ("/usr/local/cuda",)

_state: dict = {}


def nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then ``CUDA_ROOTS``, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def build_command() -> list[str]:
    arch = ARCH.removeprefix("sm_")
    return [nvcc(), f"-gencode=arch=compute_{arch},code={ARCH}", "-std=c++17", "-O3",
            "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-o", LIBRARY, SOURCE]


def build(force: bool = False) -> float:
    """Compile the library if missing or stale; returns seconds spent (0 if fresh)."""
    fresh = (os.path.exists(LIBRARY)
             and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE))
    if fresh and not force:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run(build_command(), capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    return time.perf_counter() - t0


def load() -> dict:
    """Build (if needed), load and register the FFI targets once per process.

    Returns {"build_s": seconds spent compiling, "path": library path}.
    """
    if "lib" not in _state:
        build_s = build()
        lib = ctypes.cdll.LoadLibrary(LIBRARY)
        for name, symbol in TARGETS.items():
            jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(getattr(lib, symbol)),
                                        platform="CUDA")
        _state.update(lib=lib, build_s=build_s)
    return {"build_s": _state["build_s"], "path": LIBRARY}


def _align_attrs(params) -> dict:
    return {"dist_offset": np.float32(params.dist_offset),
            "dist_min": np.float32(params.dist_min),
            "gap_open_h": np.float32(params.gap_open_h),
            "gap_extension_h": np.float32(params.gap_extension_h),
            "gap_open_v": np.float32(params.gap_open_v),
            "gap_extension_v": np.float32(params.gap_extension_v)}


def wave_forward(signals, n_actual, tmpl_rows, m_rows, params):
    """CUDA twin of ``ops.align.align_diag``: (ptr, score, j_end)."""
    load()
    R, N = signals.shape
    mp = tmpl_rows.shape[1]
    if mp % 128 or mp > 2048:
        raise ValueError(f"template rows padded to {mp}; need a multiple of 128 up to 2048")
    nd8 = -(-(N + mp) // 8)
    out_types = (jax.ShapeDtypeStruct((nd8, R, mp), jnp.int32),
                 jax.ShapeDtypeStruct((R,), jnp.float32),
                 jax.ShapeDtypeStruct((R,), jnp.int32))
    return jax.ffi.ffi_call("strique_wave_fwd", out_types)(
        signals.astype(jnp.float32), tmpl_rows.astype(jnp.float32),
        n_actual.astype(jnp.int32), m_rows.astype(jnp.int32), **_align_attrs(params))


def traceback(ptr, j_end, m_rows, m_max: int):
    """CUDA twin of ``ops.align.traceback_diag``: one thread per row."""
    load()
    R = ptr.shape[1]
    out_types = (jax.ShapeDtypeStruct((R, m_max), jnp.uint8),
                 jax.ShapeDtypeStruct((R, m_max), jnp.int32),
                 jax.ShapeDtypeStruct((R,), jnp.int32))
    is_gap, jpos, j_begin = jax.ffi.ffi_call("strique_traceback", out_types)(
        ptr, j_end.astype(jnp.int32), m_rows.astype(jnp.int32))
    return {"is_gap": is_gap != 0, "jpos": jpos, "j_begin": j_begin}


def align_rows(signals, n_actual, tmpl_rows, m_rows, params, m_max: int) -> dict:
    ptr, score, j_end = wave_forward(signals, n_actual, tmpl_rows, m_rows, params)
    return {"score": score, "j_end": j_end, **traceback(ptr, j_end, m_rows, m_max)}


def factored_program(spec) -> np.ndarray:
    """Encode a ``stage_factored`` spec for the kernel.

    Layout: [n_diag, n_chain, (n_entry, n_exit) per chain, diagonal
    offsets, then per chain its entry offsets and exit offsets].  The
    weight rows follow ``stage_factored``'s order (diagonals, then per
    chain: entries, ramp, exits).
    """
    diag_offs, chain_spec = spec
    n_rolls = len(diag_offs) + sum(len(e) + len(x) for e, x in chain_spec)
    if n_rolls > MAX_ROLLS or len(chain_spec) > MAX_CHAINS:
        raise ValueError(f"factored HMM has {n_rolls} taps / {len(chain_spec)} chains; "
                         f"the kernel takes at most {MAX_ROLLS} / {MAX_CHAINS}")
    prog = [len(diag_offs), len(chain_spec)]
    for e, x in chain_spec:
        prog += [len(e), len(x)]
    prog += list(diag_offs)
    for e, x in chain_spec:
        prog += list(e) + list(x)
    return np.asarray(prog, np.int32)


def viterbi_factored_batch(obs, t_actual, chm_dev, spec, weights):
    """CUDA twin of ``ops.viterbi.viterbi_scan_factored_batch``: (logp, path)."""
    load()
    log_start, log_trans, log_end, mu, sigma, is_uniform, log_uni = chm_dev
    B, T = obs.shape
    S = log_start.shape[0]
    if S > MAX_STATES:
        raise ValueError(f"HMM has {S} states; the Viterbi kernel takes at most {MAX_STATES}")
    out_types = (jax.ShapeDtypeStruct((B,), jnp.float32),
                 jax.ShapeDtypeStruct((B, T), jnp.int32),
                 jax.ShapeDtypeStruct((B, T, S), jnp.float32))
    logp, path, _rows = jax.ffi.ffi_call("strique_viterbi", out_types)(
        obs.astype(jnp.float32), t_actual.astype(jnp.int32),
        log_start.astype(jnp.float32), log_end.astype(jnp.float32),
        mu.astype(jnp.float32), sigma.astype(jnp.float32),
        is_uniform.astype(jnp.int32), log_uni.astype(jnp.float32),
        jnp.stack([w.astype(jnp.float32) for w in weights]),
        jnp.asarray(factored_program(spec)),
        jnp.transpose(log_trans.astype(jnp.float32)),
        log2pi_half=np.float32(-0.5 * float(np.log(2.0 * np.pi))))
    return logp, path


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Build the CUDA kernel library")
    ap.add_argument("--force", action="store_true", help="rebuild even if fresh")
    args = ap.parse_args(argv)
    print(" ".join(build_command()))
    print(f"built in {build(force=args.force):.1f}s -> {LIBRARY}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
