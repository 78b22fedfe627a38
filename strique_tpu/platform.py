"""Every decision that depends on the machine the program runs on.

One module owns them, so the rest of the package asks here instead of
testing the backend itself:

  * which flank-DP and Viterbi implementation runs: the CUDA kernels of
    ``native/strique_cuda.cu`` on a GPU, the plain ``lax`` scans
    everywhere else;
  * the default read batch, derived from the device;
  * the pointer-plane memory budget of one flank-DP launch, and the
    launch width that keeps a batch inside it;
  * the persistent compile cache directory.

On a GPU a CUDA library that fails to build or load raises; nothing
falls back to the scans silently.
"""
from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_BATCH = 8

_DEFAULT_PTR_BUDGET = int(3.5 * (1 << 30))
_ptr_budget_cache: list = []


def platform() -> str:
    """The default device's platform name ("gpu", "cpu", ...)."""
    return jax.devices()[0].platform


def use_cuda() -> bool:
    """True when the hand-written CUDA kernels run (any GPU backend)."""
    return platform() == "gpu"


def align_impl() -> str:
    """Flank-DP implementation: "cuda" on a GPU, "xla" (``align_scan``) otherwise."""
    return "cuda" if use_cuda() else "xla"


def viterbi_impl() -> str:
    """Viterbi implementation: "cuda" on a GPU, "xla" (the lax scans) otherwise."""
    return "cuda" if use_cuda() else "xla"


def default_batch(devices=None) -> int:
    """Reads per device batch.

    A batch of B reads puts 2B (read, flank) rows into one flank-DP
    launch, one thread block per row, so a batch that covers every SM
    of the card needs ceil(SMs / 2) reads, rounded up to a multiple of 8.
    Devices that report no SM count (CPU) get ``CPU_BATCH``.
    """
    dev = (devices or jax.devices())[0]
    sms = getattr(dev, "core_count", None) if dev.platform == "gpu" else None
    if not sms:
        return CPU_BATCH
    reads = -(-int(sms) // 2)
    return -(-reads // 8) * 8


def ptr_budget_bytes() -> int:
    """Device-memory budget for one flank-DP launch's pointer plane.

    Priority: the STRIQUE_PTR_BUDGET_GB override (re-read per call),
    else 60% of the device's free memory at first use, else 3.5 GB when
    the backend reports no memory statistics (CPU).
    """
    env = os.environ.get("STRIQUE_PTR_BUDGET_GB")
    if env is not None:
        try:
            return int(float(env) * (1 << 30))
        except ValueError:
            pass
    if not _ptr_budget_cache:
        budget = _DEFAULT_PTR_BUDGET
        stats = jax.devices()[0].memory_stats()
        if stats:
            free = int(stats.get("bytes_limit", 0)) - int(stats.get("bytes_in_use", 0))
            if free > 0:
                budget = max(int(free * 0.6), 1 << 28)
        _ptr_budget_cache.append(budget)
    return _ptr_budget_cache[0]


def ptr_row_bytes(n_signal: int, mp: int) -> int:
    """Pointer-plane bytes of one (read, template) row: 4-bit codes over
    (n_signal + mp) anti-diagonal steps x mp template rows."""
    return -(-(n_signal + mp) // 8) * mp * 4


def launch_rows(rows: int, n_signal: int, mp: int) -> int:
    """Rows per flank-DP launch so that its pointer plane fits the budget.

    Raises ValueError when a single row exceeds it (a read too long for
    a one-pass alignment on this device).
    """
    per_row = ptr_row_bytes(n_signal, mp)
    budget = ptr_budget_bytes()
    if per_row > budget:
        raise ValueError(
            f"a {n_signal}-sample read needs a {per_row / (1 << 30):.2f} GiB "
            f"traceback plane per flank, above the {budget / (1 << 30):.2f} GiB "
            "pointer budget (STRIQUE_PTR_BUDGET_GB)")
    return max(1, min(rows, budget // per_row))


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
