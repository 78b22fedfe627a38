"""Device-mesh parallelism: data-parallel reads over a 1-D mesh.

The reference's only parallelism is a fork-based worker pool over reads
(reference scripts/STRique.py:733-830).  The device equivalent is
**data parallelism**: batches of reads sharded over a ``data`` mesh axis
with ``shard_map`` — pure per-read DP, model tensors replicated, no
cross-read communication, so multi-chip output is bitwise identical to
single-device.  Multi-host runs initialize through
:func:`init_distributed` and shard reads across the pod the same way.

State (tensor) parallelism over the HMM is deliberately NOT a product
path: every supported HMM has a few hundred states, one thread block's
worth on one device (see parallel/experimental.py for the demoted
capability sketch and NOTES.md for the resolution rationale).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P  # noqa: F401 (re-exported)

try:
    from jax import shard_map as _shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map as _shard_map


def shard_map(f, mesh, in_specs, out_specs, check: bool = True):
    kwargs = dict(mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    if not check:
        # outputs replicated through collectives can't always be statically
        # inferred (e.g. values produced from all_gather across 'model')
        try:
            return _shard_map(f, check_vma=False, **kwargs)
        except TypeError:
            return _shard_map(f, check_rep=False, **kwargs)
    return _shard_map(f, **kwargs)


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Initialize multi-host JAX (idempotent); returns this process' index.

    With no arguments, initializes from the cluster environment when one
    is detectable (JAX coordinator env vars).  After initialization,
    ``make_mesh`` spans all hosts' devices and the ``data`` axis shards
    reads across them; per-host TSV shards concatenate to the final
    output exactly like the reference's unordered collector stream.

    Several processes on one machine (the coordinator at a loopback
    address) each open only their own cards: the visible GPUs split
    evenly by ``process_id`` (``local_device_ids``), so no two processes
    reserve memory on the same card.
    """
    import os

    # NB: the idempotency guard must not be jax.process_count() — that
    # call itself initializes the XLA backend, after which initialize()
    # refuses to run
    if jax.distributed.is_initialized():
        return jax.process_index()
    explicit = coordinator is not None or num_processes is not None
    env_cluster = any(os.environ.get(k) for k in (
        "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"))
    if explicit or env_cluster:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes, process_id=process_id,
                                   local_device_ids=_local_gpu_ids(
                                       coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS"),
                                       num_processes, process_id))
    return jax.process_index()


_LOOPBACK = ("localhost", "127.0.0.1", "[::1]")


def _local_gpu_ids(coordinator: str | None, num_processes: int | None,
                   process_id: int | None):
    """This process' share of the machine's GPUs, or None (every local card).

    Splits only when all processes share this machine, i.e. the
    coordinator listens on a loopback address; processes on separate
    hosts each keep all of their cards.  Counts cards without
    initializing a JAX backend (that would break
    ``jax.distributed.initialize``): CUDA_VISIBLE_DEVICES when set, else
    the /dev/nvidia<N> device nodes.
    """
    import os
    import re

    if not num_processes or num_processes <= 1 or process_id is None:
        return None
    if (coordinator or "").rpartition(":")[0] not in _LOOPBACK:
        return None
    plats = os.environ.get("JAX_PLATFORMS")
    if plats is not None and "cuda" not in plats and "gpu" not in plats:
        return None
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis:
        n = len([d for d in vis.split(",") if d.strip()])
    else:
        n = len([f for f in os.listdir("/dev") if re.fullmatch(r"nvidia\d+", f)]) \
            if os.path.isdir("/dev") else 0
    if n < num_processes:
        return None
    per = n // num_processes
    return list(range(process_id * per, (process_id + 1) * per))


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a mesh; default 1-D ``data`` axis over all devices."""
    devices = list(devices if devices is not None else jax.devices())
    if axes is None:
        axes = {"data": len(devices)}
    shape = tuple(axes.values())
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh {axes} does not match {len(devices)} devices")
    return Mesh(np.array(devices).reshape(shape), tuple(axes.keys()))


# ---------------------------------------------------------------------------
# data-parallel flank alignment
# ---------------------------------------------------------------------------

def batched_align(mesh: Mesh | None, signals, n_actual, template, params,
                  impl: str = "auto"):
    """Batched alignment sharded over the ``data`` axis.

    signals: (B, N) float32; n_actual: (B,) int32; template: (M,) float32.
    B must be divisible by the data-axis size when a mesh is given.  Each
    shard runs the production implementation (`ops.align.align_core`):
    the CUDA kernels on a GPU, the XLA scan elsewhere.
    """
    from ..ops.align import align_core

    template_np = np.asarray(template, np.float32)
    inner = lambda s, n: align_core(s, n, template_np, params, impl)
    if mesh is None:
        return inner(signals, n_actual)
    fn = shard_map(inner, mesh,
                   in_specs=(P("data"), P("data")),
                   out_specs=P("data"))
    return fn(signals, n_actual)
