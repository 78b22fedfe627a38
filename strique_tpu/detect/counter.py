"""Per-target repeat detection engine.

Equivalent of the reference ``repeatCounter``
(reference scripts/STRique.py:505-618): host-side preprocessing
(median filter, morphology, normalization scalars — exact float64
NumPy), device-side DP kernels (flank alignment + HMM Viterbi) over
padded, bucketed tensors so every shape is static under jit.

The device side runs as ONE fused dispatch per batch — alignment of
both flanks, traceback, segment bounds, QC gate, repeat-segment roll,
Viterbi decode and result packing — costing a single packed D2H.  With a
``jax.sharding.Mesh`` the identical pipeline runs under ``shard_map``
over the mesh's ``data`` axis: reads shard across chips, model tensors
replicate, and per-read results are independent, so multi-chip output is
bitwise identical to single-device (the device-mesh replacement for the
reference's fork-based worker pool, scripts/STRique.py:733-830).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..hmm.models import build_flanked_repeat, build_repeat_mod
from ..ops import align as align_ops
from ..ops import signal as signal_ops
from ..ops import viterbi as viterbi_ops
from ..ops.reference import AlignParams
from ..pore_model import PoreModel, mean_abs_dev
from ..utils.logging import LogLevel, log
from .packed import path_itemsize, unpack_results

DEFAULT_ALIGN_CONFIG = {
    # reference scripts/STRique.py:507-513
    "dist_offset": 16.0,
    "dist_min": 0.0,
    "gap_open_h": -1.0,
    "gap_open_v": -16.0,
    "gap_extension_h": -1.0,
    "gap_extension_v": -16.0,
    "samples": 6,
}

_COMPLEMENT = str.maketrans("ACGT", "TGCA")


_LUT_LEVELS = 256

# uint16 path packing bounds the fused tail; beyond this (never for real
# repeat HMMs) the two-phase host-bounds path takes over
MAX_FUSED_STATES = 65536


def _buf_bytes(npad: int) -> int:
    """Byte-packed upload row size: [flt f32 | LUT f32 | morph u8]."""
    return 4 * npad + 4 * _LUT_LEVELS + npad


def _unpack_upload(buf):
    """Byte buffer (B, _buf_bytes(npad)) -> (morph, flt) device channels.

    morph is floor-quantized to 0..255 by construction, so it ships as
    uint8 bins plus a per-read f32 level table — bit-exact at a quarter
    of the bytes; flt is continuous and ships as raw f32 bytes.
    """
    import jax
    import jax.numpy as jnp

    B = buf.shape[0]
    npad = (buf.shape[1] - 4 * _LUT_LEVELS) // 5
    flt = jax.lax.bitcast_convert_type(
        buf[:, : 4 * npad].reshape(B, npad, 4), jnp.float32)
    lut = jax.lax.bitcast_convert_type(
        buf[:, 4 * npad : 4 * npad + 4 * _LUT_LEVELS].reshape(B, _LUT_LEVELS, 4),
        jnp.float32)
    idx = buf[:, 4 * npad + 4 * _LUT_LEVELS :].astype(jnp.int32)
    morph = jnp.take_along_axis(lut, idx, axis=1)
    return morph, flt


def _morph_buf_bytes(npad: int) -> int:
    """Morph-only upload row size: [LUT f32 | morph u8] — 1 byte/sample.

    The split pipeline's phase-1 upload: the flt channel stays on host
    (Viterbi only ever consumes the short repeat segment, so shipping
    full-length float32 flt — 80% of the fused buffer's bytes — is
    wasted transfer on long reads).
    """
    return 4 * _LUT_LEVELS + npad


def _unpack_morph_upload(buf):
    """Byte buffer (B, _morph_buf_bytes(npad)) -> morph device channel."""
    import jax
    import jax.numpy as jnp

    B = buf.shape[0]
    lut = jax.lax.bitcast_convert_type(
        buf[:, : 4 * _LUT_LEVELS].reshape(B, _LUT_LEVELS, 4), jnp.float32)
    idx = buf[:, 4 * _LUT_LEVELS :].astype(jnp.int32)
    return jnp.take_along_axis(lut, idx, axis=1)


def reverse_complement(sequence: str) -> str:
    return sequence.upper().translate(_COMPLEMENT)[::-1]


def pad_bucket(n: int, minimum: int = 2048) -> int:
    """Static-shape bucket for a dynamic length: {1, 1.25, 1.5, 1.75} x 2^k grid."""
    n = max(int(n), minimum)
    k = int(np.floor(np.log2(n)))
    base = 1 << k
    for frac in (1.0, 1.25, 1.5, 1.75, 2.0):
        if n <= base * frac:
            return int(base * frac)
    return base * 2


# the bucket grid's rounding steps (signal columns, then time steps): kept
# as they were when kernels needed them, so the compiled shape set and
# every result stay the same
BUCKET_COLUMNS = 128
BUCKET_STEPS = 512


def signal_bucket(n: int) -> int:
    """The padded signal length a read of ``n`` samples compiles under.

    Single source of truth for the jit-bucket grid: the pad_bucket grid
    rounded up to multiples of ``BUCKET_COLUMNS`` and ``BUCKET_STEPS``.
    Streaming schedulers group reads by this value so every group hits
    an existing compiled pipeline.
    """
    npad = pad_bucket(int(n))
    npad = (npad + BUCKET_COLUMNS - 1) // BUCKET_COLUMNS * BUCKET_COLUMNS
    return (npad + BUCKET_STEPS - 1) // BUCKET_STEPS * BUCKET_STEPS


@dataclass
class TargetClassifier:
    """Per-strand detection assets (reference STRique.py:532, 561-575)."""

    prefix: np.ndarray  # core flank template signals
    suffix: np.ndarray
    prefix_ext: np.ndarray  # extended flank template signals
    suffix_ext: np.ndarray
    repeat_hmm: object  # CompiledHMM
    mod_hmm: object | None


def _with_init_lock(fn):
    """Serialize a cache-building method on the counter's re-entrant lock.

    The scheduler's async-submit thread and a main-thread per-read retry
    can hit a cold pipeline cache concurrently; the lock makes the
    check-build-store atomic (cache hits pay one uncontended acquire).
    """
    def wrapped(self, *args, **kwargs):
        with self._init_lock:
            return fn(self, *args, **kwargs)
    wrapped.__name__ = fn.__name__
    wrapped.__doc__ = fn.__doc__
    return wrapped


class RepeatCounter:
    def __init__(self, model_file: str, mod_model_file: str | None = None,
                 align_config: dict | None = None, hmm_config: dict | None = None,
                 mesh=None):
        """``mesh``: optional jax.sharding.Mesh with a 'data' axis — read
        batches shard across its devices (multi-chip data parallelism)."""
        cfg = dict(DEFAULT_ALIGN_CONFIG)
        if align_config:
            cfg.update(align_config)
        self.align_params = AlignParams(
            dist_offset=cfg["dist_offset"], dist_min=cfg["dist_min"],
            gap_open_h=cfg["gap_open_h"], gap_open_v=cfg["gap_open_v"],
            gap_extension_h=cfg["gap_extension_h"], gap_extension_v=cfg["gap_extension_v"],
        )
        self.samples = int(cfg["samples"])
        self.pm = PoreModel(model_file)
        self.pm_mod = PoreModel(mod_model_file) if mod_model_file else self.pm
        self.has_mod = mod_model_file is not None
        self.hmm_config = hmm_config
        self.targets: dict[str, tuple[TargetClassifier, TargetClassifier]] = {}
        self.mesh = mesh
        # fused: bounds + segment gather + Viterbi run device-side in the
        # align dispatch (one packed D2H per batch), single-device and
        # mesh-sharded alike; flip off to use the two-phase host-bounds path
        self.fused = True
        # split: three-phase pipeline — align on the 1-byte/sample morph
        # upload with device-side bounds (40-byte/read D2H), then Viterbi
        # on host-sliced repeat segments only.  ~4x fewer H2D bytes than
        # the fused path on realistic reads (flt f32 is 80% of the fused
        # buffer but Viterbi needs only the repeat segment); bit-identical
        # results.  Default on; STRIQUE_SPLIT=0 falls back to fused.
        import os as _os

        self.split = _os.environ.get("STRIQUE_SPLIT", "1") != "0"
        self._dev_cache: dict = {}
        self._pool = None  # lazy host-preprocessing thread pool
        # the scheduler's async-submit thread and a main-thread retry can
        # drive one counter concurrently: serialize lazy pool creation and
        # pipeline compilation (re-entrant — pipeline builders consult the
        # HMM caches while holding the lock)
        import threading

        self._init_lock = threading.RLock()

    # -- model construction ------------------------------------------------
    def add_target(self, target_name: str, repeat: str, prefix: str, suffix: str) -> None:
        """Build flank templates + HMMs for both strands (reference :553-579)."""
        if target_name in self.targets:
            raise ValueError(f"target {target_name!r} already defined")
        prefix_ext = prefix.upper()
        prefix = prefix[-50:].upper()
        suffix_ext = suffix.upper()
        suffix = suffix[:50].upper()
        repeat = repeat.upper()
        gen = lambda seq: self.pm.generate_signal(seq, samples=self.samples).astype(np.float32)
        tc_plus = TargetClassifier(
            gen(prefix), gen(suffix), gen(prefix_ext), gen(suffix_ext),
            build_flanked_repeat(repeat, prefix, suffix, self.pm, self.hmm_config),
            build_repeat_mod(repeat, self.pm, self.pm_mod, self.hmm_config) if self.has_mod else None,
        )
        rc = reverse_complement
        tc_minus = TargetClassifier(
            gen(rc(suffix)), gen(rc(prefix)), gen(rc(suffix_ext)), gen(rc(prefix_ext)),
            build_flanked_repeat(rc(repeat), rc(suffix), rc(prefix), self.pm, self.hmm_config),
            build_repeat_mod(rc(repeat), self.pm, self.pm_mod, self.hmm_config) if self.has_mod else None,
        )
        self.targets[target_name] = (tc_plus, tc_minus)

    def _device_hmm(self, chm):
        """Cache float32 device tensors for a compiled HMM."""
        import jax.numpy as jnp

        key = id(chm)
        with self._init_lock:
            if key not in self._dev_cache:
                self._dev_cache[key] = (
                    jnp.asarray(chm.log_start, jnp.float32),
                    jnp.asarray(chm.log_trans, jnp.float32),
                    jnp.asarray(chm.log_end, jnp.float32),
                    jnp.asarray(chm.mu, jnp.float32),
                    jnp.asarray(chm.sigma, jnp.float32),
                    jnp.asarray(chm.is_uniform),
                    jnp.asarray(chm.log_uni, jnp.float32),
                )
        return self._dev_cache[key]

    def _factored(self, chm):
        """Cache the factored staging of an HMM's transitions, or None."""
        key = ("factored", id(chm))
        with self._init_lock:
            if key not in self._dev_cache:
                import jax.numpy as jnp

                staged = None
                if getattr(chm, "factored", None) is not None:
                    spec, weights = viterbi_ops.stage_factored(chm.factored)
                    staged = (spec, tuple(jnp.asarray(w) for w in weights))
                self._dev_cache[key] = staged
        return self._dev_cache[key]

    def _prep_pool(self):
        """Thread pool for per-read host preprocessing (lazy, GIL-released
        ctypes work; sized to the host's cores)."""
        with self._init_lock:
            if self._pool is None:
                import os
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(max_workers=min(os.cpu_count() or 1, 8))
        return self._pool

    # -- fused device pipeline ----------------------------------------------
    @_with_init_lock
    def _pipeline(self, tc: TargetClassifier, use_buf: bool):
        """Build (and cache) the fused device pipeline for one target/strand.

        The returned jitted callable maps the uploaded batch straight to
        the packed result buffer: flank alignments -> tracebacks ->
        segment bounds + QC gate -> repeat-segment roll -> Viterbi ->
        byte packing.  Under ``self.mesh`` the whole body runs in
        ``shard_map`` over the ``data`` axis (per-read work, no
        cross-read communication), so each device runs the same kernels
        the single-device path uses.
        """
        key = ("pipeline", id(tc), use_buf)
        if key in self._dev_cache:
            return self._dev_cache[key]
        import jax

        from ..ops.bounds import segment_bounds
        from .packed import pack_results

        params = self.align_params
        t_pre = np.asarray(tc.prefix_ext, np.float32)
        t_suf = np.asarray(tc.suffix_ext, np.float32)
        trim_prefix = len(tc.prefix_ext) - len(tc.prefix)
        trim_suffix = len(tc.suffix_ext) - len(tc.suffix)
        n_states = tc.repeat_hmm.n_states
        dev = self._device_hmm(tc.repeat_hmm)
        fsw = self._factored(tc.repeat_hmm)

        def tail(morph, flt, n_sigs):
            import jax.numpy as jnp

            pre, suf = align_ops.align_fused_pair(morph, n_sigs, t_pre, t_suf, params)
            b = segment_bounds(
                {k: pre[k] for k in ("score", "is_gap", "jpos")},
                {k: suf[k] for k in ("score", "is_gap", "jpos")},
                n_sigs, trim_prefix=trim_prefix, trim_suffix=trim_suffix)
            rolled = jax.vmap(lambda x, s: jnp.roll(x, -s))(flt, b["prefix_begin"])
            _, paths = viterbi_ops.viterbi_batch(rolled, b["seg_len"], dev, fsw)
            return pack_results(b, paths, n_states)

        if use_buf:
            def body(buf, n_sigs):
                morph, flt = _unpack_upload(buf)
                return tail(morph, flt, n_sigs)
        else:
            body = tail

        if self.mesh is not None:
            from jax.sharding import PartitionSpec as P

            from ..parallel.mesh import shard_map

            nin = 2 if use_buf else 3
            fn = jax.jit(shard_map(body, self.mesh,
                                   in_specs=(P("data"),) * nin,
                                   out_specs=P("data")))
        else:
            fn = jax.jit(body)
        self._dev_cache[key] = fn
        return fn

    @_with_init_lock
    def _bounds_pipeline(self, tc: TargetClassifier):
        """Build (and cache) the phase-1 device pipeline of the split path:
        flank alignments -> tracebacks -> segment bounds + QC gate, packed
        as one (B, META_FLOATS) float32 row per read (40-byte/read D2H)."""
        key = ("bounds", id(tc))
        if key in self._dev_cache:
            return self._dev_cache[key]
        import jax

        from ..ops.bounds import segment_bounds
        from .packed import pack_meta

        params = self.align_params
        t_pre = np.asarray(tc.prefix_ext, np.float32)
        t_suf = np.asarray(tc.suffix_ext, np.float32)
        trim_prefix = len(tc.prefix_ext) - len(tc.prefix)
        trim_suffix = len(tc.suffix_ext) - len(tc.suffix)

        def body(buf, n_sigs):
            morph = _unpack_morph_upload(buf)
            pre, suf = align_ops.align_fused_pair(morph, n_sigs, t_pre, t_suf, params)
            b = segment_bounds(
                {k: pre[k] for k in ("score", "is_gap", "jpos")},
                {k: suf[k] for k in ("score", "is_gap", "jpos")},
                n_sigs, trim_prefix=trim_prefix, trim_suffix=trim_suffix)
            return pack_meta(b)

        if self.mesh is not None:
            from jax.sharding import PartitionSpec as P

            from ..parallel.mesh import shard_map

            fn = jax.jit(shard_map(body, self.mesh,
                                   in_specs=(P("data"), P("data")),
                                   out_specs=P("data")))
        else:
            fn = jax.jit(body)
        self._dev_cache[key] = fn
        return fn

    def _data_parallel_degree(self) -> int:
        return int(self.mesh.shape["data"]) if self.mesh is not None else 1

    # -- detection ---------------------------------------------------------
    def detect(self, target_name: str, raw_signal: np.ndarray, strand: str):
        """Count repeats in one read (reference ``repeatCounter.detect`` :581-616).

        Returns (n, score_prefix, score_suffix, log_p, offset, ticks, mod).
        """
        return self.detect_many(target_name, [raw_signal], strand)[0]

    def detect_many(self, target_name: str, raw_signals, strand: str):
        """Batched detection of multiple reads against one target/strand.

        Alignment runs as one batched device call; Viterbi decodes follow
        per read.
        """
        return self.detect_finish(self.detect_submit(target_name, raw_signals, strand))

    def detect_submit(self, target_name: str, raw_signals, strand: str,
                      preps=None) -> dict:
        """Phase 1: preprocessing + fused device dispatch (returns a handle).

        The packed results start copying to the host asynchronously;
        callers can submit the next batch before calling
        :meth:`detect_finish` so device compute and transfers overlap.
        ``preps``: optional per-read share tokens (dicts) — a read that
        intersects several targets preps ONCE and later batches reuse
        the cached morph/LUT/flt buffers (prep is ~85% of per-read host
        cost; the reference re-preps per target,
        scripts/STRique.py:702-704).  Prep is target- and strand-
        independent, so sharing is exact.
        """
        tc_plus, tc_minus = self.targets[target_name]
        if strand == "+":
            tc = tc_plus
        elif strand == "-":
            tc = tc_minus
        else:
            raise ValueError("strand must be + or -")
        B = len(raw_signals)
        raws = [np.asarray(r, dtype=np.float64) for r in raw_signals]
        n_sigs = np.array([len(r) for r in raws], dtype=np.int32)
        from .. import native as native_lib
        from ..ops.prep import model_const

        npad = signal_bucket(int(n_sigs.max()))
        import jax.numpy as jnp

        # the batch dimension shards over the mesh's data axis: pad to a
        # multiple of its size (dummy rows are length-1 reads, gated out).
        # Rounding to 8 as well bounds the set of compiled pipeline shapes
        # (tail batches of arbitrary size otherwise each compile fresh)
        # and matches the align/Viterbi kernels' minimum sublane width.
        import math

        dp = self._data_parallel_degree()
        step = 8 * dp // math.gcd(8, dp)
        Bp = -(-B // step) * step
        n_sigs_p = np.ones(Bp, dtype=np.int32)
        n_sigs_p[:B] = n_sigs

        fusible = self.fused and tc.repeat_hmm.n_states <= MAX_FUSED_STATES
        if self.fused and not fusible:
            log(f"Counter: repeat HMM has {tc.repeat_hmm.n_states} states "
                f"(> {MAX_FUSED_STATES}); using the two-phase host-bounds path.",
                LogLevel.Info)
        have_native = native_lib.available()
        if fusible and self.split:
            return self._split_submit(tc, raws, n_sigs, n_sigs_p, npad, Bp,
                                      have_native, preps=preps)
        morphs = None
        if fusible and have_native:
            # single-pass native preprocessing writes straight into one
            # byte-buffer upload; layout per row:
            # [flt f32 bytes | LUT f32 bytes | morph u8]
            # Reads fan out over a small thread pool: the C ABI call
            # releases the GIL and each thread writes a disjoint buffer
            # row, so prep scales with host cores.
            mc = model_const(self.pm)
            buf = np.zeros((Bp, _buf_bytes(npad)), dtype=np.uint8)

            def _prep_row(i_raw):
                i, raw = i_raw
                n = len(raw)
                row = buf[i]
                flt32 = row[: 4 * npad].view(np.float32)[:n]
                lut = row[4 * npad : 4 * npad + 4 * _LUT_LEVELS].view(np.float32)
                q = row[4 * npad + 4 * _LUT_LEVELS :][:n]
                return native_lib.preprocess_read_lut(raw, mc, flt32, q, lut)

            flts = list(self._prep_pool().map(_prep_row, enumerate(raws)))
            pipeline = self._pipeline(tc, use_buf=True)
            n_dev = jnp.asarray(n_sigs_p)

            align_ops.count_issued_cells_estimate(
                Bp, npad, len(tc.prefix_ext), len(tc.suffix_ext))
            state = {"fused": pipeline(jnp.asarray(buf), n_dev)}
            packed_dev = state["fused"]
        else:
            # host preprocessing (float64, exact scipy semantics); the
            # native C++ path is a single pass per read, NumPy otherwise
            morphs, flts = [], []
            if have_native:
                mc = model_const(self.pm)
                for morph_n, flt_n in self._prep_pool().map(
                        lambda raw: native_lib.preprocess_read(raw, mc), raws):
                    morphs.append(morph_n)
                    flts.append(flt_n)
            else:
                for raw in raws:
                    flt = signal_ops.medfilt3(raw)
                    morph = signal_ops.quantize_morph_np(flt, float(np.median(flt)), mean_abs_dev(flt))
                    morph = signal_ops.open_close_np(morph)
                    morphs.append(self.pm.normalize2model(morph, mode="minmax"))
                    flts.append(self.pm.normalize2model(flt, mode="minmax"))
            if fusible:
                both = np.zeros((2 * Bp, npad), dtype=np.float32)
                for i, m in enumerate(morphs):
                    both[i, : len(m)] = m
                for i, f in enumerate(flts):
                    both[Bp + i, : len(f)] = f
                both_dev = jnp.asarray(both)
                align_ops.count_issued_cells_estimate(
                    Bp, npad, len(tc.prefix_ext), len(tc.suffix_ext))
                packed_dev = self._pipeline(tc, use_buf=False)(
                    both_dev[:Bp], both_dev[Bp:], jnp.asarray(n_sigs_p))
                state = {"fused": packed_dev}
            else:
                morph_pad = np.zeros((Bp, npad), dtype=np.float32)
                for i, m in enumerate(morphs):
                    morph_pad[i, : len(m)] = m
                pre = align_ops.align_batch(morph_pad, n_sigs_p, tc.prefix_ext,
                                            self.align_params, mesh=self.mesh)
                suf = align_ops.align_batch(morph_pad, n_sigs_p, tc.suffix_ext,
                                            self.align_params, mesh=self.mesh)
                packed_dev = jnp.concatenate([
                    pre["score"][:, None], pre["jpos"].astype(jnp.float32), pre["is_gap"].astype(jnp.float32),
                    suf["score"][:, None], suf["jpos"].astype(jnp.float32), suf["is_gap"].astype(jnp.float32),
                ], axis=1)
                state = {"packed": packed_dev}
        if packed_dev is not None:
            try:
                packed_dev.copy_to_host_async()
            except Exception:
                pass
        state.update({"tc": tc, "raws": raws, "flts": flts, "n_sigs": n_sigs, "B": B})
        return state

    def _split_submit(self, tc, raws, n_sigs, n_sigs_p, npad, Bp,
                      have_native: bool, preps=None) -> dict:
        """Phase 1 of the split pipeline: prep + morph-only upload + align
        dispatch.  The flt channel stays on host; only the repeat segments
        (phase 2, :meth:`detect_middle`) ever ship to the device.

        ``preps``: per-read share tokens for multi-target reads — see
        :meth:`detect_submit`.  A token-hit read costs two memcpys
        (LUT + morph bytes into this batch's upload buffer) instead of
        the full native prep pass; its upload row still rides this
        batch's single H2D (a duplicated row is ~1 byte/sample ≈ 25 KB —
        noise next to the ~1 ms/read prep it replaces)."""
        import jax.numpy as jnp

        from .. import native as native_lib
        from ..ops.prep import model_const

        buf = np.zeros((Bp, _morph_buf_bytes(npad)), dtype=np.uint8)
        flt32s: list = [None] * len(raws)
        flts: list = [None] * len(raws)

        def _token(i):
            return preps[i] if preps is not None and i < len(preps) else None

        def _from_token(i, row):
            tok = _token(i)
            if tok is None or "prep" not in tok:
                return False
            lutb, qb, flt32, flt64 = tok["prep"]
            row[: 4 * _LUT_LEVELS] = np.frombuffer(lutb, np.uint8)
            row[4 * _LUT_LEVELS : 4 * _LUT_LEVELS + len(qb)] = np.frombuffer(qb, np.uint8)
            flt32s[i] = flt32
            flts[i] = flt64
            return True

        def _to_token(i, row, n):
            tok = _token(i)
            if tok is not None:
                tok["prep"] = (bytes(row[: 4 * _LUT_LEVELS]),
                               bytes(row[4 * _LUT_LEVELS : 4 * _LUT_LEVELS + n]),
                               flt32s[i], flts[i])

        if have_native:
            mc = model_const(self.pm)

            def _prep_row(i_raw):
                i, raw = i_raw
                n = len(raw)
                row = buf[i]
                if _from_token(i, row):
                    return
                lut = row[: 4 * _LUT_LEVELS].view(np.float32)
                q = row[4 * _LUT_LEVELS :][:n]
                flt32 = np.empty(n, np.float32)
                flt64 = native_lib.preprocess_read_lut(raw, mc, flt32, q, lut)
                flt32s[i] = flt32
                flts[i] = flt64
                _to_token(i, row, n)

            list(self._prep_pool().map(_prep_row, enumerate(raws)))
        else:
            for i, raw in enumerate(raws):
                row = buf[i]
                if _from_token(i, row):
                    continue
                flt = signal_ops.medfilt3(raw)
                bins = signal_ops.quantize_morph_np(
                    flt, float(np.median(flt)), mean_abs_dev(flt))
                bins = signal_ops.open_close_np(bins)
                row[4 * _LUT_LEVELS :][: len(raw)] = bins.astype(np.uint8)
                aff = self.pm.norm_params(bins, mode="minmax")
                lut64 = np.clip(np.arange(_LUT_LEVELS, dtype=np.float64)
                                * aff.scale + aff.offset, aff.lo, aff.hi)
                row[: 4 * _LUT_LEVELS].view(np.float32)[:] = lut64.astype(np.float32)
                flt_n = self.pm.normalize2model(flt, mode="minmax")
                flts[i] = flt_n
                flt32s[i] = flt_n.astype(np.float32)
                _to_token(i, row, len(raw))
        fn = self._bounds_pipeline(tc)
        align_ops.count_issued_cells_estimate(
            Bp, npad, len(tc.prefix_ext), len(tc.suffix_ext))
        bounds_dev = fn(jnp.asarray(buf), jnp.asarray(n_sigs_p))
        try:
            bounds_dev.copy_to_host_async()
        except Exception:
            pass
        return {"split": True, "bounds_dev": bounds_dev, "tc": tc,
                "raws": raws, "flts": flts, "flt32s": flt32s,
                "n_sigs": n_sigs, "B": len(raws)}

    def detect_middle(self, state: dict) -> dict:
        """Phase 2 of the split pipeline: bounds D2H + Viterbi dispatch.

        No-op on fused/two-phase states, so schedulers can call it
        unconditionally between submit and finish.  Collecting the 40-byte
        /read bounds rows is the only device wait; the Viterbi dispatch on
        the host-sliced segments returns immediately.
        """
        if not state.get("split") or "bounds" in state:
            return state
        from .packed import unpack_meta

        tc = state["tc"]
        B = state["B"]
        rows = unpack_meta(np.asarray(state["bounds_dev"])[:B])
        bounds = [(r.ok, r.score_prefix, r.score_suffix, r.prefix_begin,
                   r.prefix_end, r.suffix_begin, r.suffix_end) for r in rows]
        live = [i for i in range(B) if rows[i].ok]
        state["bounds"] = bounds
        state["live"] = live
        if live:
            segs = [state["flt32s"][i][bounds[i][3]:bounds[i][6]] for i in live]
            state["vit"] = self._viterbi_submit(tc.repeat_hmm, segs)
        return state

    def decode_bounds(self, state: dict):
        """Decode a submit handle's packed results into per-read bounds.

        Returns (bounds, paths, seg_lens): bounds[i] = (ok, score_prefix,
        score_suffix, prefix_begin, prefix_end, suffix_begin, suffix_end);
        paths/seg_lens keyed by read index for gated-in reads.  Shared by
        :meth:`detect_finish` and the parity tools so the packed layouts
        have exactly one decoder.  Cached on the state dict (the mod
        pipeline phase and finish both consume it).
        """
        if "decoded" in state:
            return state["decoded"]
        state["decoded"] = self._decode_bounds_uncached(state)
        return state["decoded"]

    def _decode_bounds_uncached(self, state: dict):
        tc = state["tc"]
        flts = state["flts"]
        n_sigs = state["n_sigs"]
        B = state["B"]
        trim_prefix = len(tc.prefix_ext) - len(tc.prefix)
        trim_suffix = len(tc.suffix_ext) - len(tc.suffix)

        bounds = []
        paths = {}
        seg_lens = {}
        if state.get("split"):
            state = self.detect_middle(state)
            bounds = state["bounds"]
            if state.get("live"):
                mat = self._viterbi_collect(state["vit"])
                for k, i in enumerate(state["live"]):
                    paths[i] = mat[k]
                    seg_lens[i] = bounds[i][6] - bounds[i][3]
            return bounds, paths, seg_lens
        if "fused" in state:
            rows = unpack_results(np.asarray(state["fused"])[:B],
                                  tc.repeat_hmm.n_states)
            for i, r in enumerate(rows):
                bounds.append((r.ok, r.score_prefix, r.score_suffix,
                               r.prefix_begin, r.prefix_end,
                               r.suffix_begin, r.suffix_end))
                if r.ok:
                    seg_lens[i] = r.seg_len
                    paths[i] = r.path
        else:
            mp_, ms_ = len(tc.prefix_ext), len(tc.suffix_ext)
            packed = np.asarray(state["packed"])[:B]
            o = 0
            pre_score = packed[:, o]; o += 1
            pre_jpos = packed[:, o : o + mp_].astype(np.int64); o += mp_
            pre_gap = packed[:, o : o + mp_] != 0.0; o += mp_
            suf_score = packed[:, o]; o += 1
            suf_jpos = packed[:, o : o + ms_].astype(np.int64); o += ms_
            suf_gap = packed[:, o : o + ms_] != 0.0

            # bounds + gate per read (host)
            for i in range(B):
                n_sig = int(n_sigs[i])
                pos_p = align_ops._nearest_positions(pre_gap[i], pre_jpos[i], n_sig)
                pos_s = align_ops._nearest_positions(suf_gap[i], suf_jpos[i], n_sig)
                span = int(pos_p[-1]) - int(pos_p[0])
                score_prefix = float(pre_score[i]) / span if span > 0 else 0.0
                span = int(pos_s[-1]) - int(pos_s[0])
                score_suffix = float(suf_score[i]) / span if span > 0 else 0.0
                prefix_begin, prefix_end = int(pos_p[trim_prefix]), int(pos_p[-1])
                suffix_begin, suffix_end = int(pos_s[0]), int(pos_s[len(pos_s) - 1 - trim_suffix])
                ok = prefix_begin < suffix_end and score_prefix > 0.0 and score_suffix > 0.0
                bounds.append((ok, score_prefix, score_suffix, prefix_begin, prefix_end,
                               suffix_begin, suffix_end))

            # batched Viterbi: one vmapped dispatch, one packed D2H for the paths
            live = [i for i in range(B) if bounds[i][0]]
            if live:
                segs = [flts[i][bounds[i][3]:bounds[i][6]].astype(np.float32) for i in live]
                all_paths = self._viterbi_batch(tc.repeat_hmm, segs)
                for k, i in enumerate(live):
                    seg_lens[i] = len(segs[k])
                    paths[i] = all_paths[k]
        return bounds, paths, seg_lens

    def detect_mod_submit(self, state: dict) -> dict:
        """Mod-model pipeline phase: dispatch the mod Viterbi early.

        No-op without a mod model, so schedulers can call it
        unconditionally between :meth:`detect_middle` and
        :meth:`detect_finish`.  With one, this collects the main decode,
        extracts the per-read repeat-unit signals (host prep fanned out
        over the thread pool), dispatches the mod Viterbi, and builds
        the non-mod result fields while it runs — the mod decode of
        batch k then overlaps the alignment of batch k+2 instead of
        costing a serial post-batch device round-trip (the reference
        runs its mod HMM inline per read, scripts/STRique.py:605-609).
        """
        tc = state["tc"]
        if "modsub" in state or tc.mod_hmm is None or not self.has_mod:
            return state
        raws = state["raws"]
        flts = state["flts"]
        B = state["B"]
        bounds, paths, seg_lens = self.decode_bounds(state)
        mm = tc.mod_hmm.meta

        def _mod_input(i):
            ok, _sp, _ss, prefix_begin, _pe, _sb, suffix_end = bounds[i]
            if not ok:
                return None
            mask = viterbi_ops.repeat_sample_mask(paths[i], seg_lens[i], tc.repeat_hmm)
            nrm = self.pm.normalize2model(raws[i], mode="minmax")
            rep_signal = nrm[prefix_begin:suffix_end][mask]
            if not len(rep_signal):
                return None
            return np.clip(rep_signal, mm["model_min"], mm["model_max"]).astype(np.float32)

        rep_signals = list(self._prep_pool().map(_mod_input, range(B)))
        mod_jobs = [(i, s) for i, s in enumerate(rep_signals) if s is not None]
        handle = (self._viterbi_submit(tc.mod_hmm, [s for _, s in mod_jobs])
                  if mod_jobs else None)
        # main-result decode happens here, overlapping the mod dispatch
        results = self._main_results(state)
        state["modsub"] = (results, [(i, len(s)) for i, s in mod_jobs], handle)
        return state

    def _main_results(self, state: dict) -> list:
        """Non-mod result rows (n, scores, log_p, offset, ticks, '-')."""
        tc = state["tc"]
        flts = state["flts"]
        B = state["B"]
        bounds, paths, seg_lens = self.decode_bounds(state)
        results = []
        for i in range(B):
            ok, score_prefix, score_suffix, prefix_begin, prefix_end, suffix_begin, suffix_end = bounds[i]
            n = 0
            p = 0.0
            if ok:
                path = paths[i]
                t_seg = seg_lens[i]
                segment = flts[i][prefix_begin:suffix_end]
                n = viterbi_ops.count_repeats(path, t_seg, tc.repeat_hmm)
                p = viterbi_ops.path_logp_f64(segment, path, tc.repeat_hmm)
            results.append([n, score_prefix, score_suffix, p, prefix_end,
                            max(suffix_begin - prefix_end, 0), "-"])
        return results

    def detect_finish(self, state: dict):
        """Final phase: collect device results and decode on host."""
        tc = state["tc"]
        state = self.detect_mod_submit(state)  # no-op unless mod model
        if "modsub" in state:
            results, mod_info, handle = state["modsub"]
            if handle is not None:
                mpaths = self._viterbi_collect(handle)
                for k, (ri, slen) in enumerate(mod_info):
                    results[ri][6] = viterbi_ops.mod_pattern(mpaths[k], slen, tc.mod_hmm)
            return [tuple(r) for r in results]
        return [tuple(r) for r in self._main_results(state)]

    def _viterbi_batch(self, chm, segments) -> np.ndarray:
        """Decode a list of segments in one vmapped device dispatch.

        Returns the (B, Tpad) int path matrix on host (one D2H).
        """
        return self._viterbi_collect(self._viterbi_submit(chm, segments))

    def _viterbi_submit(self, chm, segments):
        """Dispatch Viterbi over a list of segments; returns a D2H handle.

        Paths are packed to u8/u16 device-side and start copying to host
        asynchronously — callers may overlap further host work before
        :meth:`_viterbi_collect`.
        """
        import jax.numpy as jnp

        lens = np.array([len(s) for s in segments], dtype=np.int32)
        B = len(segments)
        # pad rows to a multiple of 8 x the mesh's data axis (dummy rows:
        # zero obs, len 1) — the QC gate makes the live-read count vary
        # per batch, and an un-rounded batch dimension would compile a
        # fresh pipeline per distinct count
        import math

        dp = self._data_parallel_degree()
        step = 8 * dp // math.gcd(8, dp)
        Bp = -(-B // step) * step
        lens_p = np.ones(Bp, dtype=np.int32)
        lens_p[:B] = lens
        tpad = pad_bucket(int(lens.max()))
        obs = np.zeros((Bp, tpad), dtype=np.float32)
        for k, s in enumerate(segments):
            obs[k, : len(s)] = s
        fn = self._vit_pipeline(chm)
        packed = fn(jnp.asarray(obs), jnp.asarray(lens_p))
        try:
            packed.copy_to_host_async()
        except Exception:
            pass
        return {"paths": packed, "B": B, "n_states": chm.n_states}

    def _viterbi_collect(self, handle) -> np.ndarray:
        """Wait for a :meth:`_viterbi_submit` handle; (B, Tpad) int paths."""
        paths = np.asarray(handle["paths"])[: handle["B"]]
        return paths.astype(np.int32)

    @_with_init_lock
    def _vit_pipeline(self, chm):
        """Cached jitted Viterbi dispatch (mesh-sharded when configured)."""
        key = ("vitpipe", id(chm))
        if key in self._dev_cache:
            return self._dev_cache[key]
        import jax

        from .packed import path_itemsize

        dt_np = path_itemsize(chm.n_states)
        # u16 packing wraps state indices >= 65536; such HMMs (only
        # reachable through the two-phase fallback) keep int32 paths
        pack_u16 = chm.n_states <= 65536
        dev = self._device_hmm(chm)
        fsw = self._factored(chm)

        def body(obs, lens):
            import jax.numpy as jnp

            _, paths = viterbi_ops.viterbi_batch(obs, lens, dev, fsw)
            if dt_np == 1:
                return paths.astype(jnp.uint8)
            if pack_u16:
                return paths.astype(jnp.uint16)
            return paths.astype(jnp.int32)

        if self.mesh is not None:
            from jax.sharding import PartitionSpec as P

            from ..parallel.mesh import shard_map

            fn = jax.jit(shard_map(body, self.mesh,
                                   in_specs=(P("data"), P("data")),
                                   out_specs=P("data")))
        else:
            fn = jax.jit(body)
        self._dev_cache[key] = fn
        return fn
