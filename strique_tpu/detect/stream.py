"""Bucket-stream scheduler: full, shape-homogeneous device batches from a
ragged read stream.

The reference's dispatcher (reference scripts/STRique.py:733-830) hands
each worker one read at a time, so batching is not its concern.  Here a
device batch is only efficient when it is (a) full and (b) shape-
homogeneous — a short read grouped with a long one pads to the long
read's jit bucket and pays its full alignment cost.  Slicing the stream
into fixed windows (round-1 behavior) violates both: each window splits
by target/strand into half-empty groups of mixed lengths.

``StreamScheduler`` instead queues decoded reads by
``(target, strand, signal_bucket(len))`` and flushes a queue when it
holds a full batch, so every device invocation is a full batch of
same-bucket reads hitting an already-compiled pipeline.  Flushed
batches ride the counter's submit/finish pipeline ``depth`` deep
(device compute overlaps the host's prep of the next batch).  A global
cap bounds memory/latency: when the total queued reads exceed it, the
longest queue flushes early.  End-of-stream flushes the remainders.

Results surface through a callback in completion order — the same
unordered-collector contract as the reference (:778-802).
"""
from __future__ import annotations

import os
import sys
import traceback
from collections import deque

from ..utils.logging import LogLevel, log
from .counter import signal_bucket

def _batch_cost(bucket: int, n: int) -> float:
    """Padded DP cells of one batch of ``n`` reads at pad bucket ``bucket``.

    Batches pad to a multiple of 8 reads (RepeatCounter.detect_submit),
    and every read of a batch pays the bucket's full length, so the
    padded cell count is proportional to ceil(n / 8) * 8 * bucket.  This
    is counted from shapes alone; no per-batch time has been measured on
    the GPU yet to weigh against it.
    """
    return float(-(-int(n) // 8) * 8) * float(bucket)


def plan_merged_batches(groups: list[tuple[int, int]]) -> list[list[int]]:
    """Partition per-bucket tail groups into merged batches.

    ``groups``: (bucket, count) pairs.  Reads of a smaller bucket may pad
    up into a larger one when that beats a separate partial batch (an
    11-read 12k flush + an 8-read 14k flush is worse than one 19-read 14k
    batch).  Only bucket-ascending contiguous ranges can merge (cost is
    set by the range's max bucket).  Returns one list of original
    ``groups`` indices per merged batch; exact interval DP over the
    bucket-ascending order, O(k^2) for k buckets.
    """
    order = sorted(range(len(groups)), key=lambda i: groups[i][0])
    k = len(order)
    if k == 0:
        return []
    best = [0.0] * (k + 1)  # best[j] = min cost of covering order[:j]
    cut = [0] * (k + 1)
    for j in range(1, k + 1):
        best[j] = float("inf")
        n = 0
        for i in range(j - 1, -1, -1):  # batch = order[i:j], bucket = order[j-1]
            n += groups[order[i]][1]
            c = best[i] + _batch_cost(groups[order[j - 1]][0], n)
            if c < best[j]:
                best[j], cut[j] = c, i
    out = []
    j = k
    while j > 0:
        i = cut[j]
        out.append([order[t] for t in range(i, j)])
        j = i
    out.reverse()
    return out


class StreamScheduler:
    """Groups (target, strand, signal) submissions into full device batches.

    on_result(ctx, out) fires once per submitted read, where ``out`` is
    the counter's 7-tuple or ``None`` when that read failed.  A batch
    failure triggers a per-read retry, so a poisoned read never voids
    its batchmates (per-read fault isolation, reference STRique.py:764-768).
    """

    def __init__(self, counter, on_result, batch_size: int = 64,
                 depth: int = 2, max_queued: int | None = None):
        self.counter = counter
        self.on_result = on_result
        self.batch_size = max(int(batch_size), 1)
        self.depth = max(int(depth), 1)
        self.max_queued = max_queued if max_queued is not None else 4 * self.batch_size
        self.queues: dict[tuple, list] = {}
        self.n_queued = 0
        # staged pipeline: submitted batches await their middle phase
        # (split path: bounds D2H + Viterbi dispatch) in ``inflight``, then
        # their mod phase in ``ready``, then their finish in ``modq`` — so
        # a batch's Viterbi (and mod Viterbi) runs on device while later
        # batches are still aligning, and the host never waits on a
        # transfer it could have overlapped.  For fused/two-phase counter
        # states the middle phase is a no-op; without a mod model the mod
        # phase is too, degrading to the round-3 three-stage pipeline.
        self.inflight: deque = deque()
        self.ready: deque = deque()
        # fourth stage (mod models only; detect_mod_submit is a no-op
        # otherwise): batch k's mod Viterbi dispatches as soon as its
        # main decode lands, so it runs on device while batch k+1 aligns
        # instead of serializing inside detect_finish
        self.modq: deque = deque()
        # async submission: detect_submit (host prep + upload + align
        # dispatch) runs on a dedicated thread so later batches prep while
        # this thread blocks on an earlier batch's device results — the
        # close()-time tail of a ragged stream otherwise serializes prep
        # against the bounds/Viterbi waits.  One thread keeps submission
        # (and so device-queue) order; prep itself still fans out over the
        # counter's pool.  Created lazily on the first flush, shut down by
        # close().  STRIQUE_ASYNC_SUBMIT=0 restores inline submits.
        self._async_submit = os.environ.get("STRIQUE_ASYNC_SUBMIT", "1") != "0"
        self._submit_pool = None

    # -- submission ----------------------------------------------------------
    def add(self, ctx, target_name: str, strand: str, raw,
            prep_token: dict | None = None) -> None:
        """``prep_token``: share one dict across the add() calls of a read
        that intersects several targets — the first batch to prep it
        caches the preprocessed buffers in the token and later batches
        reuse them (counter.detect_submit ``preps``)."""
        key = (target_name, strand, signal_bucket(len(raw)))
        self.queues.setdefault(key, []).append((ctx, raw, prep_token))
        self.n_queued += 1
        if len(self.queues[key]) >= self.batch_size:
            self._flush(key)
        elif self.n_queued > self.max_queued:
            self._flush(max(self.queues, key=lambda k: len(self.queues[k])))

    def close(self) -> None:
        """Flush all partial queues (bucket-merged) and drain in-flight batches.

        Remainder queues of one (target, strand) merge across pad buckets
        when the cost model says padding short reads up to a longer
        bucket beats separate partial batches (:func:`plan_merged_batches`)
        — the end-of-stream tail of a ragged run is otherwise all partial
        flushes.
        """
        by_ts: dict[tuple, list] = {}
        for (target_name, strand, bucket) in self.queues:
            by_ts.setdefault((target_name, strand), []).append(bucket)
        for (target_name, strand), buckets in sorted(
                by_ts.items(), key=lambda kv: -sum(len(self.queues[(*kv[0], b)]) for b in kv[1])):
            keys = [(target_name, strand, b) for b in sorted(buckets)]
            groups = [(b, len(self.queues[(target_name, strand, b)])) for b in sorted(buckets)]
            for batch_idxs in plan_merged_batches(groups):
                items = []
                for gi in batch_idxs:
                    items.extend(self.queues.pop(keys[gi]))
                self.n_queued -= len(items)
                self._submit(target_name, strand, items)
        while self.inflight:
            self._advance_one()
        while self.ready:
            self._mod_one()
        while self.modq:
            self._drain_one()
        if self._submit_pool is not None:
            self._submit_pool.shutdown(wait=True)
            self._submit_pool = None

    # -- internals -----------------------------------------------------------
    def _flush(self, key) -> None:
        target_name, strand, _bucket = key
        items = self.queues.pop(key)
        self.n_queued -= len(items)
        self._submit(target_name, strand, items)

    def _submit(self, target_name: str, strand: str, items: list) -> None:
        raws = [it[1] for it in items]
        toks = [it[2] for it in items]
        preps = toks if any(t is not None for t in toks) else None
        if self._async_submit:
            if self._submit_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._submit_pool = ThreadPoolExecutor(max_workers=1)
            state = self._submit_pool.submit(
                self.counter.detect_submit, target_name, raws, strand, preps)
        else:
            try:
                state = self.counter.detect_submit(target_name, raws, strand,
                                                   preps=preps)
            except KeyboardInterrupt:
                raise
            except Exception:
                log("Factory: Unexpected error in batch submit, retrying reads "
                    "individually.\n"
                    + "".join(traceback.format_exception(*sys.exc_info())), LogLevel.Warning)
                state = None
        self.inflight.append((target_name, strand, items, state))
        while len(self.inflight) > self.depth:
            self._advance_one()
        while len(self.ready) > self.depth:
            self._mod_one()
        while len(self.modq) > self.depth:
            self._drain_one()

    def _advance_one(self) -> None:
        target_name, strand, items, state = self.inflight.popleft()
        if state is not None:
            try:
                if hasattr(state, "result"):  # async submit future
                    state = state.result()
                state = self.counter.detect_middle(state)
            except KeyboardInterrupt:
                raise
            except Exception:
                log("Factory: Unexpected error in batch bounds phase, retrying "
                    "reads individually.\n"
                    + "".join(traceback.format_exception(*sys.exc_info())), LogLevel.Warning)
                state = None
        self.ready.append((target_name, strand, items, state))

    def _mod_one(self) -> None:
        target_name, strand, items, state = self.ready.popleft()
        if state is not None:
            try:
                state = self.counter.detect_mod_submit(state)
            except KeyboardInterrupt:
                raise
            except Exception:
                log("Factory: Unexpected error in batch mod phase, retrying "
                    "reads individually.\n"
                    + "".join(traceback.format_exception(*sys.exc_info())), LogLevel.Warning)
                state = None
        self.modq.append((target_name, strand, items, state))

    def _drain_one(self) -> None:
        target_name, strand, items, state = self.modq.popleft()
        outs = None
        if state is not None:
            try:
                outs = self.counter.detect_finish(state)
            except KeyboardInterrupt:
                raise
            except Exception:
                log("Factory: Unexpected error in batch, retrying reads "
                    "individually.\n"
                    + "".join(traceback.format_exception(*sys.exc_info())), LogLevel.Warning)
        if outs is not None:
            for i, it in enumerate(items):
                self.on_result(it[0], outs[i])
            return
        # per-read retry: one poisoned read costs only itself, matching the
        # reference's fault-isolation contract (scripts/STRique.py:764-768)
        for ctx, raw, _tok in items:
            out = None
            try:
                out = self.counter.detect(target_name, raw, strand)
            except KeyboardInterrupt:
                raise
            except Exception:
                log("Factory: Unexpected error in read retry, proceeding with "
                    "remaining reads.\n"
                    + "".join(traceback.format_exception(*sys.exc_info())), LogLevel.Warning)
            self.on_result(ctx, out)
