"""Multi-locus repeat detection orchestrator.

Equivalent of the reference ``repeatDetector`` (reference
scripts/STRique.py:624-705): decode SAM line, intersect configured loci,
fetch raw signal, run the counter per matching target.
"""
from __future__ import annotations

import threading
from collections import defaultdict

from ..io.fast5 import Fast5Index
from ..io.sam import decode_sam, intersect_targets
from ..utils.logging import LogLevel, log
from .counter import RepeatCounter


class RepeatDetector:
    def __init__(self, repeat_config: dict, model_file: str, fast5_index_file: str,
                 mod_model_file: str | None = None, align_config: dict | None = None,
                 hmm_config: dict | None = None, mesh=None):
        """``mesh``: optional ``jax.sharding.Mesh`` with a ``data`` axis;
        read batches shard across its devices (the multi-chip replacement
        for the reference's ``--t`` worker processes)."""
        self.counter = RepeatCounter(model_file, mod_model_file=mod_model_file,
                                     align_config=align_config, hmm_config=hmm_config,
                                     mesh=mesh)
        self.repeat_loci = defaultdict(list)
        self.repeat_config = repeat_config
        self.is_init = False
        self._init_lock = threading.Lock()
        self.f5 = Fast5Index(fast5_index_file)

    def _init_targets(self) -> None:
        """Lazy HMM construction (reference :642-646); thread-safe — the
        per-read worker pool may race on the first reads."""
        with self._init_lock:
            if self.is_init:
                return
            for target_name, (chrom, begin, end, repeat, prefix, suffix) in self.repeat_config.items():
                self.counter.add_target(target_name, repeat, prefix, suffix)
                self.repeat_loci[chrom].append((target_name, begin, end))
            self.is_init = True

    def _decode_and_fetch(self, sam_line: str):
        """SAM line -> (record, matching targets, raw signal) or None."""
        sr = decode_sam(sam_line)
        if not sr.QNAME:
            log(f"Detector: Error parsing alignment \n{sam_line}", LogLevel.Error)
            return None
        target_names = intersect_targets(sr, self.repeat_loci)
        if not target_names:
            log(f"Detector: No target for {sr.QNAME}", LogLevel.Debug)
            return None
        try:
            raw = self.f5.get_raw(sr.QNAME)
        except RuntimeError:
            raw = None
        if raw is None:
            log(f"Detector: No fast5 for ID {sr.QNAME}", LogLevel.Warning)
            return None
        log(f"Detector: Test {sr.QNAME} for targets: {','.join(target_names)}.", LogLevel.Debug)
        return sr, target_names, raw

    def decode_line(self, sam_line: str):
        """Public decode+fetch for streaming schedulers: SAM line ->
        (record, matching targets, raw signal) or None; initializes the
        HMMs on first use like every other entry point."""
        if not self.is_init:
            self._init_targets()
        return self._decode_and_fetch(sam_line)

    def detect(self, sam_line: str = ""):
        """Process one SAM line -> {'target_counts': [...]} or None
        (reference :681-705)."""
        if not self.is_init:
            self._init_targets()
        job = self._decode_and_fetch(sam_line)
        if job is None:
            return None
        sr, target_names, raw = job
        target_counts = []
        for target_name in target_names:
            result = self.counter.detect(target_name, raw, sr.strand)
            target_counts.append((sr.QNAME, target_name, sr.strand, *result))
        return {"target_counts": target_counts}

    def detect_batch(self, sam_lines, io_threads: int = 1):
        """Process a batch of SAM lines with batched device calls.

        Reads are grouped by (target, strand) so each group runs through
        the batched counter (one aligner invocation per device batch).
        Returns one {'target_counts': ...}-or-None per input line.
        """
        return self.detect_batch_finish(self.detect_batch_submit(sam_lines, io_threads))

    def detect_batch_submit(self, sam_lines, io_threads: int = 1):
        """Phase 1: decode, fetch signals, dispatch alignment per group.

        ``io_threads > 1`` parallelizes the fast5 reads.  Returns a
        handle for :meth:`detect_batch_finish`; submitting the next batch
        before finishing this one overlaps device compute with host work
        and transfers.
        """
        if not self.is_init:
            self._init_targets()
        if io_threads > 1 and len(sam_lines) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=io_threads) as pool:
                jobs = list(pool.map(self._decode_and_fetch, sam_lines))
        else:
            jobs = [self._decode_and_fetch(line) for line in sam_lines]
        per_line: list[list | None] = [None] * len(sam_lines)
        groups: dict[tuple, list] = {}
        for idx, job in enumerate(jobs):
            if job is None:
                continue
            sr, target_names, raw = job
            per_line[idx] = []
            for t in target_names:
                groups.setdefault((t, sr.strand), []).append((idx, sr.QNAME, raw))
        submitted = []
        for (target_name, strand), items in groups.items():
            state = self.counter.detect_submit(target_name, [raw for _, _, raw in items], strand)
            submitted.append((target_name, strand, items, state))
        return per_line, submitted

    def detect_batch_finish(self, handle):
        """Phase 2: collect per-group results and reassemble per line."""
        per_line, submitted = handle
        for target_name, strand, items, state in submitted:
            outs = self.counter.detect_finish(state)
            for (idx, qname, _), out in zip(items, outs):
                per_line[idx].append((qname, target_name, strand, *out))
        return [{"target_counts": tc} if tc else None for tc in per_line]
