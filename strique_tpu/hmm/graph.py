"""HMM state-graph data structure and compiler.

The reference builds its HMMs as pomegranate ``HiddenMarkovModel`` objects
and relies on pomegranate's ``bake(merge='All')`` + Cython Viterbi
(reference scripts/STRique.py:201-500).  Here the graph is plain data: a
host-side compiler normalizes transition probabilities (as bake does),
then *eliminates silent states exactly* by computing, for every pair of
emitting states, the max-probability silent-only path between them
(Viterbi/max-product semantics).  The result is a dense log-transition
matrix over emitting states only — a static tensor the device Viterbi
scans over, with no data-dependent silent-state propagation at runtime.

Eliminating silent states under max-product preserves both the optimal
emitting-state path and its log-probability, so Viterbi results match the
reference's silent-state-aware decoder.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NEG_INF = -np.inf


@dataclass
class State:
    name: str
    kind: str  # 'normal' | 'uniform' | 'silent'
    p0: float = 0.0  # mu or lo
    p1: float = 0.0  # sigma or hi


@dataclass
class CompiledHMM:
    """Dense emitting-states-only HMM ready for the Viterbi kernel."""

    names: list
    log_start: np.ndarray  # (S,)
    log_trans: np.ndarray  # (S, S)
    log_end: np.ndarray  # (S,)
    mu: np.ndarray  # (S,)
    sigma: np.ndarray  # (S,)
    is_uniform: np.ndarray  # (S,) bool
    log_uni: np.ndarray  # (S,)
    meta: dict = field(default_factory=dict)
    # structure-factored form of log_trans (hmm/factor.py), or None when
    # the graph does not decompose; kernels fall back to the dense matrix
    factored: object | None = None

    @property
    def n_states(self) -> int:
        return len(self.names)

    def emission_logp(self, x: np.ndarray) -> np.ndarray:
        """(T,) observations -> (T, S) emission log-probs (float64 host path)."""
        x = np.asarray(x, dtype=np.float64)[:, None]
        norm = -0.5 * np.log(2 * np.pi * self.sigma**2) - 0.5 * ((x - self.mu) / self.sigma) ** 2
        return np.where(self.is_uniform, self.log_uni, norm)


class HmmGraph:
    """Mutable HMM graph with a dedicated start and end node."""

    def __init__(self):
        self.states: list[State] = []
        self.edges: list[tuple[int, int, float]] = []
        self.start = self.add_silent("__start__")
        self.end = self.add_silent("__end__")

    # -- construction ------------------------------------------------------
    def add_normal(self, name: str, mu: float, sigma: float) -> int:
        self.states.append(State(name, "normal", float(mu), float(sigma)))
        return len(self.states) - 1

    def add_uniform(self, name: str, lo: float, hi: float) -> int:
        self.states.append(State(name, "uniform", float(lo), float(hi)))
        return len(self.states) - 1

    def add_silent(self, name: str) -> int:
        self.states.append(State(name, "silent"))
        return len(self.states) - 1

    def add_edge(self, u: int, v: int, p: float) -> None:
        self.edges.append((u, v, float(p)))

    # -- compilation -------------------------------------------------------
    def prepare(self):
        """Normalized edge weights + graph orderings shared by
        :meth:`compile` and the structure factorizer (hmm/factor.py).

        Returns (logw, adj, silent, silent_set, topo, emitting, e_pos):
        normalized log edge weights, adjacency, silent states (list/set),
        their topological order, and the name-sorted emitting order.
        """
        n = len(self.states)
        # out-edge normalization (pomegranate bake normalizes each state's
        # outgoing transition probabilities to sum to 1)
        out_sum = np.zeros(n)
        for u, v, p in self.edges:
            out_sum[u] += p
        logw: dict[tuple[int, int], float] = {}
        for u, v, p in self.edges:
            w = np.log(p / out_sum[u]) if p > 0 else NEG_INF
            key = (u, v)
            # parallel edges: keep max (should not occur in these models)
            logw[key] = max(logw.get(key, NEG_INF), w)

        silent = [i for i, s in enumerate(self.states) if s.kind == "silent" and i not in (self.start, self.end)]
        emitting = [i for i, s in enumerate(self.states) if s.kind != "silent"]
        # deterministic emitting order: sort by state name (the reference's
        # zero-padded state names make this the positional order, mirroring
        # pomegranate's name-sorted state table)
        emitting.sort(key=lambda i: self.states[i].name)
        e_pos = {s: k for k, s in enumerate(emitting)}

        # adjacency
        adj: dict[int, list[tuple[int, float]]] = {}
        for (u, v), w in logw.items():
            if w == NEG_INF:
                continue
            adj.setdefault(u, []).append((v, w))

        # topological order of the silent-only subgraph
        silent_set = set(silent)
        indeg = {s: 0 for s in silent}
        for (u, v), w in logw.items():
            if u in silent_set and v in silent_set and w != NEG_INF:
                indeg[v] += 1
        from collections import deque

        dq = deque([s for s in silent if indeg[s] == 0])
        topo = []
        while dq:
            s = dq.popleft()
            topo.append(s)
            for v, w in adj.get(s, []):
                if v in silent_set:
                    indeg[v] -= 1
                    if indeg[v] == 0:
                        dq.append(v)
        if len(topo) != len(silent):
            raise ValueError("silent-state subgraph contains a cycle")
        return logw, adj, silent, silent_set, topo, emitting, e_pos

    def compile(self, meta: dict | None = None) -> CompiledHMM:
        logw, adj, silent, silent_set, topo, emitting, e_pos = self.prepare()
        S = len(emitting)

        log_trans = np.full((S, S), NEG_INF)
        log_start = np.full(S, NEG_INF)
        log_end = np.full(S, NEG_INF)

        def closure_from(src: int):
            """Max-product reach of emitting states / end from ``src``."""
            best = {s: NEG_INF for s in silent}
            direct_e = np.full(S, NEG_INF)
            direct_end = NEG_INF
            for v, w in adj.get(src, []):
                if v in silent_set:
                    best[v] = max(best[v], w)
                elif v == self.end:
                    direct_end = max(direct_end, w)
                elif v != self.start:
                    direct_e[e_pos[v]] = max(direct_e[e_pos[v]], w)
            for s in topo:
                if best[s] == NEG_INF:
                    continue
                for v, w in adj.get(s, []):
                    if v in silent_set:
                        best[v] = max(best[v], best[s] + w)
                    elif v == self.end:
                        direct_end = max(direct_end, best[s] + w)
                    elif v != self.start:
                        k = e_pos[v]
                        direct_e[k] = max(direct_e[k], best[s] + w)
            return direct_e, direct_end

        row, end_w = closure_from(self.start)
        log_start = row
        # start->silent->end contributes nothing for non-empty observations
        for u in emitting:
            row, end_w = closure_from(u)
            log_trans[e_pos[u], :] = row
            log_end[e_pos[u]] = end_w

        mu = np.zeros(S)
        sigma = np.ones(S)
        is_uniform = np.zeros(S, dtype=bool)
        log_uni = np.zeros(S)
        names = []
        for i in emitting:
            st = self.states[i]
            k = e_pos[i]
            names.append(st.name)
            if st.kind == "normal":
                mu[k], sigma[k] = st.p0, st.p1
            else:
                is_uniform[k] = True
                log_uni[k] = -np.log(st.p1 - st.p0)
                mu[k], sigma[k] = 0.5 * (st.p0 + st.p1), 1.0
        chm = CompiledHMM(
            names=names,
            log_start=log_start,
            log_trans=log_trans,
            log_end=log_end,
            mu=mu,
            sigma=sigma,
            is_uniform=is_uniform,
            log_uni=log_uni,
            meta=dict(meta or {}),
        )
        from .factor import factorize

        chm.factored = factorize(self, chm)
        return chm
