"""HMM compiler tests: silent-state elimination vs a direct silent-aware Viterbi."""
import numpy as np
import pytest

from strique_tpu.hmm.graph import HmmGraph
from strique_tpu.hmm.models import build_flanked_repeat, build_repeat_mod
from strique_tpu.ops.reference import viterbi_np
from strique_tpu.pore_model import PoreModel
from strique_tpu.synthetic import default_assets

MODEL = default_assets().model


def silent_aware_viterbi(g: HmmGraph, obs):
    """Brute-force Viterbi over the raw graph, propagating through silent
    states in topological order within each time step (pomegranate-style)."""
    n = len(g.states)
    out_sum = np.zeros(n)
    for u, v, p in g.edges:
        out_sum[u] += p
    logw = np.full((n, n), -np.inf)
    for u, v, p in g.edges:
        logw[u, v] = max(logw[u, v], np.log(p / out_sum[u]))
    silent = [i for i, s in enumerate(g.states) if s.kind == "silent"]
    silent_set = set(silent)
    # topo order of silent subgraph
    order = []
    indeg = {s: 0 for s in silent}
    for u in silent:
        for v in silent:
            if np.isfinite(logw[u, v]):
                indeg[v] += 1
    from collections import deque

    dq = deque([s for s in silent if indeg[s] == 0])
    while dq:
        s = dq.popleft()
        order.append(s)
        for v in silent:
            if np.isfinite(logw[s, v]):
                indeg[v] -= 1
                if indeg[v] == 0:
                    dq.append(v)

    def emit(x):
        e = np.full(n, -np.inf)
        for i, st in enumerate(g.states):
            if st.kind == "normal":
                e[i] = -0.5 * np.log(2 * np.pi * st.p1**2) - 0.5 * ((x - st.p0) / st.p1) ** 2
            elif st.kind == "uniform":
                e[i] = -np.log(st.p1 - st.p0) if st.p0 <= x <= st.p1 else -np.inf
        return e

    score = np.full(n, -np.inf)
    score[g.start] = 0.0
    for t in range(len(obs) + 1):
        # propagate through silent states
        for s in order:
            cand = score + logw[:, s]
            score[s] = max(score[s], cand.max())
        if t == len(obs):
            break
        e = emit(obs[t])
        new = np.full(n, -np.inf)
        for v in range(n):
            if g.states[v].kind == "silent":
                continue
            new[v] = (score + logw[:, v]).max() + e[v]
        score = new
    return (score + logw[:, g.end]).max()


def compiled_viterbi_logp(chm, obs):
    logp, _ = viterbi_np(obs, chm.log_start, chm.log_trans, chm.log_end,
                         chm.mu, chm.sigma, chm.is_uniform, chm.log_uni)
    return logp


def make_test_graph():
    """Small graph with silent chains, branches and an emitting loop."""
    g = HmmGraph()
    a = g.add_normal("a", 80.0, 2.0)
    b = g.add_normal("b", 100.0, 2.0)
    c = g.add_uniform("c", 60.0, 120.0)
    s1 = g.add_silent("s1")
    s2 = g.add_silent("s2")
    s3 = g.add_silent("s3")
    g.add_edge(g.start, s1, 0.7)
    g.add_edge(g.start, a, 0.3)
    g.add_edge(s1, s2, 0.5)
    g.add_edge(s1, a, 0.5)
    g.add_edge(s2, b, 1.0)
    g.add_edge(a, a, 0.3)
    g.add_edge(a, s2, 0.4)
    g.add_edge(a, b, 0.3)
    g.add_edge(b, c, 0.6)
    g.add_edge(b, s3, 0.4)
    g.add_edge(s3, a, 0.5)  # loop back through silent
    g.add_edge(s3, g.end, 0.5)
    g.add_edge(c, g.end, 0.5)
    g.add_edge(c, c, 0.5)
    return g


def test_elimination_matches_silent_aware():
    rng = np.random.default_rng(0)
    g = make_test_graph()
    chm = g.compile()
    for trial in range(5):
        obs = rng.uniform(70, 110, int(rng.integers(3, 12)))
        lp_direct = silent_aware_viterbi(make_test_graph(), obs)
        lp_comp = compiled_viterbi_logp(chm, obs)
        assert np.isclose(lp_comp, lp_direct, rtol=1e-10), f"trial {trial}"


def test_flanked_structure():
    pm = PoreModel(MODEL)
    chm = build_flanked_repeat("GGCCCC", "A" * 50, "C" * 49 + "T", pm)
    # 50bp prefix + 5 -> 50 positions (m+i); repeat ext 11 chars -> 6 (m+i) + 2 dummies;
    # suffix 6+50 chars -> 51 positions (m+i)
    assert chm.n_states == 2 * 50 + 2 * 51 + 2 * 6 + 2
    assert chm.meta["flanking_count"] == 1
    assert chm.meta["repeat_offset"] == 0
    assert chm.meta["count_states"].sum() == 2
    assert chm.meta["repeat_states"].sum() == 14
    # start reaches prefix states, plus the first repeat states through the
    # full prefix delete chain (silent path skipping the whole prefix)
    start_names = {chm.names[i] for i in np.flatnonzero(np.isfinite(chm.log_start))}
    assert {"prefix00m", "prefix00i"} <= start_names
    assert all(n.startswith("prefix") or n in ("repeat0m", "repeat0i") for n in start_names)
    # end reachable from suffix states and the repeat dummies (suffix delete chain)
    end_names = {chm.names[i] for i in np.flatnonzero(np.isfinite(chm.log_end))}
    assert all(n.startswith("suffix") or n.startswith("repeatdummy") for n in end_names)


def test_flanked_short_repeat_offset():
    pm = PoreModel(MODEL)
    chm = build_flanked_repeat("CGG", "A" * 50, "T" * 50, pm)
    # CGG with 6-mer: ext = 5 + 2 - (5 % 3) = 5 -> 8 chars, offset 8//3-1 = 1
    assert chm.meta["repeat_offset"] == 1
    assert chm.meta["flanking_count"] == 3


def test_mod_hmm_structure():
    pm = PoreModel(MODEL)
    pm_mod = PoreModel(default_assets().mod_model)
    chm = build_repeat_mod("GGCCCC", pm, pm_mod)
    assert chm.n_states == 2 * 12 + 2  # base + mod profiles + s0/e0
    assert chm.meta["anchor_states"].sum() == 2
    assert chm.meta["mod_states"].sum() == 12  # the 'mod' profile's m+i states


def test_transition_rows_are_subnormalized():
    """Each compiled row's probability mass must be <= 1 (max-elimination
    can only drop mass relative to the normalized raw graph)."""
    pm = PoreModel(MODEL)
    chm = build_flanked_repeat("GGCCCC", "A" * 50, "T" * 50, pm)
    mass = np.exp(chm.log_trans).sum(axis=1) + np.exp(chm.log_end)
    assert np.all(mass <= 1.0 + 1e-9)
    assert np.exp(chm.log_start).sum() <= 1.0 + 1e-9
