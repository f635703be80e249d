"""The port's pipeline helpers against the JAX package's, in one process.

* ``pipeline_schedule`` and ``pipeline_in_flight`` give JAX's lists for
  gpipe, 1f1b and interleaved over pp in {2, 4}, n_micro in {pp, 2pp},
  v in {2, 3}; ``resolve_schedule`` follows JAX's precedence.
* ``split_stages`` and ``build_stage_specs`` give JAX's stages, feeds and
  outputs (by node name: the packages number guids apart) on
  ``tests/test_pipeline.py``'s MLP, the tiny BERT and the tiny GPT-2.
* The graph utilities (dominators, immediate (post-)dominators,
  bottlenecks, transitive reduction, union-find) agree with JAX's on
  seeded random DAGs.
* The point-to-point plan (``pair_messages``) lets every rank finish: a
  simulation of NCCL's matching — one stream a pair of ranks for both
  directions, the k-th operation of one side matching the k-th of the
  other, a receive completing only when matched, in order — driven by each
  device's projection of the global order, with receives posted early as
  ``_Pairs`` posts them, runs every schedule to its end, on chains and on
  a stage cut whose feed skips a chunk.
"""
import types

import numpy as np
import pytest

import flexflow_tpu.parallel.pipeline as jpl
import flexflow_tpu.utils.graph_utils as jgu
import flexflow_tpu_torch.parallel.pipeline as tpl
import flexflow_tpu_torch.utils.graph_utils as tgu
import torch_pipeline_pairs as pairs
from torch_pipeline_refs import jax_build

CASES = [(s, pp, n, v) for s in ("gpipe", "1f1b", "interleaved")
         for pp in (2, 4) for n in (pp, 2 * pp)
         for v in ((2, 3) if s == "interleaved" else (1,))]


@pytest.mark.parametrize("sched,pp,n,v", CASES)
def test_schedule_and_in_flight_match_jax(sched, pp, n, v):
    assert tpl.pipeline_schedule(sched, pp, n, v) == \
        jpl.pipeline_schedule(sched, pp, n, v)
    assert tpl.pipeline_in_flight(sched, pp, n, v) == \
        jpl.pipeline_in_flight(sched, pp, n, v)


@pytest.mark.parametrize("flag,vflag,searched,sv", [
    ("", 0, "", 1), ("1f1b", 0, "gpipe", 1), ("", 0, "interleaved", 3),
    ("interleaved", 0, "", 1), ("interleaved", 4, "interleaved", 3),
    ("", 5, "interleaved", 0), ("gpipe", 3, "interleaved", 3)])
def test_resolve_schedule_follows_jax_precedence(flag, vflag, searched, sv):
    config = types.SimpleNamespace(schedule=flag,
                                   pipeline_virtual_stages=vflag)
    strategy = types.SimpleNamespace(schedule=searched, virtual_stages=sv)
    assert tpl.resolve_schedule(config, strategy) == \
        jpl.resolve_schedule(config, strategy)


def _names(pcg, spec):
    """A stage spec by node name: (nodes, feeds, outputs)."""
    def feed(f):
        return ("model", pcg.nodes[f[1]].name) if f[0] == "model" else f

    nodes = [n.name for n in spec.sub_pcg.compute_nodes()]
    outs = [(pcg.nodes[g].name, i) for g, i in spec.outputs]
    return nodes, [feed(f) for f in spec.feeds], outs


@pytest.mark.parametrize("model", ["mlp", "bert", "gpt2"])
@pytest.mark.parametrize("n_stages", [2, 3, 4])
def test_split_and_stage_specs_match_jax(model, n_stages):
    tpcg = pairs.build(model).create_pcg()
    jpcg = jax_build(model).create_pcg()
    got = tpl.build_stage_specs(tpcg, tpl.split_stages(tpcg, n_stages))
    want = jpl.build_stage_specs(jpcg, jpl.split_stages(jpcg, n_stages))
    assert [_names(tpcg, s) for s in got] == [_names(jpcg, s) for s in want]


def _random_dag(seed: int, n: int = 14):
    rng = np.random.default_rng(seed)
    edges = [(int(u), int(v)) for v in range(1, n)
             for u in rng.choice(v, size=min(v, int(rng.integers(1, 3))),
                                 replace=False)]
    return (tgu.BasicGraph(range(n), edges), jgu.BasicGraph(range(n), edges),
            edges)


@pytest.mark.parametrize("seed", range(6))
def test_graph_utils_match_jax(seed):
    tg, jg, edges = _random_dag(seed)
    assert tgu.dominators(tg) == jgu.dominators(jg)
    assert tgu.post_dominators(tg) == jgu.post_dominators(jg)
    assert tgu.imm_dominators(tg) == jgu.imm_dominators(jg)
    assert tgu.imm_post_dominators(tg) == jgu.imm_post_dominators(jg)
    assert tgu.find_bottlenecks(tg) == jgu.find_bottlenecks(jg)
    tr, jr = tgu.transitive_reduction(tg), jgu.transitive_reduction(jg)
    assert {(u, v) for u in tr.nodes for v in tr.out_edges(u)} == \
        {(u, v) for u in jr.nodes for v in jr.out_edges(u)}
    ts, js = tgu.DisjointSet(), jgu.DisjointSet()
    for u, v in edges[::3]:
        ts.union(u, v)
        js.union(u, v)
    assert sorted(map(sorted, ts.groups())) == \
        sorted(map(sorted, js.groups()))
    assert all(ts.same(u, v) == js.same(u, v) for u, v in edges)


def simulate(order, specs, chunk_dev, grad_out, pp):
    """Run every device's projection of ``order`` against NCCL's pair
    matching (module doc); returns the events each device finished."""
    plan = tpl.pair_messages(order, specs, chunk_dev, grad_out)
    cons = tpl.consumers_of(specs)
    last = len(specs) - 1

    def ends(msg):
        a, b = chunk_dev[msg[2]], chunk_dev[msg[4]]
        return (a, b) if msg[0] == "A" else (b, a)

    # per device and pair: the ops issued so far, in order
    issued = {(d, p): [] for p in range(pp) for d in range(pp)}
    cursor = {(d, p): 0 for p in range(pp) for d in range(pp)}

    def seq(d, p):
        return plan.get((min(d, p), max(d, p)), [])

    def issue_upto(d, p, msg, include):
        s = seq(d, p)
        while cursor[(d, p)] < len(s):
            k = s[cursor[(d, p)]]
            if k == msg and not include:
                return
            assert k == msg or ends(k)[0] != d, "a send was skipped"
            issued[(d, p)].append(k)
            cursor[(d, p)] += 1
            if k == msg:
                return

    def matched(d, p, msg):
        """Is ``msg`` complete on device d's stream to p? Every op up to
        it issued on both sides (a stream completes in order)."""
        i = seq(d, p).index(msg)
        return len(issued[(d, p)]) > i and len(issued[(p, d)]) > i

    def needs(d, t):
        phase, m, c = t
        out = []
        if phase == "F":
            out = [("A", m, f[1], f[2], c) for f in specs[c].feeds
                   if f[0] == "stage" and chunk_dev[f[1]] != d]
        elif c < last:
            out = [("C", m, c, pos, dc)
                   for pos in range(len(specs[c].outputs))
                   for dc in cons.get((c, pos), ())
                   if chunk_dev[dc] != d and grad_out[(c, pos)]]
        return out

    def makes(d, t):
        phase, m, c = t
        if phase == "F" and c < last:
            return [("A", m, c, pos, dc)
                    for pos in range(len(specs[c].outputs))
                    for dc in cons.get((c, pos), ())
                    if chunk_dev[dc] != d]
        if phase == "B":
            return [("C", m, f[1], f[2], c) for f in specs[c].feeds
                    if f[0] == "stage" and chunk_dev[f[1]] != d
                    and grad_out[(f[1], f[2])]]
        return []

    local = [[t for t in order if chunk_dev[t[2]] == d] for d in range(pp)]
    at = [0] * pp
    while any(at[d] < len(local[d]) for d in range(pp)):
        progressed = False
        for d in range(pp):
            while at[d] < len(local[d]):
                t = local[d][at[d]]
                want = needs(d, t)
                for msg in want:  # post the receive, and those before it
                    p = ends(msg)[0]
                    if msg not in issued[(d, p)]:
                        issue_upto(d, p, msg, include=True)
                if not all(matched(d, ends(msg)[0], msg) for msg in want):
                    break  # the host waits on a receive
                for msg in makes(d, t):
                    issue_upto(d, ends(msg)[1], msg, include=True)
                at[d] += 1
                progressed = True
        if not progressed:
            raise AssertionError(f"deadlock at {at}")
    return at


def _skip_specs(n_chunks):
    pcg = pairs.build("skip").create_pcg()
    specs = tpl.build_stage_specs(pcg, tpl.split_stages(pcg, n_chunks))
    return specs, {(c, p): True for c, s in enumerate(specs)
                   for p in range(len(s.outputs))}


def _chain_specs(n_chunks):
    pcg = pairs.build("bert").create_pcg()
    specs = tpl.build_stage_specs(pcg, tpl.split_stages(pcg, n_chunks))
    return specs, {(c, p): True for c, s in enumerate(specs)
                   for p in range(len(s.outputs))}


@pytest.mark.parametrize("kind", ["chain", "skip"])
@pytest.mark.parametrize("sched,pp,n,v", [c for c in CASES
                                          if c[1] * c[3] <= 8])
def test_pair_messages_never_deadlock(kind, sched, pp, n, v):
    n_chunks = pp * v
    specs, grad_out = (_chain_specs if kind == "chain" else _skip_specs)(
        n_chunks)
    order = tpl.pipeline_schedule(sched, pp, n, v)
    chunk_dev = [c % pp for c in range(n_chunks)]
    done = simulate(order, specs, chunk_dev, grad_out, pp)
    assert sum(done) == len(order)
    if kind == "skip" and n_chunks == 4:
        assert any(f[0] == "stage" and c - f[1] >= 2
                   for c, s in enumerate(specs) for f in s.feeds)
