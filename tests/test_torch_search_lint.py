"""ShardLint, ``--static-analysis strict``, ``--compgraph`` and the target
search's export, each against the JAX package.

* ``analyze_strategy`` / ``analyze_candidate`` give the JAX package's
  diagnostics (rule, severity, node, message) on the cases of
  ``tests/test_static_analysis.py``: clean dp / tp / hybrid / pipeline /
  remat plans, a dropped and a doubled reduction (the JAX chaos
  injector's edits, made by hand in the port), an explicit Reduction node
  dropped, a dropout scheduled twice (FF003), a broken remat segmentation
  (FF004), a bogus and an indivisible weight spec (FF006).
* ``--static-analysis strict`` refuses a defective plan at compile with
  ``StaticAnalysisError`` naming the rule.
* ``--compgraph`` (with ``--include-costs-dot-graph``) writes the JAX
  package's dot text, node ids aside (the packages number nodes apart).
* ``--search-num-workers 4 --export-strategy`` on one device writes the
  JAX package's JSON for the same machine (a ``--machine-model-file``).
"""
import itertools
import json
import re

import pytest

import flexflow_tpu as fj
import flexflow_tpu.parallel.pcg as jax_pcg
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.parallel.pcg as torch_pcg
from flexflow_tpu.analysis import analyze_candidate as j_candidate
from flexflow_tpu.analysis import analyze_strategy as j_analyze
from flexflow_tpu.analysis import check_remat as j_remat
from flexflow_tpu.parallel.strategies import \
    hybrid_data_tensor_strategy as j_hybrid
from flexflow_tpu.parallel.strategy import data_parallel_strategy as j_dp
from flexflow_tpu.resilience import inject_wrong_reshard
from flexflow_tpu_torch.analysis import StaticAnalysisError
from flexflow_tpu_torch.analysis import analyze_candidate as t_candidate
from flexflow_tpu_torch.analysis import analyze_strategy as t_analyze
from flexflow_tpu_torch.analysis import check_remat as t_remat
from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import op_class_for
from flexflow_tpu_torch.parallel.strategies import \
    hybrid_data_tensor_strategy as t_hybrid
from flexflow_tpu_torch.parallel.strategy import \
    data_parallel_strategy as t_dp

BATCH = 16


@pytest.fixture(autouse=True)
def _fresh_node_guids(monkeypatch):
    """Both packages number the test's graph nodes from 1: the names the
    search's rewrites make embed node guids (``reduction_<guid>``)."""
    for module in (jax_pcg, torch_pcg):
        monkeypatch.setattr(module, "_node_guid", itertools.count(1))


def _mlp3(pkg, dropout=False, odd=False, **cfg):
    c = pkg.FFConfig()
    c.batch_size = BATCH
    for k, v in cfg.items():
        setattr(c, k, v)
    ff = pkg.FFModel(c, **({"device": "cpu"} if pkg is ft else {}))
    x = ff.create_tensor((BATCH, 16), name="x")
    if odd:
        ff.dense(x, 30, name="odd")
        return ff
    t = ff.dense(x, 32, name="d1")
    t = ff.dropout(t, rate=0.5, name="drop") if dropout else ff.relu(t)
    t = ff.dense(t, 32, name="d2")
    t = ff.relu(t)
    t = ff.dense(t, 10, name="d3")
    ff.softmax(t, name="probs")
    return ff


def _diags(rep):
    return [(d.rule_id, d.severity, re.sub(r"\d+", "#", d.node),
             re.sub(r"_\d+", "_#", d.message)) for d in rep.diagnostics]


def _both(build, analyze=("strategy",), **kw):
    """Build (pcg, strategy) in each package with ``build(pkg, pcg)`` and
    compare the analyzers' diagnostics; returns the JAX report."""
    reps = {}
    for pkg in (fj, ft):
        pcg = _mlp3(pkg, **kw).create_pcg()
        s = build(pkg, pcg)
        reps[pkg] = ([t_analyze, j_analyze][pkg is fj](pcg, s),
                     [t_candidate, j_candidate][pkg is fj](pcg, s))
    assert _diags(reps[ft][0]) == _diags(reps[fj][0])
    assert _diags(reps[ft][1]) == _diags(reps[fj][1])
    assert reps[ft][0].checked == reps[fj][0].checked
    return reps[fj][0]


def _dp(pkg, pcg, n=8):
    return (j_dp if pkg is fj else t_dp)(pcg, n)


def _hyb(pkg, pcg, dp=4, tp=2):
    return (j_hybrid if pkg is fj else t_hybrid)(pcg, dp, tp)


def _d2(pcg):
    return [n for n in pcg.compute_nodes() if n.name.startswith("d2")][0]


def _drop(pkg, pcg):
    s = _hyb(pkg, pcg)
    if pkg is fj:
        inject_wrong_reshard(pcg, s, mode="drop")
    else:  # the injector's edit: strip the reducing output constraint
        s.node_strategies[_d2(pcg).guid].output_spec = None
    return s


def _dup(pkg, pcg):
    s = _hyb(pkg, pcg)
    if pkg is fj:
        inject_wrong_reshard(pcg, s, mode="duplicate")
        return s
    d2 = _d2(pcg)
    op = op_class_for(OperatorType.OP_REDUCTION)(
        f"chaos_dup_reduction_{d2.guid}",
        {"dim": 0, "degree": 2, "axes": ("model",), "chaos_factor": 2.0},
        d2.op.data_type, num_inputs=1)
    pcg.insert_node_on_edge(pcg.consumers(d2.guid)[0], 0, op)
    return s


def _explicit_then_drop(pkg, pcg):
    s = _hyb(pkg, pcg)
    d2 = _d2(pcg)
    relu = pcg.consumers(d2.guid)[0]
    cls = (fj.ops.base.op_class_for if pkg is fj else op_class_for)
    red = pcg.insert_node_on_edge(relu, 0, cls(
        (fj.ffconst.OperatorType if pkg is fj else OperatorType).OP_REDUCTION)(
        f"reduction_{d2.guid}", {"dim": 0, "degree": 2, "axes": ("model",)},
        d2.op.data_type, num_inputs=1))
    ns = s.for_node(red.guid)
    ns.output_spec = s.node_strategies[d2.guid].output_spec
    s.node_strategies[d2.guid].output_spec = None
    clean = ([t_analyze, j_analyze][pkg is fj](pcg, s))
    assert clean.ok
    # drop the Reduction node: its consumers read the partial sum
    src = red.inputs[0]
    for c in pcg.consumers(red.guid):
        cn = pcg.nodes[c]
        cn.inputs = [src if g == red.guid else (g, i) for g, i in cn.inputs]
    del pcg.nodes[red.guid]
    pcg._order.remove(red.guid)
    s.node_strategies.pop(red.guid, None)
    return s


def _pipe(pkg, pcg):
    s = _dp(pkg, pcg)
    s.pipeline = (2, 4, 4)
    return s


def _remat(level):
    def build(pkg, pcg):
        s = _dp(pkg, pcg)
        s.remat = level
        return s
    return build


def _bogus(pkg, pcg):
    s = _hyb(pkg, pcg)
    d1 = [n for n in pcg.compute_nodes() if n.name.startswith("d1")][0]
    s.node_strategies[d1.guid].weight_specs["kernel"] = (None, "bogus")
    return s


def _odd(pkg, pcg):
    s = _hyb(pkg, pcg, 2, 4)
    g = pcg.compute_nodes()[0].guid
    s.node_strategies[g].weight_specs["kernel"] = (None, "model")
    return s


@pytest.mark.parametrize("name,build,kw,rule", [
    ("dp", _dp, {}, None),
    ("tp", lambda pkg, p: _hyb(pkg, p, 1, 2), {}, None),
    ("hybrid", _hyb, {}, None),
    ("pipeline", _pipe, {}, None),
    ("remat_none", _remat("none"), {}, None),
    ("remat_selective", _remat("selective"), {}, None),
    ("remat_full", _remat("full"), {}, None),
    ("drop", _drop, {}, "FF001"),
    ("duplicate", _dup, {}, "FF001"),
    ("explicit_drop", _explicit_then_drop, {}, "FF001"),
    ("bogus_axis", _bogus, {}, "FF006"),
    ("indivisible", _odd, {"odd": True}, "FF006"),
])
def test_shardlint_matches_the_jax_package(name, build, kw, rule):
    rep = _both(build, **kw)
    if rule is None:
        assert rep.ok, rep.describe()
    else:
        assert any(d.rule_id == rule for d in rep.errors), rep.describe()


def test_ff003_and_ff004_match_the_jax_package():
    from flexflow_tpu.analysis import check_rng_streams as j_rng
    from flexflow_tpu_torch.analysis import check_rng_streams as t_rng

    got = {}
    for pkg in (fj, ft):
        pcg = _mlp3(pkg, dropout=True).create_pcg()
        drop = [n.guid for n in pcg.compute_nodes()
                if n.name.startswith("drop")][0]
        pcg._order.append(drop)
        rng = (j_rng if pkg is fj else t_rng)(pcg)
        pcg._order.pop()
        remat = j_remat if pkg is fj else t_remat
        compute = [n.guid for n in pcg.compute_nodes()]
        got[pkg] = [(d.rule_id, re.sub(r"\d+", "#", d.message))
                    for d in rng + remat(pcg, "full", segments=[compute[:-1]])
                    + remat(pcg, "full", segments=[compute[2:],
                                                   compute[:2]])]
    assert got[ft] == got[fj]
    assert {r for r, _m in got[ft]} == {"FF003", "FF004"}


def test_strict_compile_refuses_a_defective_plan():
    """A strategy_fn whose rewrite schedules the dropout twice (FF003):
    the strict compile raises before the executor exists."""
    import torch.distributed as dist

    ff = _mlp3(ft, dropout=True, static_analysis="strict")

    def broken(pcg):
        drop = [n.guid for n in pcg.compute_nodes()
                if n.name.startswith("drop")][0]
        pcg._order.append(drop)
        return t_dp(pcg, 1)

    try:
        with pytest.raises(StaticAnalysisError, match="FF003"):
            ff.compile(optimizer=ft.SGDOptimizer(ff, lr=0.05),
                       loss_type=ft.LossType.
                       LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                       strategy_fn=broken)
        assert ff.executor is None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _ids_out(text):
    ids = {}
    return re.sub(r"\bn(\d+)\b",
                  lambda m: "n" + str(ids.setdefault(m.group(1), len(ids))),
                  text)


def test_compgraph_writes_the_jax_dot_text(tmp_path):
    texts = []
    for pkg in (fj, ft):
        path = str(tmp_path / f"{pkg.__name__}.dot")
        ff = _mlp3(pkg, export_strategy_computation_graph_file=path,
                   include_costs_dot_graph=True)
        ff.compile(loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   **({"strategy_fn": lambda p: j_dp(p, 1)}
                      if pkg is fj else {}))
        with open(path) as f:
            texts.append(_ids_out(f.read()))
    assert texts[1] == texts[0] and texts[0].startswith("digraph PCG {")


def test_search_num_workers_exports_the_jax_json(tmp_path):
    machine = tmp_path / "machine.cfg"
    machine.write_text(
        "generation = h100-sxm\npeak_flops = 989e12\n"
        "hbm_bandwidth = 3.35e12\nhbm_capacity = 85899345920\n"
        "ici_bandwidth = 225e9\nici_latency = 5e-6\ntorus = 4\n"
        "dcn_bandwidth = 400e9\ndcn_latency = 10e-6\n")
    out = {}
    for pkg in (fj, ft):
        path = str(tmp_path / f"{pkg.__name__}.json")
        ff = _mlp3(pkg, search_num_workers=4, export_strategy_file=path,
                   machine_model_version=1,
                   machine_model_file=str(machine))
        ff.compile(loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        with open(path) as f:
            out[pkg] = f.read()
        if pkg is ft:
            assert ff.mesh is None  # trains on the one device there is
    assert out[ft] == out[fj]
    assert json.loads(out[ft])["mesh_shape"] in ([4, 1], [2, 2], [1, 4])
