"""``--fusion`` under a strategy, against the JAX package's pass
(flexflow_tpu/ops/fused.py:140-152, 264-266; flexflow_tpu/model.py:674-693):

* ``apply_fusion(pcg, strategy)`` builds the JAX package's regions — the
  same count, names, members and wiring — under data, hybrid data x
  tensor, expert and pipeline strategies: a node the strategy pins (weight
  specs, an output spec, op overrides) is never fused, and the members'
  strategy entries are dropped;
* the tiny BERT fused under dp = 2 on two gloo ranks trains 2 Adam steps
  within 1e-5 of the JAX package's fused run and of the port's unfused
  one, and so do the fused hybrid dp 1 x tp 2 run and the fused pipeline
  (pp 2, fused before the split) against their unfused twins.
"""
import os

import numpy as np
import pytest

import flexflow_tpu as fj
import flexflow_tpu_torch as ft
from flexflow_tpu.ops.fused import apply_fusion as jax_apply_fusion
from flexflow_tpu.parallel import strategies as jax_strategies
from flexflow_tpu.parallel.strategy import \
    data_parallel_strategy as jax_dp
from flexflow_tpu_torch.ops.fused import apply_fusion
from flexflow_tpu_torch.parallel import strategies as port_strategies
from flexflow_tpu_torch.parallel.strategy import \
    data_parallel_strategy as port_dp

import torch_ckpt_pairs as cp
import torch_dist_pairs as tp
from test_torch_fusion import regions
from torch_mesh_pairs import TOL, assert_trees_close, data

WORLD = 2
BERT = dict(model="bert", batch=8, optimizer="adam")


def _strategy(pkg, kind):
    dp = port_dp if pkg is ft else jax_dp
    st = port_strategies if pkg is ft else jax_strategies
    if kind == "dp":
        return lambda pcg: dp(pcg, 2)
    if kind == "hybrid":
        return lambda pcg: st.hybrid_data_tensor_strategy(pcg, dp=2, tp=2)
    if kind == "expert":
        return lambda pcg: st.expert_parallel_strategy(pcg, dp=2, ep=2)

    def pipe(pcg):
        s = dp(pcg, 4)
        s.pipeline = (2, 2, 2)
        return s
    return pipe


def _graph(pkg, kind):
    ff = pkg.FFModel(pkg.FFConfig(), device="cpu") if pkg is ft else \
        pkg.FFModel(pkg.FFConfig())
    if kind == "expert":
        from flexflow_tpu.models.transformer import build_moe_mlp as jm
        from flexflow_tpu_torch.models.transformer import build_moe_mlp as tm

        (tm if pkg is ft else jm)(ff, batch_size=16, in_dim=32,
                                  num_classes=4, num_exp=4, num_select=2,
                                  expert_hidden=16)
    else:
        from flexflow_tpu.models import bert as jb
        from flexflow_tpu_torch.models import bert as tb

        m = tb if pkg is ft else jb
        m.build_bert(ff, m.BertConfig.tiny())
    return ff.create_pcg()


@pytest.mark.parametrize("kind", ["dp", "hybrid", "expert", "pipeline"])
def test_regions_under_a_strategy_are_the_jax_packages(kind):
    got = {}
    for pkg in (ft, fj):
        pcg = _graph(pkg, kind)
        strategy = _strategy(pkg, kind)(pcg)
        barrier = (pcg.sinks()[-1].guid,)
        if pkg is ft:
            fused, n, _remap = apply_fusion(pcg, strategy,
                                            barrier_guids=barrier)
        else:
            fused, n, _remap = jax_apply_fusion(pcg, strategy,
                                                barrier_guids=barrier)
        kept = sorted(pcg.nodes[g].name if g in pcg.nodes else
                      fused.nodes[g].name
                      for g in strategy.node_strategies)
        pinned = sorted(f"{pcg.nodes[g].name}"
                        for g, ns in strategy.node_strategies.items()
                        if g in pcg.nodes and (ns.weight_specs or
                                               ns.output_spec is not None))
        got[pkg] = (n, regions(fused), kept, pinned)
    assert got[ft] == got[fj]
    n, regs, _kept, pinned = got[ft]
    assert n >= 1
    fused_members = {s[0] for r in regs for s in r[2]}
    assert not fused_members & set(pinned)
    if kind in ("hybrid", "expert"):
        assert pinned  # the split nodes stayed out of every region


def _rename(tree, names):
    """An unfused model's params under a fused model's names (``names``:
    the fused model's ``{node: [weight]}``), and back when ``names`` is
    None."""
    if names is None:
        out = {}
        for n, ws in tree.items():
            for w, a in ws.items():
                if n.startswith("fused_"):
                    _pos, node, wname = w.split(":")
                    out.setdefault(node, {})[wname] = a
                else:
                    out.setdefault(n, {})[w] = a
        return out
    out = {}
    for n, ws in names.items():
        for w in ws:
            if n.startswith("fused_"):
                _pos, node, wname = w.split(":")
                out.setdefault(n, {})[w] = tree[node][wname]
            else:
                out.setdefault(n, {})[w] = tree[n][w]
    return out


def _fused_names(key):
    """{node: [weight]} of the tiny BERT fused under the strategy ``key``
    of a two-rank world (the pass needs no mesh)."""
    pcg = _graph(ft, "bert")
    if key == "dp":
        strategy = port_dp(pcg, 2)
    elif key == "hybrid":
        strategy = port_strategies.hybrid_data_tensor_strategy(pcg, dp=1,
                                                               tp=2)
    else:
        strategy = port_dp(pcg, 2)
        strategy.pipeline = (2, 1, 2)
    fused, _n, _remap = apply_fusion(pcg, strategy,
                                     barrier_guids=(pcg.sinks()[-1].guid,))
    out = {}
    for node in fused.compute_nodes():
        ins = [fused.nodes[g].out_shapes[i] for g, i in node.inputs]
        ws = list(node.op.weight_specs(ins))
        if ws:
            out[node.name] = ws
    return out


def _jax_fused_fit(weights, x, y):
    import jax

    from flexflow_tpu.models.bert import BertConfig, build_bert

    c = fj.FFConfig()
    c.batch_size, c.seed, c.perform_fusion = 8, 3, True
    ff = fj.FFModel(c)
    build_bert(ff, BertConfig.tiny(batch_size=8))
    ff.compile(optimizer=fj.AdamOptimizer(None, alpha=1e-3),
               loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[fj.MetricsType.METRICS_ACCURACY],
               strategy_fn=lambda pcg: jax_dp(pcg, 2))
    ff.params = {n: {w: jax.device_put(a, ff.params[n][w].sharding)
                     for w, a in ws.items()} for n, ws in weights.items()}
    ff.opt_state = ff.optimizer.init_state(ff.params)
    ff.fit(x, y)
    return {n: {w: np.asarray(a) for w, a in ws.items()}
            for n, ws in jax.device_get(ff.params).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fusion_strategy"))
    weights = tp.build("bert", None, 8, seed=5).get_params_numpy()
    x, y = data("bert", 8, n=16)
    cases = []
    for strat in ("dp:2", "hybrid:1:2", "pipe:2:1"):
        key = strat.split(":")[0]
        fused_w = _rename(weights, _fused_names(key))
        if key == "dp":
            dp_fused_w = fused_w
        for fused in (True, False):
            name = f"{key}_{'fused' if fused else 'plain'}"
            np.savez(os.path.join(root, f"{name}_in.npz"), x=x, y=y,
                     **tp.flat("w", fused_w if fused else weights))
            cases.append((name, "fit", dict(BERT, strategy=strat,
                                            perform_fusion=fused)))
    procs = cp.start(WORLD, root, cases)
    jax_fused = _jax_fused_fit(dp_fused_w, x, y)
    tp.finish(procs, root)
    return root, dict(jax=jax_fused)


@pytest.mark.parametrize("case", ["dp-jax", "dp", "hybrid", "pipe"])
def test_fused_training_under_a_strategy(runs, case):
    root, refs = runs
    key = case.split("-")[0]
    for rank in range(WORLD):
        got = tp.load(root, f"{key}_fused", rank)
        fused = tp.unflat("p", got)
        assert any(n.startswith("fused_") for n in fused)
        if case == "dp-jax":
            assert_trees_close(refs["jax"], fused, **TOL)
            continue
        plain = tp.load(root, f"{key}_plain", rank)
        np.testing.assert_allclose(got["losses"], plain["losses"], **TOL)
        assert_trees_close(tp.unflat("p", plain), _rename(fused, None),
                           **TOL)
