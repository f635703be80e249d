"""Weights split over the data axis (ZeRO-3 / FSDP) on two gloo ranks
(``tests/torch_ckpt_pairs.py`` runs them), against the JAX package, which
takes the same ``weight_specs`` through GSPMD
(flexflow_tpu/execution/executor.py:87-101):

* one strategy JSON whose weight specs name the data axis is read by both
  packages (the port's ``--import-strategy``);
* the tiny BERT trained 2 Adam steps under it gives the JAX package's
  losses and params and the port's plain dp = 2 run's within 1e-5;
* a rank stores 1/dp of each split weight, and its Adam moments the same;
* one step's collectives: an all-gather of each split weight before its op
  and one more in its backward (the gathered copy is not saved), a
  reduce-scatter of its grad, and the flat all-reduce of the rest alone;
* the gathered copies are freed once their ops return: none of one
  step's forward gathers is alive when its backward starts;
* ``--collective-overlap on`` is bitwise the synchronous run, and
  ``--remat full`` gathers again in the recompute and gives the same run;
* ``get_params_numpy`` returns whole weights.
"""
import json
import os

import numpy as np
import pytest

import torch_ckpt_pairs as cp
import torch_dist_pairs as tp
from torch_mesh_pairs import (TOL, assert_trees_close, assert_trees_equal,
                              data)

WORLD = 2
BERT = dict(model="bert", batch=8, optimizer="adam")


def _port_pcg():
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.models.bert import BertConfig, build_bert

    c = ft.FFConfig()
    c.batch_size = 8
    ff = ft.FFModel(c, device="cpu")
    build_bert(ff, BertConfig.tiny(batch_size=8))
    return ff.create_pcg()


def _jax_run(path, weights, x, y):
    """The JAX package's fit of 2 steps under the imported strategy: (its
    strategy's weight specs by node name, params)."""
    import jax

    import flexflow_tpu as fj
    from flexflow_tpu.models.bert import BertConfig, build_bert

    c = fj.FFConfig()
    c.batch_size, c.seed = 8, 3
    c.import_strategy_file = path  # --import-strategy
    ff = fj.FFModel(c)
    build_bert(ff, BertConfig.tiny(batch_size=8))
    ff.compile(optimizer=fj.AdamOptimizer(None, alpha=1e-3),
               loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[fj.MetricsType.METRICS_ACCURACY])
    ff.params = {n: {w: jax.device_put(a, ff.params[n][w].sharding)
                     for w, a in ws.items()} for n, ws in weights.items()}
    ff.opt_state = ff.optimizer.init_state(ff.params)
    specs = {ff.pcg.nodes[g].name: dict(ns.weight_specs)
             for g, ns in ff.strategy.node_strategies.items()
             if ns.weight_specs}
    ff.fit(x, y, shuffle=False)
    params = {n: {w: np.asarray(a) for w, a in ws.items()}
              for n, ws in jax.device_get(ff.params).items()}
    return specs, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fsdp"))
    pcg = _port_pcg()
    strategy = cp.fsdp_strategy(pcg, WORLD)
    text = strategy.to_json(pcg)
    path = os.path.join(root, "fsdp.json")
    with open(path, "w") as f:
        f.write(text)
    weights = tp.build("bert", None, 8, seed=5).get_params_numpy()
    x, y = data("bert", 8, n=16)
    cases = [("fsdp", "fsdp", dict(BERT, strategy=None, import_strategy=True)),
             ("plain", "fsdp", dict(BERT, strategy="dp:2")),
             ("overlap", "fsdp", dict(BERT, strategy=None, overlap=True,
                                      import_strategy=True)),
             ("remat", "fsdp", dict(BERT, strategy=None, remat="full",
                                    import_strategy=True))]
    for name, _k, _a in cases:
        np.savez(os.path.join(root, f"{name}_in.npz"), x=x, y=y,
                 strategy=path, **tp.flat("w", weights))
    procs = cp.start(WORLD, root, cases)
    split = {(pcg.nodes[g].name, w): spec
             for g, ns in strategy.node_strategies.items()
             for w, spec in ns.weight_specs.items()}
    full = {(n, w): a.shape for n, ws in weights.items()
            for w, a in ws.items()}
    jax_specs, jax_params = _jax_run(path, weights, x, y)
    tp.finish(procs, root)
    return root, dict(text=text, split=split, full=full, jax_specs=jax_specs,
                      jax_params=jax_params)


def test_a_data_axis_strategy_json_is_read_by_both_packages(runs):
    _root, refs = runs
    assert len(refs["split"]) >= 8  # every kernel of the tiny BERT
    want = {}
    for (n, w), spec in refs["split"].items():
        want.setdefault(n, {})[w] = tuple(spec)
    got = {n: {w: tuple(s) for w, s in ws.items()}
           for n, ws in refs["jax_specs"].items()}
    assert got == want
    assert all(s[0] == "data" for s in refs["split"].values())


@pytest.mark.parametrize("ref", ["jax", "plain"])
def test_fsdp_fit_matches_the_jax_run_and_plain_dp(runs, ref):
    root, refs = runs
    plain = tp.load(root, "plain", 0)
    want = refs["jax_params"] if ref == "jax" else tp.unflat("p", plain)
    for rank in range(WORLD):
        got = tp.load(root, "fsdp", rank)
        if ref == "plain":
            np.testing.assert_allclose(got["losses"], plain["losses"], **TOL)
        assert_trees_close(want, tp.unflat("p", got), **TOL)


def test_a_rank_stores_one_over_dp_of_each_split_weight_and_moments(runs):
    root, refs = runs
    for rank in range(WORLD):
        got = tp.load(root, "fsdp", rank)
        for key in ("local", "moments"):
            shapes = {s.split(":")[0]: eval(s.split(":")[1])
                      for s in got[key]}
            assert set(shapes) == {f"{n}/{w}" for n, w in refs["full"]}
            for (n, w), full in refs["full"].items():
                want = list(full)
                if (n, w) in refs["split"]:
                    want[0] //= WORLD
                assert shapes[f"{n}/{w}"] == tuple(want), (key, n, w)


def _counts(got):
    return dict(zip((str(k) for k in got["kinds"]),
                    (int(v) for v in got["counts"])))


@pytest.mark.parametrize("name", ["fsdp", "remat"])
def test_census_gathers_scatters_and_leaves_split_grads_out_of_the_sum(
        runs, name):
    root, refs = runs
    n_split = len(refs["split"])
    rest = sum(int(np.prod(s)) for k, s in refs["full"].items()
               if k not in refs["split"])
    for rank in range(WORLD):
        got = _counts(tp.load(root, name, rank))
        # the forward's gather, and the backward's: under --remat full the
        # recompute's, every one; else of a weight autograd saved for its
        # input's grad, which it saved as the shard (the first layer's read
        # the model input and are saved by none)
        if name == "remat":
            assert got["c10d._allgather_base_"] == 2 * n_split
        else:
            assert n_split < got["c10d._allgather_base_"] < 2 * n_split
        assert got["c10d._reduce_scatter_base_"] == n_split
        reduced = tp.load(root, name, rank)["reduced"]
        assert int(reduced.sum()) == rest
    plain = tp.load(root, "plain", 0)
    assert int(plain["reduced"].sum()) == sum(
        int(np.prod(s)) for s in refs["full"].values())
    assert "c10d._reduce_scatter_base_" not in _counts(plain)


@pytest.mark.parametrize("name", ["fsdp", "overlap"])
def test_gathered_weights_are_freed_after_their_ops(runs, name):
    """Autograd keeps the shard of a gathered weight, never the gathered
    copy: by the backward's first reduce-scatter every weight the forward
    gathered has been freed (the backward gathers anew)."""
    root, refs = runs
    for rank in range(WORLD):
        got = tp.load(root, name, rank)
        assert int(got["fwd_gathers"]) == len(refs["split"])
        assert int(got["alive_at_backward"]) == 0


@pytest.mark.parametrize("name", ["overlap", "remat"])
def test_overlap_and_remat_runs_are_the_synchronous_one(runs, name):
    root, _refs = runs
    for rank in range(WORLD):
        want = tp.load(root, "fsdp", rank)
        got = tp.load(root, name, rank)
        np.testing.assert_array_equal(got["losses"], want["losses"])
        assert_trees_equal(tp.unflat("p", want), tp.unflat("p", got))


def test_get_params_numpy_is_whole(runs):
    root, refs = runs
    for rank in range(WORLD):
        got = tp.unflat("p", tp.load(root, "fsdp", rank))
        assert {(n, w): a.shape for n, ws in got.items()
                for w, a in ws.items()} == refs["full"]


def test_the_strategy_file_round_trips(runs):
    _root, refs = runs
    d = json.loads(refs["text"])
    assert d["mesh_shape"] == [WORLD] and d["data_axis"] == "data"


def test_preflight_takes_data_axis_specs_and_checks_they_divide():
    """``preflight_strategy`` accepts a spec over the data axis that
    divides its dim and names the one that does not, with the JAX
    package's message."""
    import flexflow_tpu as fj
    from flexflow_tpu.models.bert import BertConfig as JBertConfig
    from flexflow_tpu.models.bert import build_bert as jbuild
    from flexflow_tpu.parallel.strategy import Strategy as JStrategy
    from flexflow_tpu.resilience.preflight import \
        preflight_strategy as jax_preflight
    from flexflow_tpu_torch.parallel.strategy import Strategy
    from flexflow_tpu_torch.resilience.preflight import (PreflightError,
                                                         preflight_strategy)

    pcg = _port_pcg()
    jff = fj.FFModel(fj.FFConfig())
    jbuild(jff, JBertConfig.tiny(batch_size=8))
    jpcg = jff.create_pcg()
    good = cp.fsdp_strategy(pcg, 2)
    preflight_strategy(pcg, good, n_dev=2, batch_size=8)
    bad = Strategy.from_json(good.to_json(pcg), pcg)
    bad.mesh_shape = (3,)
    msgs = []
    for pre, g, s in ((preflight_strategy, pcg, bad),
                      (jax_preflight, jpcg,
                       JStrategy.from_json(bad.to_json(pcg), jpcg))):
        with pytest.raises(Exception) as e:
            pre(g, s, n_dev=3, batch_size=9)
        msgs.append(str(e.value))
    with pytest.raises(PreflightError, match="not divisible by mesh axis "
                       "'data'"):
        preflight_strategy(pcg, bad, n_dev=3, batch_size=9)
    assert msgs[0] == msgs[1]
