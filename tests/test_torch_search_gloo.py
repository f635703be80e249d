"""The searched compile on four gloo ranks, against the JAX package.

The tiny BERT (batch 8) compiles with no strategy at a world size of 4, so
every rank runs the port's Unity search (``tests/torch_search_pairs.py``).
The machine is a ``--machine-model-file`` whose compute is slow and links
fast, so the search picks the hybrid mesh (2, 2), with Repartition and
Combine nodes between its sharded and replicated regions, even at this
size; sequence parallelism is off (its
attention is a later slice). The JAX package searches the same PCG on the
same machine fields (``unity_search`` in its ``strategy_fn``) and trains
one Adam step under the result on its virtual mesh. Checked:

* the ranks agree one digest, and their strategy JSON and rewritten graph
  are the JAX package's (each side numbering its graph's nodes from 1:
  the names the rewrites make embed node guids);
* the search inserted resharding nodes whose ``target_pts`` the SPMD plan
  takes as their output layout, and their forward moves the data: a
  Repartition slices the rank's shard, a Combine gathers it (the local
  output's shape is not the input's where the layout changes);
* one train step from the same weights: loss and params within 1e-5 of
  the JAX package's;
* a forced digest mismatch raises on every rank, naming rank 1, and no
  rank hangs;
* the port's default config keeps the search out of sequence-parallel
  plans, which its attention refuses until ring / Ulysses attention is
  ported: on the tiny BERT with one head the JAX search, sequence
  parallelism on (its default), shards the sequence, while the four ranks
  compiled with the port's default config train the plan the JAX package
  finds with it off, step for step.
"""
import itertools
import json

import pytest

import flexflow_tpu as fj
import flexflow_tpu.parallel.pcg as jax_pcg
from flexflow_tpu.search.machine_model import TPUMachineModel
from flexflow_tpu.search.unity import unity_search as jax_unity_search
from flexflow_tpu_torch.search.machine_model import GPUMachineModel

import torch_dist_pairs as tp
import torch_search_pairs as sp
from torch_mesh_pairs import (TOL, JaxBertConfig, assert_trees_close, data,
                              jax_build_bert, jax_step, jax_weights,
                              write_case)

WORLD = 4
# slow compute, fast links: tensor parallelism pays at the tiny size
MACHINE = ("generation = h100-sxm\npeak_flops = 1e9\n"
           "hbm_bandwidth = 1e13\nici_bandwidth = 1e12\n"
           "ici_latency = 1e-12\nmatmul_efficiency = 0.8\n"
           "hbm_efficiency = 0.5\nupdate_hbm_efficiency = 0.5\n"
           "matmul_flops_f32 = 0\n")


def _config(path):
    return dict(machine_model_version=1, machine_model_file=path,
                enable_sequence_parallel=False)


def _jax_model(path, bert, **config):
    c = fj.FFConfig()
    c.batch_size, c.seed = 8, 3
    for k, v in dict(_config(path), **config).items():
        setattr(c, k, v)
    ff = fj.FFModel(c)
    jax_build_bert(ff, bert)
    return ff, c


def _jax_searched(path, bert=None):
    ff, c = _jax_model(path, bert or JaxBertConfig.tiny(batch_size=8))
    machine = TPUMachineModel(**sp.jax_fields(
        GPUMachineModel.from_file(path, WORLD)))
    ff.compile(optimizer=fj.AdamOptimizer(None, alpha=1e-3),
               loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[fj.MetricsType.METRICS_ACCURACY],
               strategy_fn=lambda pcg: jax_unity_search(
                   pcg, c, WORLD, machine=machine,
                   protected_guids=(ff.final_guid,)))
    return ff


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("search"))
    path = f"{root}/machine.cfg"
    with open(path, "w") as f:
        f.write(MACHINE)
    x, y = data("bert", 8)
    # both sides number their graph's nodes from 1 (the ranks in
    # torch_search_pairs.fresh_guids): the rewrites' names embed guids
    one_head = JaxBertConfig(batch_size=8, **tp.BERT_1HEAD)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pcg, "_node_guid", itertools.count(1))
        jff = _jax_searched(path)
        # the JAX default, sequence parallelism on, on the one-head BERT
        jsp, c = _jax_model(path, one_head, enable_sequence_parallel=True)
        pcg = jsp.create_pcg()
        sp_json = jax_unity_search(
            pcg, c, WORLD, machine=TPUMachineModel(**sp.jax_fields(
                GPUMachineModel.from_file(path, WORLD)))).to_json(pcg)
        mp.setattr(jax_pcg, "_node_guid", itertools.count(1))
        jdef = _jax_searched(path, one_head)
    args = dict(model="bert", strategy=None, batch=8, **_config(path))
    # the port's default config: no enable_sequence_parallel set
    args_default = dict(model="bert_1head", strategy=None, batch=8,
                        machine_model_version=1, machine_model_file=path)
    cases = []
    for name, kind, model, a in (("searched", "searched", jff, args),
                                 ("mismatch", "mismatch", jff, args),
                                 ("default", "searched", jdef,
                                  args_default)):
        write_case(root, name, x, y, jax_weights(model))
        cases.append((name, kind, a))
    procs = tp.start(WORLD, root, cases, main=sp.rank_main)
    want = {}
    for name, model in (("searched", jff), ("default", jdef)):
        want[name] = jax_step(model, x, y)
        want[name]["strategy"] = model.strategy.to_json(model.pcg)
        want[name]["nodes"] = [n.name for n in model.pcg.topo_order()]
    want["sp_json"] = sp_json
    tp.finish(procs, root, timeout=240)
    return root, want


def test_ranks_agree_the_jax_search(runs):
    root, want = runs
    want = want["searched"]
    got = [tp.load(root, "searched", r) for r in range(WORLD)]
    assert len({str(g["digest"]) for g in got}) == 1
    for g in got:
        assert str(g["strategy"]) == want["strategy"]
        assert list(g["nodes"]) == want["nodes"]
    assert json.loads(want["strategy"])["mesh_shape"] == [2, 2]


def test_resharding_nodes_move_to_their_target_layout(runs):
    root, _want = runs
    rows = [str(s).split("|") for s in tp.load(root, "searched", 0)["reshard"]]
    assert rows, "the search inserted no resharding node with target_pts"
    moved = set()
    for name, spec, natural, outs, shape_in, shape_out in rows:
        if natural != outs:
            # R -> S slices the model axis's shard, S -> R gathers it
            assert shape_in != shape_out, (name, shape_in, shape_out)
            moved.add(name.split("_")[1])
        else:
            assert shape_in == shape_out, name
    assert moved == {"repartition", "combine"}, rows


def test_searched_step_matches_the_jax_package(runs):
    root, want = runs
    want = want["searched"]
    for r in range(WORLD):
        got = tp.load(root, "searched", r)
        assert abs(float(got["loss"]) - want["step_loss"]) <= 1e-5
        assert_trees_close(want["params"], tp.unflat("p", got), **TOL)


def test_a_forced_mismatch_raises_on_every_rank(runs):
    root, _want = runs
    for r in range(WORLD):
        err = str(tp.load(root, "mismatch", r)["error"])
        assert "ranks [1]" in err and "disagree" in err, (r, err)


def test_default_config_searches_no_sequence_parallel_plan(runs):
    root, want = runs
    assert "sequence_parallel_axis" in want["sp_json"]
    want = want["default"]
    assert "sequence_parallel_axis" not in want["strategy"]
    got = [tp.load(root, "default", r) for r in range(WORLD)]
    assert len({str(g["digest"]) for g in got}) == 1
    for g in got:
        assert str(g["strategy"]) == want["strategy"]
        assert list(g["nodes"]) == want["nodes"]
        assert abs(float(g["loss"]) - want["step_loss"]) <= 1e-5
        assert_trees_close(want["params"], tp.unflat("p", g), **TOL)
