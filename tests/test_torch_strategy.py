"""Strategies in the port against the JAX package, in one process:

* the strategy JSON is the same text in both packages for the same PCG,
  for ``data_parallel_strategy``, ``hybrid_data_tensor_strategy``,
  ``expert_parallel_strategy`` and ``long_context_strategy`` on the tiny
  BERT proxy and the MoE MLP, and each package imports the other's file;
  the builders write the same specs node by node;
* ``preflight_strategy`` raises the JAX package's ``PreflightError`` text
  for a table of bad plans (axis count, duplicate axes, too many devices,
  data axis, indivisible batch, hybrid factors, remat level, schedule and
  pipeline combinations, a spec naming an unknown axis or a dim its axis
  does not divide);
* the argv flow: ``--mesh-shape``, ``--import-strategy`` and
  ``--export-strategy`` compile on a mesh of one gloo rank, where a step
  gives the one-device step; the exported text is the imported one and
  the JAX package's for the same flags; ``--only-data-parallel`` in one
  process stays on the one-device path;
* a pipeline grid compiles since its slice (tests/test_torch_pipeline*.py);
  one the world cannot hold is refused by the preflight, naming the grid;
* refused by name: a strategy's ``sequence_parallel_axis`` (A.7), serving
  a model compiled on a mesh (A.8).
"""
import json

import numpy as np
import pytest
import torch.distributed as dist

import flexflow_tpu as fj
from flexflow_tpu.models.bert import BertConfig as JaxBertConfig
from flexflow_tpu.models.bert import build_bert as jax_build_bert
from flexflow_tpu.models.transformer import build_moe_mlp as jax_moe_mlp
from flexflow_tpu.parallel import strategies as jstr
from flexflow_tpu.parallel import strategy as jstrategy
from flexflow_tpu.resilience import preflight as jpre
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.bert import BertConfig, build_bert
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.models.transformer import build_moe_mlp
from flexflow_tpu_torch.parallel import strategies as tstr
from flexflow_tpu_torch.parallel import strategy as tstrategy
from flexflow_tpu_torch.resilience import preflight as tpre

LATER = "ported in a later slice"


def _pcgs(model: str):
    """(JAX pcg, port pcg) of the same tiny model."""
    out = []
    for pkg, bert, moe, cfg in ((fj, jax_build_bert, jax_moe_mlp,
                                 JaxBertConfig),
                                (ft, build_bert, build_moe_mlp, BertConfig)):
        c = pkg.FFConfig()
        c.batch_size = 8
        ff = pkg.FFModel(c) if pkg is fj else pkg.FFModel(c, device="cpu")
        if model == "bert":
            bert(ff, cfg.tiny(batch_size=8))
        else:
            moe(ff, batch_size=8, in_dim=32, num_classes=4, num_exp=4,
                num_select=2, expert_hidden=16)
        out.append(ff.create_pcg())
    return out


BUILDERS = {
    "dp": (lambda p: jstrategy.data_parallel_strategy(p, 4),
           lambda p: tstrategy.data_parallel_strategy(p, 4)),
    "hybrid": (lambda p: jstr.hybrid_data_tensor_strategy(p, 2, 2),
               lambda p: tstr.hybrid_data_tensor_strategy(p, 2, 2)),
    "expert": (lambda p: jstr.expert_parallel_strategy(p, 2, 2),
               lambda p: tstr.expert_parallel_strategy(p, 2, 2)),
    "long": (lambda p: jstr.long_context_strategy(p, 2, 2, mode="alltoall"),
             lambda p: tstr.long_context_strategy(p, 2, 2,
                                                  mode="alltoall")),
}


@pytest.mark.parametrize("model", ["bert", "moe"])
@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_strategy_json_is_the_same_text_and_imports_either_way(model,
                                                                builder):
    jpcg, tpcg = _pcgs(model)
    jb, tb = BUILDERS[builder]
    jtext, ttext = jb(jpcg).to_json(jpcg), tb(tpcg).to_json(tpcg)
    assert ttext == jtext
    assert tstrategy.Strategy.from_json(jtext, tpcg).to_json(tpcg) == jtext
    assert jstrategy.Strategy.from_json(ttext, jpcg).to_json(jpcg) == ttext


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_builders_write_the_same_specs_node_by_node(builder):
    jpcg, tpcg = _pcgs("bert")
    js, ts = BUILDERS[builder][0](jpcg), BUILDERS[builder][1](tpcg)
    jn = {jpcg.nodes[g].name: ns for g, ns in js.node_strategies.items()}
    tn = {tpcg.nodes[g].name: ns for g, ns in ts.node_strategies.items()}
    assert sorted(jn) == sorted(tn)
    for name in jn:
        a, b = jn[name], tn[name]
        assert (a.view.dim, a.view.stride, a.view.start_device_id) == \
            (b.view.dim, b.view.stride, b.view.start_device_id), name
        assert a.weight_specs == b.weight_specs, name
        assert a.output_spec == b.output_spec, name
        assert a.extra == b.extra, name
    assert js.describe() == ts.describe()


def _bad(mod, pcg, case):
    """The plan of ``case`` built in one package (``mod`` is its strategy
    module), and (n_dev, batch)."""
    S = mod.Strategy
    n_dev, batch = 8, 8
    by = {n.name: n.guid for n in pcg.topo_order()}
    if case == "axis_count":
        s = S(mesh_shape=(2, 2), axis_names=("data",))
    elif case == "duplicate_axes":
        s = S(mesh_shape=(2, 2), axis_names=("data", "data"))
    elif case == "too_many_devices":
        s = S(mesh_shape=(4, 4), axis_names=("data", "model"))
    elif case == "data_axis":
        s = S(mesh_shape=(2,), axis_names=("x",), data_axis="data")
    elif case == "batch":
        s, batch = S(mesh_shape=(4,), axis_names=("data",)), 6
    elif case == "hybrid":
        s = S(mesh_shape=(4, 2), axis_names=("data", "model"),
              hybrid=((2, 2), (1, 1)))
    elif case == "remat":
        s = S(mesh_shape=(2,), axis_names=("data",), remat="partial")
    elif case == "schedule_without_pipeline":
        s = S(mesh_shape=(2,), axis_names=("data",), schedule="1f1b")
    elif case == "pp_one":
        s = S(mesh_shape=(2,), axis_names=("data",), pipeline=(1, 2, 2))
    elif case == "pipeline_devices":
        s = S(mesh_shape=(2,), axis_names=("data",), pipeline=(4, 4, 4))
    elif case == "pipeline_micro":
        s = S(mesh_shape=(2,), axis_names=("data",), pipeline=(2, 2, 3))
    elif case == "interleaved_v":
        s = S(mesh_shape=(2,), axis_names=("data",), pipeline=(2, 1, 4),
              schedule="interleaved", virtual_stages=1)
    elif case == "virtual_stages":
        s = S(mesh_shape=(2,), axis_names=("data",), pipeline=(2, 1, 4),
              schedule="1f1b", virtual_stages=2)
    elif case == "unknown_axis":
        s = S(mesh_shape=(2,), axis_names=("data",))
        s.for_node(by["l0_fc1_3"]).weight_specs = {"kernel": (None, "tp")}
    elif case == "indivisible_spec":
        s = S(mesh_shape=(1, 3), axis_names=("data", "model"))
        s.for_node(by["l0_attn_0"]).weight_specs = {
            "wq": (None, "model", None)}
    return s, n_dev, batch


BAD = ["axis_count", "duplicate_axes", "too_many_devices", "data_axis",
       "batch", "hybrid", "remat", "schedule_without_pipeline", "pp_one",
       "pipeline_devices", "pipeline_micro", "interleaved_v",
       "virtual_stages", "unknown_axis", "indivisible_spec"]


@pytest.mark.parametrize("case", BAD)
def test_preflight_raises_the_jax_message(case):
    jpcg, tpcg = _pcgs("bert")
    js, n, b = _bad(jstrategy, jpcg, case)
    ts, _, _ = _bad(tstrategy, tpcg, case)
    with pytest.raises(jpre.PreflightError) as je:
        jpre.preflight_strategy(jpcg, js, n_dev=n, batch_size=b)
    with pytest.raises(tpre.PreflightError) as te:
        tpre.preflight_strategy(tpcg, ts, n_dev=n, batch_size=b)
    assert str(te.value) == str(je.value)
    assert isinstance(te.value, ValueError)


# ------------------------------------------------------- one-rank meshes
@pytest.fixture
def one_rank():
    """Compiles on a mesh join a process group of one (gloo, a file store
    in the temporary directory); it is torn down after the test."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _tiny_bert(argv=(), strategy_fn=None, seed=3):
    c = ft.FFConfig()
    c.parse_args(list(argv))
    c.batch_size, c.seed = 8, seed
    ff = ft.FFModel(c, device="cpu")
    build_bert(ff, BertConfig.tiny(batch_size=8))
    ff.compile(optimizer=ft.AdamOptimizer(None, alpha=1e-3),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy_fn=strategy_fn)
    return ff


def _jax_export(argv, path):
    c = fj.FFConfig()
    c.parse_args(list(argv) + ["--export-strategy", path])
    c.batch_size = 8
    ff = fj.FFModel(c)
    jax_build_bert(ff, JaxBertConfig.tiny(batch_size=8))
    ff.compile(optimizer=fj.AdamOptimizer(None, alpha=1e-3),
               loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    with open(path) as f:
        return f.read()


def _step(ff):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16, 64)).astype(np.float32)
    y = rng.integers(0, 2, (8, 1)).astype(np.int32)
    ff.fit(x, y, epochs=1)
    return float(ff.fit_history.loss[0]), ff.get_params_numpy()


def test_mesh_shape_and_export_follow_the_jax_flow(one_rank, tmp_path):
    argv = ["--only-data-parallel", "--mesh-shape", "1x1"]
    path = str(tmp_path / "port.json")
    ff = _tiny_bert(argv + ["--export-strategy", path])
    assert ff.mesh is not None and ff.mesh.shape == {"data": 1, "model": 1}
    with open(path) as f:
        text = f.read()
    assert text == _jax_export(argv, str(tmp_path / "jax.json"))
    assert json.loads(text)["mesh_shape"] == [1]
    # a mesh of one rank trains as one device does
    plain = _tiny_bert()
    assert plain.mesh is None
    loss, params = _step(ff)
    want_loss, want = _step(plain)
    assert loss == pytest.approx(want_loss, abs=1e-6)
    for n in want:
        for w in want[n]:
            np.testing.assert_allclose(params[n][w], want[n][w], rtol=1e-6,
                                       atol=1e-6)


def test_import_strategy_applies_the_jax_file(one_rank, tmp_path):
    jpcg, _ = _pcgs("bert")
    src = str(tmp_path / "hybrid.json")
    with open(src, "w") as f:
        f.write(jstr.hybrid_data_tensor_strategy(jpcg, 1, 1).to_json(jpcg))
    out = str(tmp_path / "out.json")
    ff = _tiny_bert(["--import-strategy", src, "--export-strategy", out])
    assert ff.mesh.shape == {"data": 1, "model": 1}
    held = ff.executor.param_shardings()["l0_attn_0"]
    assert str(held["wq"]) == "(Replicate(), Shard(dim=1))"
    assert str(held["wo"]) == "(Replicate(), Shard(dim=0))"
    with open(src) as a, open(out) as b:
        assert a.read() == b.read()


def test_only_data_parallel_in_one_process_stays_on_one_device(tmp_path):
    path = str(tmp_path / "dp.json")
    ff = _tiny_bert(["--only-data-parallel", "--export-strategy", path])
    assert ff.mesh is None and not dist.is_initialized()
    with open(path) as f:
        got = json.load(f)
    assert got["mesh_shape"] == [1] and got["axis_names"] == ["data"]


def test_pipeline_grid_is_refused_by_name():
    """Compiled since its slice; a grid of two ranks in a process of one
    is refused before any group is joined, naming the grid."""
    def fn(pcg):
        s = tstrategy.data_parallel_strategy(pcg, 1)
        s.pipeline = (2, 1, 2)
        return s

    with pytest.raises(tpre.PreflightError, match="pipeline grid") as e:
        _tiny_bert(strategy_fn=fn)
    assert "needs 2 devices but only 1" in str(e.value)
    assert not dist.is_initialized()


def test_sequence_parallel_axis_is_refused_by_name(one_rank):
    with pytest.raises(NotImplementedError, match="ROADMAP A.7") as e:
        _tiny_bert(strategy_fn=lambda pcg: tstr.long_context_strategy(
            pcg, 1, 1))
    assert "sequence_parallel_axis" in str(e.value) and LATER in str(e.value)


def test_serving_a_mesh_model_is_refused_by_name(one_rank):
    c = ft.FFConfig()
    c.batch_size = 2
    ff = ft.FFModel(c, device="cpu")
    cfg = GPT2Config(batch_size=2, seq_len=32, hidden=32, num_heads=2,
                     num_layers=1, intermediate=64, vocab_size=64)
    _ids, logits = build_gpt2(ff, cfg)
    ff.softmax(logits)
    ff.compile(loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy_fn=lambda pcg: tstr.hybrid_data_tensor_strategy(
                   pcg, 1, 1))
    # the model trains on its mesh (constants, reshapes: whole-batch ops)
    ids = np.random.default_rng(0).integers(0, 64, (2, 32)).astype(np.int32)
    ff.fit(ids, ids, epochs=1)
    assert np.isfinite(ff.fit_history.loss).all()
    with pytest.raises(NotImplementedError, match="ROADMAP A.8") as e:
        ff.generate([[1, 2, 3]], max_new_tokens=2)
    assert LATER in str(e.value)


# ------------------------------------------------------- copied vocabulary
def test_machine_view_parallel_tensor_and_parallel_ops_match_jax():
    """The copied MachineView, ParallelTensorShape and parallel ops give
    the JAX package's device ids, specs and comm bytes; the port's
    ``placements`` put ``Shard(d)`` on the mesh dims that shard dim d."""
    from flexflow_tpu import machine_view as jmv
    from flexflow_tpu import parallel_tensor as jpt
    from flexflow_tpu.ffconst import OperatorType as JOT
    from flexflow_tpu.ops.base import op_class_for as jop
    from flexflow_tpu_torch import machine_view as tmv
    from flexflow_tpu_torch import parallel_tensor as tpt
    from flexflow_tpu_torch.ffconst import OperatorType as TOT
    from flexflow_tpu_torch.ops import op_class_for as top

    for dim, stride in (((2, 4), (4, 1)), ((3,), (2,))):
        a = jmv.MachineView(dim=dim, stride=stride, start_device_id=1)
        b = tmv.MachineView(dim=dim, stride=stride, start_device_id=1)
        assert a.device_ids() == b.device_ids()
        assert a.num_parts() == b.num_parts()
    shapes = []
    for pt in (jpt, tpt):
        s = pt.ParallelTensorShape.unsharded((8, 16, 4))
        s = s.with_dim_sharded(0, ("data",), 2)
        s = s.with_dim_sharded(1, ("model", "seq"), 4)
        shapes.append(s)
    assert tuple(shapes[0].partition_spec()) == shapes[1].partition_spec()
    assert str(shapes[0]) == str(shapes[1])
    got = [repr(p) for p in shapes[1].placements(("data", "model", "seq"))]
    assert got == ["Shard(dim=0)", "Shard(dim=1)", "Shard(dim=1)"]
    for name in ("OP_REPARTITION", "OP_COMBINE", "OP_REPLICATE",
                 "OP_REDUCTION", "OP_FUSED_PARALLEL", "OP_ALLTOALL"):
        attrs = {"dim": 0, "degree": 4}
        jo = jop(getattr(JOT, name))("p", attrs, None)
        to = top(getattr(TOT, name))("p", attrs, None)
        assert jo.comm_bytes((64, 32), 4, 8) == to.comm_bytes((64, 32), 4, 8)


def test_hybrid_rank_grid_keeps_each_node_whole():
    """``build_hybrid_mesh``'s layout: axis i is ici[i] * dcn[i] long, the
    ranks of one node (consecutive, ``torchrun``'s numbering) fill the ICI
    block of every axis, so no DCN factor splits a node's ring."""
    from flexflow_tpu_torch.parallel.mesh import hybrid_rank_grid, \
        mesh_axis_size

    g = hybrid_rank_grid((1, 4), (2, 1))  # 2 nodes x 4 GPUs, dp over DCN
    assert g.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    g = hybrid_rank_grid((2, 2), (2, 1))  # 2 nodes x 4 GPUs: mesh (4, 2)
    assert g.shape == (4, 2)
    for node in range(2):
        rows = g[2 * node:2 * node + 2]
        assert sorted(rows.ravel().tolist()) == list(range(4 * node,
                                                           4 * node + 4))
    assert mesh_axis_size(type("M", (), {"shape": {"data": 4}})(),
                          "model") == 1
