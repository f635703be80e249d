"""The port's cost model against the JAX package's, node for node.

* Machine model: a ``GPUMachineModel`` built from a JAX machine's fields
  prices every collective (``allreduce``, ``allgather``, ``alltoall``,
  ``p2p`` and the ``hier_*`` forms, on NVLink and across nodes) as the JAX
  one does (rel 1e-12), for several sizes and participant counts; its
  ``detect`` on the CPU is the fixed H100 SXM entry, the dense peak from
  the telemetry's one table; ``from_file`` refuses an unknown card.
* Simulator: ``op_cost`` (every ``CostMetrics`` field) for every node of
  the tiny BERT, GPT-2, Transformer, a reduced ResNet and a small DLRM
  under each ``OpSharding`` that ``node_options`` gives at tp 1, 2 and 4
  and dp 1 and 2, and ``simulate`` (time and memory) and
  ``simulate_event_driven`` on the data-parallel and the searched
  assignments.
* The native helper: ``simulate_taskgraph`` equals its Python version on
  random task graphs, and a cycle raises in both; a source that does not
  compile raises with the compiler's error.
* The SPMD plan takes a resharding node's ``target_pts`` as its output
  layout, and passes the layout through a node without one.
"""
import dataclasses
import itertools
from importlib import import_module

import numpy as np
import pytest

import flexflow_tpu as fj
import flexflow_tpu.parallel.pcg as jax_pcg
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.parallel.pcg as torch_pcg
from flexflow_tpu.search import simulator as jsim
from flexflow_tpu.search import unity as ju
from flexflow_tpu.search.machine_model import TPUMachineModel
from flexflow_tpu_torch import native
from flexflow_tpu_torch.search import simulator as tsim
from flexflow_tpu_torch.search import unity as tu
from flexflow_tpu_torch.search.machine_model import GPUMachineModel

from torch_search_pairs import jax_fields

REL = 1e-12


@pytest.fixture(autouse=True)
def _fresh_node_guids(monkeypatch):
    """Both packages number the test's graph nodes from 1: the names the
    search's rewrites make embed node guids (``reduction_<guid>``)."""
    for module in (jax_pcg, torch_pcg):
        monkeypatch.setattr(module, "_node_guid", itertools.count(1))


def _close(a, b, rel=REL):
    assert abs(a - b) <= rel * max(abs(a), abs(b), 1e-300), (a, b)


@pytest.mark.parametrize("gen,n,hosts", [("v5e", 8, 1), ("v5p", 16, 2),
                                         ("v4", 4, 1)])
def test_machine_collectives_equal(gen, n, hosts):
    jm = TPUMachineModel.from_generation(gen, n, num_hosts=hosts)
    tm = GPUMachineModel(**dataclasses.asdict(jm))
    for nbytes in (0, 1, 4096, 1 << 20, 3 << 27):
        for k in (1, 2, 3, 4, 8, n):
            for medium in ("ici", "dcn"):
                for f in ("allreduce_time", "allgather_time",
                          "alltoall_time"):
                    _close(getattr(tm, f)(nbytes, k, medium, 2),
                           getattr(jm, f)(nbytes, k, medium, 2))
                _close(tm.p2p_time(nbytes, medium),
                       jm.p2p_time(nbytes, medium))
            for f in ("hier_allreduce_time", "hier_allgather_time",
                      "hier_alltoall_time"):
                _close(getattr(tm, f)(nbytes, k, hosts, 2),
                       getattr(jm, f)(nbytes, k, hosts, 2))


def test_detect_on_cpu_is_the_h100_sxm_entry(tmp_path):
    from flexflow_tpu_torch.obs.telemetry import PEAK_FLOPS

    m = GPUMachineModel.detect(4, device="cpu")
    assert (m.generation, m.num_chips, m.torus) == ("h100-sxm", 4, (4,))
    assert m.peak_flops == PEAK_FLOPS["H100 SXM"]
    assert m.peak_flops_f32 == 67e12 and m.ici_links_per_chip == 2
    p = tmp_path / "m.cfg"
    p.write_text("generation = v5e\n")
    with pytest.raises(ValueError, match="generation"):
        GPUMachineModel.from_file(str(p), 4)
    p.write_text("generation = h100-pcie\nnum_pods = 2\n")
    m = GPUMachineModel.from_file(str(p), 4)
    assert (m.generation, m.num_pods, m.num_hosts) == ("h100-pcie", 2, 2)


def test_fp32_matmuls_take_the_cards_fp32_rate(tmp_path):
    """The port runs IEEE fp32 with TF32 off: on the H100 entry an fp32
    GEMM is priced at the 67 TF/s fp32 rate, a bf16 one at the 16-bit
    peak, and a pipeline stage's (in its params' dtype) at the fp32 rate
    whatever the compute dtype. With the rate at 0 (the JAX rule) the
    dtypes price alike."""
    c = ft.FFConfig()
    c.batch_size = 4096
    ff = ft.FFModel(c, device="cpu")
    ff.dense(ff.create_tensor((4096, 4096)), 4096, use_bias=False)
    pcg = ff.create_pcg()
    (node,) = pcg.compute_nodes()
    ins = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
    m = GPUMachineModel.detect(1, device="cpu")
    assert m.matmul_flops_f32 == m.peak_flops_f32 == 67e12

    def fwd(machine, label, **sh):
        return tsim.Simulator(machine, dtype_label=label).op_cost(
            node, ins, tsim.OpSharding(**sh)).forward_time

    f32, bf16 = fwd(m, "f32"), fwd(m, "bf16")
    stage = fwd(m, "bf16", in_params_dtype=True)
    flops = 2 * 4096 ** 3
    _close(f32, flops / (67e12 * m.matmul_efficiency) + 5e-7, 1e-9)
    _close(bf16, flops / (m.peak_flops * m.matmul_efficiency) + 5e-7,
           1e-9)
    _close(stage, f32, 1e-12)
    m.matmul_flops_f32 = 0.0
    _close(fwd(m, "f32"), bf16, 1e-12)
    p = tmp_path / "m.cfg"
    p.write_text("matmul_flops_f32 = 0\n")
    assert GPUMachineModel.from_file(str(p), 1).matmul_flops_f32 == 0.0


def _graph(kind, pkg, device_kw):
    c = pkg.FFConfig()
    c.batch_size = 8
    # the JAX default on both sides (the port's is off): the search's
    # sequence-parallel states stay covered
    c.enable_sequence_parallel = True
    ff = pkg.FFModel(c, **device_kw)
    m = import_module(f"{pkg.__name__}.models." + {
        "bert": "bert", "gpt2": "gpt2", "transformer": "transformer",
        "resnet": "vision", "dlrm": "dlrm"}[kind])
    if kind == "bert":
        m.build_bert(ff, m.BertConfig.tiny(batch_size=8))
    elif kind == "gpt2":
        _ids, logits = m.build_gpt2(ff, m.GPT2Config.tiny(batch_size=8))
        ff.softmax(logits)
    elif kind == "transformer":
        m.build_transformer(ff, m.TransformerConfig.tiny(batch_size=8))
    elif kind == "resnet":
        m.build_resnet50(ff, batch_size=8, image_size=32, num_classes=10,
                         stages=(1, 1))
    else:
        m.build_dlrm(ff, batch_size=8, embedding_sizes=(100,) * 4,
                     embedding_dim=16, dense_dim=8, mlp_bot=(32, 16),
                     mlp_top=(32, 2))
    return ff.create_pcg(), c


KINDS = ["bert", "gpt2", "transformer", "resnet", "dlrm"]


@pytest.mark.parametrize("kind", KINDS)
def test_op_cost_and_simulate_equal(kind):
    jpcg, jc = _graph(kind, fj, {})
    tpcg, tc = _graph(kind, ft, {"device": "cpu"})
    tm = GPUMachineModel.detect(8, device="cpu")
    jm = TPUMachineModel(**jax_fields(tm))
    js, ts = jsim.Simulator(jm), tsim.Simulator(tm)
    jnodes, tnodes = jpcg.compute_nodes(), tpcg.compute_nodes()
    assert [n.name for n in jnodes] == [n.name for n in tnodes]
    fields = [f.name for f in dataclasses.fields(jsim.CostMetrics)]
    priced = 0
    for jn, tn in zip(jnodes, tnodes):
        jin = [jpcg.nodes[g].out_shapes[i] for g, i in jn.inputs]
        tin = [tpcg.nodes[g].out_shapes[i] for g, i in tn.inputs]
        assert jin == tin
        for tp_deg in (1, 2, 4):
            jopts = ju.node_options(jn, tp_deg, jin)
            assert tu.node_options(tn, tp_deg, tin) == jopts
            for k, _i, _o in jopts:
                for dp in (1, 2):
                    for remat in ("none", "full"):
                        kw = dict(dp=dp, tp=tp_deg if k != "none" else 1,
                                  kind=k, remat=remat)
                        jc_ = js.op_cost(jn, jin, jsim.OpSharding(**kw))
                        tc_ = ts.op_cost(tn, tin, tsim.OpSharding(**kw))
                        for f in fields:
                            _close(getattr(tc_, f), getattr(jc_, f))
                        priced += 1
    assert priced > len(jnodes)
    jdp = {n.guid: jsim.OpSharding(dp=8) for n in jnodes}
    tdp = {n.guid: tsim.OpSharding(dp=8) for n in tnodes}
    jt, jmem = js.simulate(jpcg, jdp)
    tt, tmem = ts.simulate(tpcg, tdp)
    _close(tt, jt)
    assert tmem == jmem
    _close(ts.simulate_event_driven(tpcg, tdp),
           js.simulate_event_driven(jpcg, jdp))
    # the searched assignment (guids differ between the packages: map by
    # position in the graph)
    jres = ju.unity_search(jpcg, jc, 8, machine=jm, return_result=True,
                           insert_ir_nodes=False)
    tres = tu.unity_search(tpcg, tc, 8, machine=tm, return_result=True,
                           insert_ir_nodes=False)
    assert tres.strategy.to_json(tpcg) == \
        jres.strategy.to_json(jpcg)
    _close(tres.sim_time, jres.sim_time, 1e-9)
    if jres.pcg is not None:
        jpcg, tpcg = jres.pcg, tres.pcg
    jmap = {n.guid: i for i, n in enumerate(jpcg.topo_order())}
    tby = {i: n.guid for i, n in enumerate(tpcg.topo_order())}
    tassign = {tby[jmap[g]]: tsim.OpSharding(**dataclasses.asdict(sh))
               for g, sh in jres.assignment.items() if g in jmap}
    jassign = {g: sh for g, sh in jres.assignment.items() if g in jmap}
    jt, jmem = js.simulate(jpcg, jassign)
    tt, tmem = ts.simulate(tpcg, tassign)
    _close(tt, jt)
    assert tmem == jmem
    _close(ts.simulate_event_driven(tpcg, tassign),
           js.simulate_event_driven(jpcg, jassign))


def test_native_taskgraph_equals_python():
    rng = np.random.default_rng(0)
    for n in (1, 5, 40, 300):
        costs = rng.random(n)
        dev = rng.integers(0, 4, n)
        src, dst = [], []
        for t in range(1, n):
            for s in rng.choice(t, size=min(t, 3), replace=False):
                src.append(int(s))
                dst.append(t)
        a = native.simulate_taskgraph(costs, dev, 4, np.array(src, int),
                                      np.array(dst, int))
        b = native.simulate_taskgraph_py(costs, dev, 4, np.array(src, int),
                                         np.array(dst, int))
        assert a == b
    for fn in (native.simulate_taskgraph, native.simulate_taskgraph_py):
        with pytest.raises(ValueError, match="cycle"):
            fn(np.ones(2), np.zeros(2, int), 1, np.array([0, 1]),
               np.array([1, 0]))


def test_native_builds_from_the_port_source_and_raises_on_failure(
        monkeypatch, tmp_path):
    import os

    assert os.path.realpath(native.SOURCE) == os.path.realpath(
        os.path.join(os.path.dirname(native.__file__), "ffnative.cpp"))
    assert native.library_path().startswith(native.BUILD_DIR)
    bad = tmp_path / "ffnative.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()


def test_plan_takes_a_resharding_nodes_target_pts():
    """A Combine after a column-parallel dense: with ``target_pts`` (and no
    output spec) the SPMD plan gathers the model axis at the node; without
    it the node passes the column shard through."""
    import types

    from torch.distributed.tensor import Replicate, Shard

    from flexflow_tpu_torch.ffconst import OperatorType
    from flexflow_tpu_torch.ops.base import op_class_for
    from flexflow_tpu_torch.parallel.spmd import plan_spmd
    from flexflow_tpu_torch.parallel.strategies import \
        hybrid_data_tensor_strategy
    from flexflow_tpu_torch.search.unity import _target_pts

    c = ft.FFConfig()
    c.batch_size = 8
    ff = ft.FFModel(c, device="cpu")
    t = ff.dense(ff.create_tensor((8, 16)), 32, name="col")
    ff.dense(ff.relu(t), 4, name="row")
    pcg = ff.create_pcg()
    s = hybrid_data_tensor_strategy(pcg, 2, 2)
    col = [n for n in pcg.compute_nodes() if n.name.startswith("col")][0]
    relu = pcg.consumers(col.guid)[0]
    node = pcg.insert_node_on_edge(relu, 0, op_class_for(
        OperatorType.OP_COMBINE)("combine", {"dim": 1, "degree": 2,
                                             "axes": ("model",)},
                                 col.op.data_type, num_inputs=1))
    mesh = types.SimpleNamespace(axis_names=("data", "model"))
    plan = plan_spmd(pcg, s, mesh)[node.guid]
    assert plan.natural[0] == (Shard(0), Shard(1))  # the column shard
    assert plan.outs[0] == plan.natural[0]          # passed through
    node.op.target_pts = _target_pts((8, 32), ("data",), col.op.data_type,
                                     {"data": 2, "model": 2})
    plan = plan_spmd(pcg, s, mesh)[node.guid]
    assert plan.outs[0] == (Shard(0), Replicate())  # gathered
