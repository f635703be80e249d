"""The port's Unity search returns the JAX package's winner.

Both packages build the same graph and search it on a machine of the same
field values (the JAX ``TPUMachineModel`` built from the port's
``GPUMachineModel`` fields, or the port's from a JAX machine's: neither
package's ``detect`` is called). Per case: the strategy JSON equal (both
packages numbering the test's graph nodes from 1: the names the rewrites
make embed node guids),
``sim_time`` within 1e-9 relative, the same candidate count and the same
count of candidates ShardLint pruned, and the rewritten graphs' node
names equal. Cases: the tiny BERT on 4 devices (the H100 SXM entry and a
TPU machine's fields), ``--memory-search`` on BERT-Large widths under
memory pressure, a ``--substitution-json`` rule on a branchy conv graph,
a pipeline winner (a dense stack of width 1001, which admits no tensor
degree), the seeded ``mcmc_optimize``, and ``--pods 2`` with
``--hierarchical-search on``.
"""
import dataclasses
import itertools
import json

import pytest

import flexflow_tpu as fj
import flexflow_tpu.parallel.pcg as jax_pcg
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.parallel.pcg as torch_pcg
from flexflow_tpu.models.bert import BertConfig as JBert
from flexflow_tpu.models.bert import build_bert as jbuild_bert
from flexflow_tpu.search import unity as ju
from flexflow_tpu.search.machine_model import TPUMachineModel
from flexflow_tpu_torch.models.bert import BertConfig as TBert
from flexflow_tpu_torch.models.bert import build_bert as tbuild_bert
from flexflow_tpu_torch.search import unity as tu
from flexflow_tpu_torch.search.machine_model import GPUMachineModel

from torch_search_pairs import jax_fields

REL = 1e-9


@pytest.fixture(autouse=True)
def _fresh_node_guids(monkeypatch):
    """Both packages number the test's graph nodes from 1: the names the
    search's rewrites make embed node guids (``reduction_<guid>``)."""
    for module in (jax_pcg, torch_pcg):
        monkeypatch.setattr(module, "_node_guid", itertools.count(1))


def _pair(build, batch, **config):
    """(JAX pcg, config), (port pcg, config) of ``build(pkg, ff, batch)``."""
    out = []
    for pkg, kw in ((fj, {}), (ft, {"device": "cpu"})):
        c = pkg.FFConfig()
        c.batch_size = batch
        # the JAX default on both sides (the port's is off): the
        # search's sequence-parallel states stay covered
        c.enable_sequence_parallel = True
        for k, v in config.items():
            setattr(c, k, v)
        ff = pkg.FFModel(c, **kw)
        build(pkg, ff, batch)
        out.append((ff.create_pcg(), c))
    return out


def _bert(pkg, ff, batch, **kw):
    if pkg is fj:
        jbuild_bert(ff, JBert.tiny(batch_size=batch) if not kw
                    else JBert(batch_size=batch, **kw))
    else:
        tbuild_bert(ff, TBert.tiny(batch_size=batch) if not kw
                    else TBert(batch_size=batch, **kw))


def _mlp1001(pkg, ff, batch):
    t = ff.create_tensor((batch, 1001))
    for _ in range(8):
        t = ff.dense(t, 1001, pkg.ActiMode.AC_MODE_RELU)
    ff.dense(t, 13)


def _branchy(pkg, ff, batch):
    x = ff.create_tensor((batch, 3, 32, 32), name="img")
    a = ff.relu(ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="branch_a"))
    b = ff.relu(ff.conv2d(x, 8, 1, 1, 1, 1, 0, 0, name="branch_b"))
    t = ff.concat([a, b], axis=1)
    ff.softmax(ff.dense(ff.flat(t), 10))


def _machines(port_machine=None, jax_machine=None):
    if jax_machine is not None:
        return jax_machine, GPUMachineModel(**dataclasses.asdict(jax_machine))
    return TPUMachineModel(**jax_fields(port_machine)), port_machine


def _same(jres, jpcg, tres, tpcg):
    assert tres.strategy.to_json(tpcg) == \
        jres.strategy.to_json(jpcg)
    assert abs(tres.sim_time - jres.sim_time) <= REL * abs(jres.sim_time)
    assert tres.candidates == jres.candidates
    assert tres.pruned_static == jres.pruned_static
    assert [n.name for n in tpcg.topo_order()] == \
        [n.name for n in jpcg.topo_order()]


def _search(pair, n, machines, **kw):
    (jpcg, jc), (tpcg, tc) = pair
    jm, tm = machines
    jres = ju.unity_search(jpcg, jc, n, machine=jm, return_result=True, **kw)
    tres = tu.unity_search(tpcg, tc, n, machine=tm, return_result=True,
                           **kw)
    _same(jres, jpcg, tres, tpcg)
    return jres, tres


@pytest.mark.parametrize("machine", ["h100", "tpu"])
def test_bert_winner(machine):
    pair = _pair(_bert, 8)
    m = _machines(GPUMachineModel.detect(4, device="cpu")) \
        if machine == "h100" else \
        _machines(jax_machine=TPUMachineModel.from_generation("v5e", 4))
    _search(pair, 4, m)


def test_memory_search_winner():
    widths = dict(seq_len=512, hidden=1024, num_heads=16, num_layers=4,
                  intermediate=4096)
    pair = _pair(lambda pkg, ff, b: _bert(pkg, ff, b, **widths), 256,
                 perform_memory_search=True)
    m = GPUMachineModel.detect(8, device="cpu")
    m.hbm_capacity = 8 * 1024 ** 3  # memory-pressured: dp 8 does not fit
    jres, _ = _search(pair, 8, _machines(m), insert_ir_nodes=False)
    assert jres.sim_memory <= m.hbm_capacity


def test_substitution_json_winner(tmp_path):
    rule = {"rule": [{
        "name": "concat_relu",
        "srcOp": [
            {"type": "OP_RELU", "input": [{"opId": -1, "tsId": 0}],
             "para": []},
            {"type": "OP_RELU", "input": [{"opId": -2, "tsId": 0}],
             "para": []},
            {"type": "OP_CONCAT", "input": [{"opId": 0, "tsId": 0},
                                            {"opId": 1, "tsId": 0}],
             "para": [{"key": "PM_AXIS", "value": 1}]},
        ],
        "dstOp": [
            {"type": "OP_CONCAT", "input": [{"opId": -1, "tsId": 0},
                                            {"opId": -2, "tsId": 0}],
             "para": [{"key": "PM_AXIS", "value": 1}]},
            {"type": "OP_RELU", "input": [{"opId": 0, "tsId": 0}],
             "para": []},
        ],
    }]}
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(rule))
    pair = _pair(_branchy, 4, substitution_json_path=str(path))
    _search(pair, 1, _machines(GPUMachineModel.detect(1, device="cpu")))
    _search(_pair(_branchy, 4, substitution_json_path=str(path)), 4,
            _machines(GPUMachineModel.detect(4, device="cpu")))


def test_pipeline_winner():
    pair = _pair(_mlp1001, 8)
    jres, tres = _search(
        pair, 8,
        _machines(jax_machine=TPUMachineModel.from_generation("v5e", 8)),
        insert_ir_nodes=False)
    assert tres.strategy.pipeline is not None
    assert tres.strategy.schedule == jres.strategy.schedule


def test_mcmc_winner():
    (jpcg, jc), (tpcg, tc) = _pair(_bert, 8)
    jm, tm = _machines(GPUMachineModel.detect(4, device="cpu"))
    js = ju.mcmc_optimize(jpcg, jc, 4, machine=jm, iterations=120, seed=7)
    ts = tu.mcmc_optimize(tpcg, tc, 4, machine=tm, iterations=120, seed=7)
    assert ts.to_json(tpcg) == js.to_json(jpcg)


def test_hierarchical_pods_winner():
    pair = _pair(_bert, 16, search_hierarchical="on")
    jm = TPUMachineModel.multipod("v5e", 2, 4)
    jres, tres = _search(pair, 8, _machines(jax_machine=jm),
                         insert_ir_nodes=False)
    assert tres.pod_plan == jres.pod_plan and tres.pod_plan[0] == 2
    assert tres.multipod_stats == jres.multipod_stats


def test_bert_large_bf16_for_four_h100s_is_no_fp32_pipeline():
    """A pipeline stage runs in its params' dtype, fp32, whatever the
    compute dtype: priced so, the BERT-Large proxy in bf16 searched for
    four H100s gets the hybrid 2 x 2 mesh, not the pp 4 interleaved
    pipeline that the 16-bit rate for its fp32 stages (the JAX rule,
    the fp32 matmul rate at 0) makes look faster."""
    def search(machine):
        c = ft.FFConfig()
        c.batch_size, c.compute_dtype = 8, ft.DataType.DT_BFLOAT16
        ff = ft.FFModel(c, device="cpu")
        tbuild_bert(ff, TBert.large())
        return tu.unity_search(ff.create_pcg(), c, 4, machine=machine,
                               return_result=True)

    res = search(GPUMachineModel.detect(4, device="cpu"))
    assert res.strategy.pipeline is None
    assert list(res.strategy.mesh_shape) == [2, 2]
    jax_rule = GPUMachineModel.detect(4, device="cpu")
    jax_rule.matmul_flops_f32 = 0.0
    old = search(jax_rule)
    assert old.strategy.pipeline is not None
    assert old.strategy.schedule == "interleaved"
    assert old.sim_time < res.sim_time
