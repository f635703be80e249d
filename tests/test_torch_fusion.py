"""The port's ``--fusion`` (``flexflow_tpu_torch/ops/fused.py``) against
the JAX package's pass and FusedOp (``tests/test_fusion.py:28-107``):

* ``apply_fusion`` builds the same regions in both packages — names,
  member ops, wiring, the nodes left unfused, and the weight names
  (``sub{i}:{op}:{weight}``) — on the test's dense chain, on BERT-tiny and
  on the BERT-Large proxy's graph, whose region count ``BERT_LARGE_REGIONS``
  ``chip_smoke.py`` asserts on the card;
* one fused training step from the JAX fused model's params
  (``set_params_numpy`` with the ``sub{i}:`` names) gives the JAX fused
  step's loss and params within ``STEP_TOL``;
* in the port, a fused model trains bitwise as the unfused one: the same
  initial weights under the region names, the same losses and params
  after two epochs;
* a node with two consumers ends a chain, and a ``final_tensor`` anchor is
  a region tail at most, its output the forward's.
"""
import numpy as np
import pytest
import torch

import flexflow_tpu as fj
import flexflow_tpu_torch as ft
from flexflow_tpu.ops.fused import apply_fusion as jax_apply_fusion
from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.fused import apply_fusion
from torch_resilience_pairs import params_of

torch.set_num_threads(2)

# the BERT-Large proxy (hidden 1024, 24 layers): per layer one region from
# the attention to the first layer norm, one from the first dense to the
# second layer norm (the last one running on through the pooler and the
# head to the softmax anchor)
BERT_LARGE_REGIONS = 48
# one SGD step of the chain model from equal params: summation order only
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def build(pkg, batch=32, fusion=True):
    c = pkg.FFConfig()
    c.batch_size, c.perform_fusion = batch, fusion
    if pkg is fj:
        c.only_data_parallel = True
    ff = pkg.FFModel(c, device="cpu") if pkg is ft else pkg.FFModel(c)
    x = ff.create_tensor((batch, 32), name="x")
    t = ff.dense(x, 64, name="d1")
    t = ff.relu(t)
    t = ff.dense(t, 10, name="d2")
    ff.softmax(t)
    ff.compile(optimizer=pkg.SGDOptimizer(ff, lr=0.1),
               loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 32)).astype(np.float32)
    w = rng.normal(size=(32, 10)).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return x, y


def regions(pcg):
    """Each node of a (fused) graph as (name, op type, [(sub-op name, op
    type)], wiring, [input node names]), in order."""
    out = []
    for n in pcg.compute_nodes():
        subs = [(s.name, s.op_type.name)
                for s in getattr(n.op, "sub_ops", [])]
        wiring = [list(map(tuple, w)) for w in getattr(n.op, "wiring", [])]
        out.append((n.name, n.op.op_type.name, subs, wiring,
                    [(pcg.nodes[g].name, i) for g, i in n.inputs]))
    return out


def _bert(pkg, **kw):
    from flexflow_tpu.models import bert as jb
    from flexflow_tpu_torch.models import bert as tb

    m = tb if pkg is ft else jb
    ff = pkg.FFModel(pkg.FFConfig(), device="cpu") if pkg is ft else \
        pkg.FFModel(pkg.FFConfig())
    cfg = m.BertConfig(**kw) if kw else m.BertConfig.tiny()
    m.build_bert(ff, cfg)
    return ff


@pytest.mark.parametrize("graph", ["chain", "bert_tiny", "bert_large"])
def test_apply_fusion_regions_equal_jax(graph):
    pcgs = {}
    for pkg in (ft, fj):
        if graph == "chain":
            ff = build(pkg, fusion=False)
            pcg = ff.pcg
            barrier = (ff.final_guid,)
        else:
            kw = {} if graph == "bert_tiny" else dict(num_layers=24)
            ff = _bert(pkg, **kw)
            pcg = ff.create_pcg()
            barrier = (pcg.sinks()[-1].guid,)
        if pkg is ft:
            fused, n, _remap = apply_fusion(pcg, barrier_guids=barrier)
        else:
            fused, n, _remap = jax_apply_fusion(pcg, None,
                                                barrier_guids=barrier)
        weights = sorted(f"{node.name}.{w}" for node in fused.compute_nodes()
                         for w in node.op.weight_specs(
                             [fused.nodes[g].out_shapes[i]
                              for g, i in node.inputs]))
        pcgs[pkg] = (n, regions(fused), weights)
    assert pcgs[ft] == pcgs[fj]
    n, regs, weights = pcgs[ft]
    if graph == "chain":
        assert n == 1 and len(regs) == 1 and len(regs[0][2]) == 4
        assert weights[1].endswith(".sub0:d1_0:kernel"), weights
    if graph == "bert_large":
        assert n == BERT_LARGE_REGIONS
        assert all(r[1] == "OP_FUSED" for r in regs)


def test_fused_step_matches_jax_fused_step():
    """One SGD step of the fused chain in both packages from the JAX fused
    model's params, moved by their ``sub{i}:`` names."""
    x, y = _data()
    jff, tff = build(fj), build(ft)
    assert [n.op.op_type for n in tff.pcg.compute_nodes()] == \
        [OperatorType.OP_FUSED]
    tff.set_params_numpy(params_of(jff))
    jff._telemetry_requested = True  # the JAX fit keeps its losses
    for ff in (jff, tff):
        ff.fit(x[:32], y[:32], epochs=1, shuffle=False)
    np.testing.assert_allclose(tff.fit_history.loss,
                               jff.get_telemetry().loss_history, **STEP_TOL)
    got, want = params_of(tff), params_of(jff)
    assert got.keys() == want.keys()
    (region,) = got
    assert sorted(got[region]) == ["sub0:d1_0:bias", "sub0:d1_0:kernel",
                                   "sub2:d2_2:bias", "sub2:d2_2:kernel"]
    for w in want[region]:
        np.testing.assert_allclose(got[region][w], want[region][w],
                                   err_msg=w, **STEP_TOL)


def _unfused_names(params):
    """A fused model's params under the member ops' own names."""
    out = {}
    for region, ws in params.items():
        for key, a in ws.items():
            _sub, op, w = key.split(":")
            out.setdefault(op, {})[w] = a
    return out


def test_fused_training_equals_unfused_bitwise():
    x, y = _data()
    runs = {}
    for fusion in (False, True):
        ff = build(ft, fusion=fusion)
        init = params_of(ff)
        ff.fit(x, y, epochs=2)
        final = params_of(ff)
        if fusion:
            init, final = _unfused_names(init), _unfused_names(final)
        runs[fusion] = (init, final, ff.fit_history.loss,
                        ff.get_perf_metrics().train_correct)
    for a, b in zip(runs[True][:2], runs[False][:2]):
        assert a.keys() == b.keys()
        for n in a:
            for w in a[n]:
                np.testing.assert_array_equal(a[n][w], b[n][w])
    assert runs[True][2] == runs[False][2]
    assert runs[True][3] == runs[False][3]


def test_fusion_stops_at_multi_consumer():
    c = ft.FFConfig()
    c.batch_size, c.perform_fusion = 16, True
    ff = ft.FFModel(c, device="cpu")
    x = ff.create_tensor((16, 8), name="x")
    a = ff.dense(x, 8, name="a")
    b = ff.relu(a)
    t = ff.tanh(a)  # `a` has two consumers: no chain runs past it
    ff.add(b, t)
    ff.compile(loss_type=ft.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    nodes = ff.pcg.compute_nodes()
    assert [(n.name, n.op.op_type) for n in nodes] == [
        ("a_0", OperatorType.OP_LINEAR), ("tanh_2", OperatorType.OP_TANH),
        ("fused_relu_1+ew_add_3", OperatorType.OP_FUSED)]


def test_fusion_preserves_final_tensor_anchor():
    """``compile(final_tensor=...)`` under ``--fusion`` keeps the anchored
    tensor addressable: the anchor is a region tail at most."""
    c = ft.FFConfig()
    c.batch_size, c.perform_fusion = 4, True
    ff = ft.FFModel(c, device="cpu")
    x = ff.create_tensor((4, 8))
    t = ff.relu(x)
    anchor = ff.gelu(t)  # a chain relu -> gelu
    ff.dense(anchor, 3)  # a later sink that must not take the anchor
    ff.compile(loss_type=ft.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
               final_tensor=anchor)
    final = ff.pcg.nodes[ff.final_guid]
    assert final.op.op_type == OperatorType.OP_FUSED
    xs = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    out = ff.executor.make_forward()(ff.params, [torch.tensor(xs)])
    assert tuple(out.shape) == (4, 8)
    ref = torch.nn.functional.gelu(torch.relu(torch.tensor(xs)),
                                   approximate="tanh")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_serving_refuses_fused_stateful_regions_as_jax():
    """A fused GPT-2 folds its attention and position constant into
    regions the serving engine cannot thread decode state through; the
    port refuses it before serving, naming ``--fusion``, as the JAX engine
    does (FF005, ``tests/test_serving.py:412-426``), over the same
    regions."""
    from flexflow_tpu.analysis import check_serving_graph
    from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
    from flexflow_tpu.serving import ServingEngine as JaxServingEngine
    from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
    from flexflow_tpu_torch.serving import ServingEngine

    models = {}
    for pkg, cfg_cls, builder in ((fj, JaxGPT2Config, jax_build_gpt2),
                                  (ft, GPT2Config, build_gpt2)):
        c = pkg.FFConfig()
        c.batch_size, c.perform_fusion = 8, True
        if pkg is fj:
            c.only_data_parallel = True
        ff = pkg.FFModel(c, device="cpu") if pkg is ft else pkg.FFModel(c)
        builder(ff, cfg_cls.tiny(batch_size=8))
        ff.compile(optimizer=pkg.SGDOptimizer(ff),
                   loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        models[pkg] = ff
    jff, tff = models[fj], models[ft]
    assert regions(tff.pcg) == regions(jff.pcg)
    with pytest.raises(NotImplementedError, match="FF005"):
        JaxServingEngine(jff, max_decode_len=16)
    flagged = sorted({d.node for d in check_serving_graph(jff.pcg)})
    assert flagged
    with pytest.raises(NotImplementedError, match="--fusion") as err:
        ServingEngine(tff, max_decode_len=16)
    msg = str(err.value)
    assert "FF005" in msg
    assert sorted({n.name for n in tff.pcg.compute_nodes()
                   if f"{n.name} holds" in msg}) == flagged
    with pytest.raises(NotImplementedError, match="--fusion"):
        tff.generate([[1, 2, 3]], max_new_tokens=2)
