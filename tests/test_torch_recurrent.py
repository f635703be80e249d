"""The LSTM op and the NMT model of the port against the JAX package, on
the CPU.

* ``LSTMOp`` alone (batch 3, seq 6, in 5, hidden 4), with and without an
  initial [h, c] state: the sequence outputs, the final state and the
  grads of the weights, the input and the initial state under seeded
  cotangents. fp32: outputs within 1e-5 absolute, grads within 1e-5
  relative norm (the two sides differ in summation order only). bf16
  (both packages keep the carry in the compute dtype): outputs within
  3e-2 absolute plus 3e-2 of their magnitude and grads within 5e-2
  relative norm of JAX's bf16 run; the two round the step's GEMM and gate
  products at different points and six steps of recurrence carry that
  rounding forward (the largest differences read here: 5.9e-3 on an
  output, 1.6e-2 on a grad).
* NMT at ``NMTConfig.tiny`` (batch 8, vocab 100, embed and hidden 16, two
  layers, source 6, target 5) with flattened token labels, as
  ``tests/test_model_zoo.py`` trains it: one step's loss within 1e-4
  relative and every grad within 1e-4 relative norm, then one
  ``make_train_step`` (SGD 0.1) in each package: the loss, and the
  params after it within 1e-5.
* An LSTM graph serves; the engine refuses its prefix cache and chunked
  prefill by name (``tests/test_torch_lstm_serving.py`` holds the served
  streams against the JAX engine).
"""
import numpy as np
import pytest

from flexflow_tpu.models.nmt import NMTConfig as JaxNMTConfig
from flexflow_tpu.models.nmt import build_nmt as jax_build_nmt
from flexflow_tpu.ops.recurrent import LSTMOp as JaxLSTMOp
import flexflow_tpu as fj
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.nmt import NMTConfig, build_nmt
from flexflow_tpu_torch.ops.recurrent import LSTMOp
from torch_seq_pairs import (build_pair, check_loss_grads, check_one_step,
                             op_pair, rel, run_op_pair)

B, S, D, H = 3, 6, 5, 4
OUT_TOL = {"fp32": dict(atol=1e-5, rtol=0), "bf16": dict(atol=3e-2,
                                                          rtol=3e-2)}
GRAD_TOL = {"fp32": 1e-5, "bf16": 5e-2}


def _lstm_case(initial: bool, seed=0):
    rng = np.random.default_rng(seed)
    params = {"wx": rng.uniform(-0.6, 0.6, (D, 4 * H)).astype(np.float32),
              "wh": rng.uniform(-0.6, 0.6, (H, 4 * H)).astype(np.float32),
              "bias": rng.normal(0, 0.3, (4 * H,)).astype(np.float32)}
    ins = [rng.standard_normal((B, S, D)).astype(np.float32)]
    if initial:
        ins.append(rng.normal(0, 0.5, (B, 2 * H)).astype(np.float32))
    cots = [rng.standard_normal((B, S, H)).astype(np.float32),
            rng.standard_normal((B, 2 * H)).astype(np.float32)]
    return params, ins, cots


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("initial", [False, True])
def test_lstm_op_matches_jax(initial, compute):
    params, ins, cots = _lstm_case(initial)
    jop, top = op_pair(JaxLSTMOp, LSTMOp, {"hidden_size": H},
                       "DT_FLOAT", len(ins))
    assert top.infer_output_shapes([x.shape for x in ins]) == \
        jop.infer_output_shapes([x.shape for x in ins])
    assert {w: s for w, (s, _, _) in top.weight_specs(
        [x.shape for x in ins]).items()} == \
        {w: s for w, (s, _, _) in jop.weight_specs(
            [x.shape for x in ins]).items()}
    (jout, jgp, jgx), (tout, tgp, tgx) = run_op_pair(
        jop, top, params, ins, cots, compute)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, **OUT_TOL[compute])
    # the final state is the last step's h beside c
    np.testing.assert_array_equal(tout[1][:, :H], tout[0][:, -1])
    for w in params:
        assert rel(tgp[w], jgp[w]) <= GRAD_TOL[compute], w
    for i, (a, b) in enumerate(zip(tgx, jgx)):
        assert rel(a, b) <= GRAD_TOL[compute], f"input {i}"


def test_lstm_flops_match_jax():
    shapes = [(B, S, D)]
    jop, top = op_pair(JaxLSTMOp, LSTMOp, {"hidden_size": H}, "DT_FLOAT", 1)
    outs = top.infer_output_shapes(shapes)
    assert top.flops(shapes, outs) == jop.flops(shapes, outs) == \
        2 * B * S * (D * 4 * H + H * 4 * H)


def _nmt(ff, pkg):
    if pkg is fj:
        return jax_build_nmt(ff, JaxNMTConfig.tiny(8))
    return build_nmt(ff, NMTConfig.tiny(8))


def _nmt_data(seed=0):
    cfg = NMTConfig.tiny(8)
    rng = np.random.default_rng(seed)
    src = rng.integers(1, cfg.src_vocab, (8, cfg.src_len)).astype(np.int32)
    tgt = rng.integers(1, cfg.tgt_vocab, (8, cfg.tgt_len)).astype(np.int32)
    labels = rng.integers(1, cfg.tgt_vocab, (8 * cfg.tgt_len,)).astype(
        np.int32)
    return [src, tgt], labels


def test_nmt_tiny_loss_grads_and_one_step_match_jax():
    jff, tff = build_pair(_nmt, 8)
    cfg = NMTConfig.tiny(8)
    assert tff.pcg.nodes[tff.final_guid].out_shapes[0] == \
        (8 * cfg.tgt_len, cfg.tgt_vocab)
    assert set(tff.get_params_numpy()) == set(jff.params)
    xs, y = _nmt_data()
    check_loss_grads(jff, tff, xs, y)
    check_one_step(jff, tff, xs, y)


def test_lstm_graph_is_refused_by_the_engine():
    """Since the port serves LSTM graphs, the engine refuses only what the
    JAX engine refuses for them: the prefix cache asked for by name and
    chunked prefill (``ValueError`` naming LSTM). Left at its default, the
    prefix cache is off and the graph serves."""
    c = ft.FFConfig()
    c.batch_size = 2
    ff = ft.FFModel(c, device="cpu")
    ids = ff.create_tensor((2, 8), dtype=ft.DataType.DT_INT32)
    t = ff.embedding(ids, 20, 8)
    t, _ = ff.lstm(t, 8, name="lm_lstm")
    ff.dense(t, 20)
    ff.compile()
    with pytest.raises(ValueError, match="LSTM"):
        ft.serving.ServingEngine(ff, max_decode_len=8, prefix_cache="on")
    with pytest.raises(ValueError, match="LSTM"):
        ft.serving.ServingEngine(ff, max_decode_len=8, kv_block_size=4,
                                 prefill_chunk_tokens=4)
    out = ff.generate([[1, 2, 3]], max_new_tokens=2, max_decode_len=8)
    assert len(out[0]) == 2 and ff._serving_engine._prefix is None
