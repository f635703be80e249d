"""The Transformer family of the port against the JAX package, on the CPU:
the OSDI'22 Transformer proxy (``build_transformer``) and its causal
decoder (``build_transformer_decoder``), both at ``TransformerConfig.tiny``
(batch 8 / 4, seq 16, hidden 32, 4 heads, 2 layers).

* The proxy, with and without layer norm: one training step's loss within
  1e-4 relative and every grad within 1e-4 relative norm (fp32), then one
  ``make_train_step`` (SGD 0.1) in each package, the params after it
  within 1e-5.
* The decoder (vocab 60, as ``tests/test_serving.py`` builds it) served
  greedily through ``FFModel.generate`` in both packages: the streams
  token for token equal, and the whole-sequence logits of each stream
  within 1e-4 of JAX's. Bitwise equality is not asked: the JAX package's
  own bitwise decode laws fail on this tree (ROADMAP, reference
  conditions).
"""
import numpy as np
import pytest

from flexflow_tpu.models import transformer as jt
import flexflow_tpu as fj
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import models as tmodels
from flexflow_tpu_torch.models import transformer as tt
from torch_seq_pairs import build_pair, check_loss_grads, check_one_step

LOGIT_ATOL = 1e-4


def _mod(pkg):
    return jt if pkg is fj else tt


@pytest.mark.parametrize("layernorm", [False, True])
def test_transformer_tiny_loss_grads_and_one_step_match_jax(layernorm):
    def build(ff, pkg):
        cfg = _mod(pkg).TransformerConfig.tiny(8)
        cfg.use_layernorm = layernorm
        return _mod(pkg).build_transformer(ff, cfg)

    jff, tff = build_pair(build, 8)
    assert set(tff.get_params_numpy()) == set(jff.params)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((8, 16, 32)).astype(np.float32)]
    y = rng.integers(0, 2, (8, 1)).astype(np.int32)
    check_loss_grads(jff, tff, xs, y)
    check_one_step(jff, tff, xs, y)


def test_decoder_greedy_streams_equal_jax():
    def build(ff, pkg):
        return _mod(pkg).build_transformer_decoder(
            ff, _mod(pkg).TransformerConfig.tiny(4), vocab_size=60)

    jff, tff = build_pair(build, 4)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 60, n).tolist() for n in (3, 6, 4, 5, 2)]
    kw = dict(max_new_tokens=8, max_decode_len=16)
    jout = jff.generate(prompts, **kw)
    tout = tff.generate(prompts, **kw)
    assert tout == jout
    assert all(len(o) == 8 for o in tout)
    jfwd = jff.executor.make_forward()
    for p, o in zip(prompts, tout):
        seq = np.zeros((4, 16), np.int32)
        seq[:, :len(p) + len(o)] = p + o
        want = np.asarray(jfwd(jff.params, [seq]))[0]
        got = tff.predict(seq)[0]
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_models_export_the_new_builders():
    """``models`` exports them as the JAX package's ``models`` does."""
    import flexflow_tpu.models as jmodels

    for name in ("TransformerConfig", "build_transformer", "build_moe_mlp",
                 "NMTConfig", "build_nmt"):
        assert hasattr(jmodels, name) and hasattr(tmodels, name), name
    assert tmodels.build_transformer_decoder is tt.build_transformer_decoder


def test_op_flops_match_jax():
    """Every op that counts its flops counts them as the JAX op does:
    attention, dense, LSTM and experts over the Transformer, NMT and MoE
    graphs (``train_flops_per_step``, the smoke's MFU, reads
    them)."""
    from flexflow_tpu.models import nmt as jn
    from flexflow_tpu_torch.models import nmt as tn

    def graphs(pkg):
        m, n = _mod(pkg), (jn if pkg is fj else tn)
        yield lambda ff: m.build_transformer(ff, m.TransformerConfig.tiny())
        yield lambda ff: n.build_nmt(ff, n.NMTConfig.tiny())
        yield lambda ff: m.build_moe_mlp(ff, batch_size=8, in_dim=12)
        yield lambda ff: ff.moe_experts(ff.create_tensor((8, 12)), 4, 2, 6)

    counted = set()
    for jb, tb in zip(graphs(fj), graphs(ft)):
        jff, tff = fj.FFModel(fj.FFConfig()), ft.FFModel(ft.FFConfig(),
                                                         device="cpu")
        jb(jff)
        tb(tff)
        jp, tp = jff.create_pcg(), tff.create_pcg()
        for jn_, tn_ in zip(jp.compute_nodes(), tp.compute_nodes()):
            assert jn_.name == tn_.name
            if not hasattr(tn_.op, "flops"):
                continue
            ins = [tp.nodes[g].out_shapes[i] for g, i in tn_.inputs]
            assert tn_.op.flops(ins, tn_.out_shapes) == \
                jn_.op.flops(ins, jn_.out_shapes), tn_.name
            counted.add(tn_.op.op_type.name)
    assert {"OP_MULTIHEAD_ATTENTION", "OP_LINEAR", "OP_LSTM",
            "OP_EXPERTS"} <= counted
