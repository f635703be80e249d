"""Hugging Face models through the port's torch.fx frontend, against the JAX
package's and against transformers' own forward, on the CPU.

Each model is built from a config with random initial weights (nothing is
downloaded; ``torch.manual_seed`` fixes them), traced by both packages
through ``PyTorchModel(is_hf_model=True)`` (the HF tracer under
``_hf_trace_compat``), compiled with the output of interest as the final
tensor, and given the module's weights by ``copy_torch_weights``. Token
ids come from numpy's ``default_rng``. Checked (fp32): both packages build
the same layer graph, the port's outputs are within 1e-5 of JAX's
(relative 1e-4: a tiny model's hidden states are O(1)), and within the
JAX tests' 2e-3 band of transformers' forward. The families: BERT
(``last_hidden_state`` and the pooler), DistilBERT, GPT-2 with its LM
head, GPT-Neo and T5 seq2seq.
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import flexflow_tpu as fj  # noqa: E402
import flexflow_tpu_torch as ft  # noqa: E402
from torch_frontend_pairs import fx  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
HF_BAND = dict(rtol=2e-3, atol=2e-3)
B, S = 2, 8


def _bert():
    from transformers import BertConfig, BertModel

    return BertModel(BertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, vocab_size=100, max_position_embeddings=16,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))


def _distilbert():
    from transformers import DistilBertConfig, DistilBertModel

    return DistilBertModel(DistilBertConfig(
        dim=32, n_layers=2, n_heads=4, hidden_dim=64, vocab_size=100,
        max_position_embeddings=16, dropout=0.0, attention_dropout=0.0))


def _gpt2_lm():
    from transformers import GPT2Config, GPT2LMHeadModel

    return GPT2LMHeadModel(GPT2Config(
        n_embd=32, n_layer=1, n_head=4, n_positions=16, vocab_size=64,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0))


def _gpt_neo():
    from transformers import GPTNeoConfig, GPTNeoModel

    return GPTNeoModel(GPTNeoConfig(
        hidden_size=32, num_layers=2, num_heads=4,
        attention_types=[[["global"], 2]], max_position_embeddings=16,
        vocab_size=100, embed_dropout=0.0, attention_dropout=0.0,
        resid_dropout=0.0))


def _t5():
    from transformers import T5Config, T5ForConditionalGeneration

    return T5ForConditionalGeneration(T5Config(
        vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_heads=4, decoder_start_token_id=0, dropout_rate=0.0))


# model builder, traced input names, output of interest
CASES = {
    "bert": (_bert, ["input_ids"], "last_hidden_state"),
    "bert_pooler": (_bert, ["input_ids"], "pooler_output"),
    "distilbert": (_distilbert, ["input_ids"], "last_hidden_state"),
    "gpt2_lm_head": (_gpt2_lm, ["input_ids"], "logits"),
    "gpt_neo": (_gpt_neo, ["input_ids"], "last_hidden_state"),
    "t5_seq2seq": (_t5, ["input_ids", "attention_mask",
                         "decoder_input_ids"], "logits"),
}


def _run(pkg, module, names, out_key, feeds):
    config = pkg.FFConfig()
    config.batch_size = B
    ff = pkg.FFModel(config) if pkg is fj else \
        pkg.FFModel(config, device="cpu")
    ins = [ff.create_tensor((B, S), pkg.DataType.DT_INT32, name=n)
           for n in names]
    outputs = fx(pkg).PyTorchModel(module, is_hf_model=True).torch_to_ff(
        ff, ins, input_names=names)
    assert isinstance(outputs, dict) and out_key in outputs, outputs
    ff.compile(loss_type=pkg.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
               final_tensor=outputs[out_key])
    fx(pkg).copy_torch_weights(ff)
    layers = [(layer.name, layer.op_type.name) for layer in ff._layers]
    return layers, ff.predict(feeds if len(feeds) > 1 else feeds[0],
                              batch_size=B)


@pytest.mark.parametrize("case", sorted(CASES))
def test_hf_model_matches_jax_and_transformers(case):
    build, names, out_key = CASES[case]
    torch.manual_seed(0)
    module = build().eval()
    vocab = module.config.vocab_size
    rng = np.random.default_rng(0)
    feeds = []
    for n in names:
        if n == "attention_mask":
            feeds.append(np.ones((B, S), np.int32))
        else:
            feeds.append(rng.integers(0, vocab, (B, S)).astype(np.int32))
    jlayers, want = _run(fj, module, names, out_key, feeds)
    tlayers, got = _run(ft, module, names, out_key, feeds)
    assert tlayers == jlayers
    np.testing.assert_allclose(got, want, **TOL)
    with torch.no_grad():
        ref = getattr(module(**{n: torch.from_numpy(f.astype(np.int64))
                                for n, f in zip(names, feeds)}),
                      out_key).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **HF_BAND)
