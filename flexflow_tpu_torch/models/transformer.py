"""The Transformer encoder (the OSDI'22 BERT-proxy benchmark model), its
causal decoder for the serving engine, and the MoE MLP.

A copy of ``flexflow_tpu.models.transformer`` (reference:
examples/cpp/Transformer/transformer.cc:33-85 — 12 layers, hidden 1024,
16 heads, seq 512; each layer MHA + a two-layer FFN, no layer norm in the
reference's proxy, optional here; examples/cpp/mixture_of_experts/moe.cc
— an MNIST MLP with an MoE layer): the same FFModel calls build the same
layer names and weight layouts, so parameters carry between the two
packages 1:1. ``build_transformer_decoder`` is the autoregressive member
of the family: the same block stack with causal self-attention, token and
position embeddings and a per-token vocabulary head.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..ffconst import ActiMode, DataType
from ..model import FFModel


@dataclasses.dataclass
class TransformerConfig:
    batch_size: int = 8
    seq_len: int = 512
    hidden: int = 1024
    num_heads: int = 16
    num_layers: int = 12
    use_layernorm: bool = False  # the reference proxy omits LN
    dropout: float = 0.0  # attention dropout (in the flash kernels)

    @staticmethod
    def tiny(batch_size: int = 8) -> "TransformerConfig":
        return TransformerConfig(batch_size=batch_size, seq_len=16, hidden=32,
                                 num_heads=4, num_layers=2)


def build_transformer(ff: FFModel, cfg: TransformerConfig):
    """reference transformer.cc create_attention_encoder: MHA ->
    dense(relu) -> dense, then a mean over the sequence and a 2-way
    softmax head. Returns (input tensor, probs (batch, 2))."""
    x = ff.create_tensor((cfg.batch_size, cfg.seq_len, cfg.hidden),
                         name="transformer_input")
    t = x
    for layer in range(cfg.num_layers):
        attn = ff.multihead_attention(t, t, t, embed_dim=cfg.hidden,
                                      num_heads=cfg.num_heads,
                                      dropout=cfg.dropout,
                                      name=f"t{layer}_attn")
        if cfg.use_layernorm:
            attn = ff.layer_norm(ff.add(attn, t), axes=[2],
                                 name=f"t{layer}_ln1")
        h = ff.dense(attn, cfg.hidden, ActiMode.AC_MODE_RELU,
                     name=f"t{layer}_fc1")
        h = ff.dense(h, cfg.hidden, name=f"t{layer}_fc2")
        t = ff.layer_norm(ff.add(h, attn), axes=[2], name=f"t{layer}_ln2") \
            if cfg.use_layernorm else h
    pooled = ff.mean(t, dims=[1], name="pool")
    logits = ff.dense(pooled, 2, name="head")
    return x, ff.softmax(logits)


def build_transformer_decoder(ff: FFModel, cfg: TransformerConfig,
                              vocab_size: int = 256):
    """Causal decoder-only variant of the proxy: token + learned position
    embeddings, the same MHA/FFN block stack with ``causal=True``
    attention, and an untied per-token vocabulary head. Returns
    (input_ids tensor, logits tensor (b, s, vocab)), the shape the
    serving engine's prefill/decode split needs."""
    ids = ff.create_tensor((cfg.batch_size, cfg.seq_len),
                           dtype=DataType.DT_INT32, name="dec_input_ids")
    tok = ff.embedding(ids, vocab_size, cfg.hidden, name="dec_wte")
    pos_ids = ff.constant(
        np.broadcast_to(np.arange(cfg.seq_len, dtype=np.int32),
                        (cfg.batch_size, cfg.seq_len)), name="dec_pos_ids")
    pos = ff.embedding(pos_ids, cfg.seq_len, cfg.hidden, name="dec_wpe")
    t = ff.add(tok, pos)
    for layer in range(cfg.num_layers):
        attn = ff.multihead_attention(t, t, t, embed_dim=cfg.hidden,
                                      num_heads=cfg.num_heads,
                                      dropout=cfg.dropout, causal=True,
                                      name=f"d{layer}_attn")
        if cfg.use_layernorm:
            attn = ff.layer_norm(ff.add(attn, t), axes=[2],
                                 name=f"d{layer}_ln1")
        h = ff.dense(attn, cfg.hidden, ActiMode.AC_MODE_RELU,
                     name=f"d{layer}_fc1")
        h = ff.dense(h, cfg.hidden, name=f"d{layer}_fc2")
        t = ff.layer_norm(ff.add(h, attn), axes=[2], name=f"d{layer}_ln2") \
            if cfg.use_layernorm else h
    logits = ff.dense(t, vocab_size, use_bias=False, name="dec_head")
    return ids, logits


def build_moe_mlp(ff: FFModel, batch_size: int = 64, in_dim: int = 784,
                  num_classes: int = 10, num_exp: int = 8,
                  num_select: int = 2, expert_hidden: int = 64,
                  alpha: float = 2.0, lambda_bal: float = 0.04):
    """reference: examples/cpp/mixture_of_experts/moe.cc top_level_task."""
    x = ff.create_tensor((batch_size, in_dim), name="moe_input")
    t = ff.dense(x, 64, ActiMode.AC_MODE_RELU)
    t = ff.moe(t, num_exp=num_exp, num_select=num_select,
               expert_hidden_size=expert_hidden, alpha=alpha,
               lambda_bal=lambda_bal)
    t = ff.dense(t, num_classes)
    return x, ff.softmax(t)
