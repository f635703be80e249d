"""GPT-2-style decoder-only causal LM builder.

A copy of ``flexflow_tpu.models.gpt2``: the same FFModel calls build the
same layer names and weight layouts, so parameters carry between the two
packages 1:1. ``GPT2Config.small()`` is GPT-2 small at its published
widths (hidden 768, 12 heads, 12 layers, intermediate 3072, vocab 50257)
with the JAX package's 512-entry position table (the published model has
1024).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..ffconst import ActiMode, DataType
from ..model import FFModel


@dataclasses.dataclass
class GPT2Config:
    batch_size: int = 8
    seq_len: int = 512
    hidden: int = 768
    num_heads: int = 12
    num_layers: int = 12
    intermediate: int = 3072
    vocab_size: int = 50257
    dropout: float = 0.0

    @staticmethod
    def small() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def tiny(batch_size: int = 8) -> "GPT2Config":
        """CI-sized config for CPU-mesh tests and dry runs."""
        return GPT2Config(batch_size=batch_size, seq_len=16, hidden=64,
                          num_heads=4, num_layers=2, intermediate=128,
                          vocab_size=100)


def build_gpt2(ff: FFModel, cfg: GPT2Config):
    """Decoder-only LM: token + learned position embeddings, pre-LN blocks
    (ln -> causal MHA -> residual; ln -> gelu MLP -> residual), final LN,
    untied vocab head. Returns (input_ids tensor, logits tensor
    (b, s, vocab))."""
    ids = ff.create_tensor((cfg.batch_size, cfg.seq_len),
                           dtype=DataType.DT_INT32, name="input_ids")
    tok = ff.embedding(ids, cfg.vocab_size, cfg.hidden, name="wte")
    pos_ids = ff.constant(
        np.broadcast_to(np.arange(cfg.seq_len, dtype=np.int32),
                        (cfg.batch_size, cfg.seq_len)), name="pos_ids")
    pos = ff.embedding(pos_ids, cfg.seq_len, cfg.hidden, name="wpe")
    t = ff.add(tok, pos)
    for layer in range(cfg.num_layers):
        h = ff.layer_norm(t, axes=[2], name=f"h{layer}_ln1")
        attn = ff.multihead_attention(
            h, h, h, embed_dim=cfg.hidden, num_heads=cfg.num_heads,
            dropout=cfg.dropout, causal=True, name=f"h{layer}_attn")
        t = ff.add(t, attn)
        h = ff.layer_norm(t, axes=[2], name=f"h{layer}_ln2")
        m = ff.dense(h, cfg.intermediate, ActiMode.AC_MODE_GELU,
                     name=f"h{layer}_fc1")
        m = ff.dense(m, cfg.hidden, name=f"h{layer}_fc2")
        t = ff.add(t, m)
    t = ff.layer_norm(t, axes=[2], name="ln_f")
    logits = ff.dense(t, cfg.vocab_size, use_bias=False, name="lm_head")
    return ids, logits


def gpt2_param_count(cfg: GPT2Config) -> int:
    per_layer = (4 * cfg.hidden * cfg.hidden + cfg.hidden  # qkv+o (+bo)
                 + 2 * cfg.hidden * cfg.intermediate
                 + cfg.intermediate + cfg.hidden  # fc biases
                 + 4 * cfg.hidden)  # two layer norms
    emb = (cfg.vocab_size + cfg.seq_len) * cfg.hidden
    head = cfg.hidden * cfg.vocab_size
    return cfg.num_layers * per_layer + emb + head + 2 * cfg.hidden


def gpt2_train_flops_per_step(cfg: GPT2Config) -> int:
    """Model FLOPs per training step (fwd + bwd = 3x fwd), matmuls only."""
    tokens = cfg.batch_size * cfg.seq_len
    per_layer = (2 * tokens * 4 * cfg.hidden * cfg.hidden
                 + 2 * 2 * tokens * cfg.hidden * cfg.intermediate
                 + 2 * 2 * tokens * cfg.seq_len * cfg.hidden)
    head = 2 * tokens * cfg.hidden * cfg.vocab_size
    fwd = cfg.num_layers * per_layer + head
    return 3 * fwd
