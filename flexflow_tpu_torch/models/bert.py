"""BERT-Large proxy model — the JAX package's flagship training config.

A copy of ``flexflow_tpu.models.bert`` (reference:
examples/python/native/bert_proxy_native.py:12-17: seq 512, hidden 1024,
16 heads, 24 layers, intermediate 4096): the same FFModel calls build the
same layer names and weight layouts, so parameters carry between the two
packages 1:1. Post-LN encoder blocks, a mean pooler and a softmax
classification head; the reference proxy trains against random labels.
"""
from __future__ import annotations

import dataclasses

from ..ffconst import ActiMode
from ..model import FFModel


@dataclasses.dataclass
class BertConfig:
    batch_size: int = 8
    seq_len: int = 512
    hidden: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    intermediate: int = 4096
    num_classes: int = 2
    dropout: float = 0.0  # reference proxy runs without dropout

    @staticmethod
    def large() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny(batch_size: int = 8) -> "BertConfig":
        """CI-sized config for CPU tests and dry runs."""
        return BertConfig(batch_size=batch_size, seq_len=16, hidden=64,
                          num_heads=4, num_layers=2, intermediate=128)


def build_bert(ff: FFModel, cfg: BertConfig):
    """Build the encoder stack; returns (input_tensor, probs_tensor)."""
    x = ff.create_tensor((cfg.batch_size, cfg.seq_len, cfg.hidden),
                         name="bert_input")
    t = x
    for layer in range(cfg.num_layers):
        attn = ff.multihead_attention(
            t, t, t, embed_dim=cfg.hidden, num_heads=cfg.num_heads,
            dropout=cfg.dropout, name=f"l{layer}_attn")
        t2 = ff.add(attn, t)
        t2 = ff.layer_norm(t2, axes=[2], name=f"l{layer}_ln1")
        ffn = ff.dense(t2, cfg.intermediate, ActiMode.AC_MODE_GELU,
                       name=f"l{layer}_fc1")
        ffn = ff.dense(ffn, cfg.hidden, name=f"l{layer}_fc2")
        t = ff.layer_norm(ff.add(ffn, t2), axes=[2], name=f"l{layer}_ln2")
    pooled = ff.mean(t, dims=[1], name="pool")
    logits = ff.dense(pooled, cfg.num_classes, name="cls")
    return x, ff.softmax(logits)


def bert_param_count(cfg: BertConfig) -> int:
    per_layer = (4 * cfg.hidden * cfg.hidden + cfg.hidden  # qkv+o (+bo)
                 + 2 * cfg.hidden * cfg.intermediate
                 + cfg.intermediate + cfg.hidden  # fc biases
                 + 4 * cfg.hidden)  # 2 layernorms
    head = cfg.hidden * cfg.num_classes + cfg.num_classes
    return cfg.num_layers * per_layer + head


def bert_train_flops_per_step(cfg: BertConfig) -> int:
    """Model FLOPs per training step (fwd+bwd = 3x fwd): 6*P*tokens for the
    matmuls + 12*L*B*S^2*H for attention scores/values (the MFU
    convention)."""
    tokens = cfg.batch_size * cfg.seq_len
    matmul = 6 * bert_param_count(cfg) * tokens
    attn = 12 * cfg.num_layers * cfg.batch_size * cfg.seq_len ** 2 * cfg.hidden
    return matmul + attn
