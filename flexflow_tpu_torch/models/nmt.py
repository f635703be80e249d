"""NMT: an LSTM encoder-decoder sequence-to-sequence model.

A copy of ``flexflow_tpu.models.nmt`` (reference: nmt/rnn.h:31-32, the
legacy NMT app's batch, hidden, embed and vocab sizes, layers and
sequence length): the same FFModel calls build the same layer names and
weight layouts, so parameters carry between the two packages 1:1.
Encoder embed + stacked LSTM; decoder embed + stacked LSTM, each layer
started from the matching encoder layer's final state; a projection to
the target vocabulary and a softmax, trained with teacher forcing.
"""
from __future__ import annotations

import dataclasses

from ..ffconst import AggrMode, DataType
from ..model import FFModel


@dataclasses.dataclass
class NMTConfig:
    batch_size: int = 64
    src_vocab: int = 32000
    tgt_vocab: int = 32000
    embed_size: int = 1024   # rnn.h embedSize
    hidden_size: int = 1024  # rnn.h hiddenSize
    num_layers: int = 2      # rnn.h numLayers
    src_len: int = 40        # rnn.h seqLength
    tgt_len: int = 40

    @staticmethod
    def tiny(batch_size: int = 8) -> "NMTConfig":
        return NMTConfig(batch_size=batch_size, src_vocab=100, tgt_vocab=100,
                         embed_size=16, hidden_size=16, num_layers=2,
                         src_len=6, tgt_len=5)


def build_nmt(ff: FFModel, cfg: NMTConfig):
    """Returns ([src_tokens, tgt_tokens], per-token probs of shape
    (batch*tgt_len, tgt_vocab)). Loss: sparse categorical cross-entropy
    over flattened (batch*tgt_len,) labels. Drive it with
    ``ff.executor.make_train_step()`` and ``labels.reshape(-1)``: ``fit``
    slices labels by batch rows, so flattened token labels do not fit it.
    The port's step updates ``ff.params`` / ``ff.opt_state`` in place."""
    src = ff.create_tensor((cfg.batch_size, cfg.src_len),
                           dtype=DataType.DT_INT32, name="nmt_src")
    tgt = ff.create_tensor((cfg.batch_size, cfg.tgt_len),
                           dtype=DataType.DT_INT32, name="nmt_tgt")

    # encoder
    t = ff.embedding(src, cfg.src_vocab, cfg.embed_size,
                     AggrMode.AGGR_MODE_NONE, name="enc_embed")
    states = []
    for i in range(cfg.num_layers):
        t, state = ff.lstm(t, cfg.hidden_size, name=f"enc_lstm{i}")
        states.append(state)

    # decoder: each layer starts from the matching encoder layer's final
    # state (nmt.cc's chunk-to-chunk hidden hand-off)
    d = ff.embedding(tgt, cfg.tgt_vocab, cfg.embed_size,
                     AggrMode.AGGR_MODE_NONE, name="dec_embed")
    for i in range(cfg.num_layers):
        d, _ = ff.lstm(d, cfg.hidden_size, initial_state=states[i],
                       name=f"dec_lstm{i}")

    logits = ff.dense(d, cfg.tgt_vocab, name="nmt_proj")
    # flatten (batch, tgt_len) so sparse-CCE sees per-token rows
    logits = ff.reshape(logits, (cfg.batch_size * cfg.tgt_len, cfg.tgt_vocab))
    probs = ff.softmax(logits)
    return [src, tgt], probs

