"""Keras-frontend preprocessing (a port of
``flexflow_tpu.frontends.keras_preprocessing``; reference:
python/flexflow/keras/preprocessing/ — the subset the example scripts use:
``text.Tokenizer.sequences_to_matrix`` for reuters, ``sequence.pad_sequences``
for imdb-style inputs)."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np


class Tokenizer:
    """reference: preprocessing/text.py Tokenizer (the modes
    sequences_to_matrix supports there: binary/count/freq)."""

    def __init__(self, num_words=None):
        self.num_words = num_words

    def sequences_to_matrix(self, sequences, mode: str = "binary"):
        assert self.num_words, "Tokenizer(num_words=...) required"
        m = np.zeros((len(sequences), self.num_words), dtype=np.float32)
        for i, seq in enumerate(sequences):
            for w in seq:
                if w < self.num_words:
                    if mode == "binary":
                        m[i, w] = 1.0
                    else:
                        m[i, w] += 1.0
        if mode == "freq":
            m = m / np.maximum(m.sum(axis=1, keepdims=True), 1.0)
        return m


def pad_sequences(sequences, maxlen=None, dtype="int32", padding="pre",
                  truncating="pre", value=0):
    """reference: preprocessing/sequence.py pad_sequences."""
    maxlen = maxlen or max(len(s) for s in sequences)
    out = np.full((len(sequences), maxlen), value, dtype=dtype)
    for i, seq in enumerate(sequences):
        seq = list(seq)
        if len(seq) > maxlen:
            seq = seq[-maxlen:] if truncating == "pre" else seq[:maxlen]
        if padding == "pre":
            out[i, maxlen - len(seq):] = seq
        else:
            out[i, :len(seq)] = seq
    return out


text = SimpleNamespace(Tokenizer=Tokenizer)
sequence = SimpleNamespace(pad_sequences=pad_sequences)
