"""DLRM: embedding bags + bottom/top MLPs + feature interaction.

A copy of ``flexflow_tpu.models.dlrm`` (same builder calls, layer names
and weight layouts). Reference: examples/cpp/DLRM/dlrm.cc — sparse inputs
feed embedding bags (SUM aggregation), dense features the bottom MLP; the
interaction layer concatenates and takes pairwise dot products via
batch_matmul; top MLP -> sigmoid. The table-parallel placements of the
reference's strategies come with the multi-GPU slice.
"""
from __future__ import annotations

from typing import Sequence

from ..ffconst import ActiMode, AggrMode, DataType
from ..model import FFModel


def build_dlrm(ff: FFModel, batch_size: int = 64,
               embedding_sizes: Sequence[int] = (1000,) * 8,
               embedding_bag_size: int = 1, embedding_dim: int = 64,
               dense_dim: int = 16,
               mlp_bot: Sequence[int] = (512, 256, 64),
               mlp_top: Sequence[int] = (512, 256, 1)):
    """Returns (sparse_inputs, dense_input, prediction)."""
    sparse_inputs = []
    emb_outputs = []
    for i, n_entries in enumerate(embedding_sizes):
        s = ff.create_tensor((batch_size, embedding_bag_size),
                             DataType.DT_INT64, name=f"sparse_{i}")
        sparse_inputs.append(s)
        emb = ff.embedding(s, n_entries, embedding_dim,
                           AggrMode.AGGR_MODE_SUM, name=f"emb_{i}")
        emb_outputs.append(emb)

    dense_input = ff.create_tensor((batch_size, dense_dim), name="dense_input")
    t = dense_input
    for i, h in enumerate(mlp_bot):
        t = ff.dense(t, h, ActiMode.AC_MODE_RELU, name=f"bot_{i}")
    bot_out = t  # (batch, embedding_dim) if mlp_bot[-1] == embedding_dim

    # interact_features (dlrm.cc): concat features, pairwise dots
    features = emb_outputs + [bot_out]
    n_f = len(features)
    cat = ff.concat(features, axis=1)  # (batch, n_f * dim)
    mat = ff.reshape(cat, (batch_size, n_f, embedding_dim))
    matT = ff.transpose(mat, (0, 2, 1))
    inter = ff.batch_matmul(mat, matT)  # (batch, n_f, n_f)
    inter_flat = ff.reshape(inter, (batch_size, n_f * n_f))
    top_in = ff.concat([bot_out, inter_flat], axis=1)

    t = top_in
    for i, h in enumerate(mlp_top[:-1]):
        t = ff.dense(t, h, ActiMode.AC_MODE_RELU, name=f"top_{i}")
    out = ff.dense(t, mlp_top[-1], ActiMode.AC_MODE_SIGMOID, name="top_out")
    return sparse_inputs, dense_input, out
