"""MLP_Unify, XDL, and CANDLE-Uno model builders.

A copy of ``flexflow_tpu.models.misc`` (same builder calls, layer names
and weight layouts). Reference apps: examples/cpp/MLP_Unify/mlp.cc (two
8x8192 dense towers added then softmaxed), examples/cpp/XDL/xdl.cc (N
1M-entry embeddings + dense stack — an ads-CTR model like DLRM),
examples/cpp/candle_uno/candle_uno.cc (multi-tower drug-response regression: per-feature 8x4192 towers, concat,
4x4192 head, scalar output).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..ffconst import ActiMode, AggrMode, DataType
from ..model import FFModel


def build_mlp_unify(ff: FFModel, batch_size: int = 64,
                    input_dim: int = 1024,
                    hidden_dims: Sequence[int] = (8192,) * 8):
    """reference: examples/cpp/MLP_Unify/mlp.cc:33-53 — two parallel dense
    towers (ReLU except last), summed, softmax."""
    relu, none = ActiMode.AC_MODE_RELU, ActiMode.AC_MODE_NONE
    x1 = ff.create_tensor((batch_size, input_dim), name="mlp_in1")
    x2 = ff.create_tensor((batch_size, input_dim), name="mlp_in2")
    t1, t2 = x1, x2
    for i, h in enumerate(hidden_dims):
        acti = none if i + 1 == len(hidden_dims) else relu
        t1 = ff.dense(t1, h, acti, use_bias=False, name=f"t1_d{i}")
        t2 = ff.dense(t2, h, acti, use_bias=False, name=f"t2_d{i}")
    t = ff.add(t1, t2)
    return [x1, x2], ff.softmax(t)


def build_xdl(ff: FFModel, batch_size: int = 64,
              num_embeddings: int = 4, vocab_size: int = 1000000,
              sparse_feature_size: int = 64,
              dense_dims: Sequence[int] = (512, 512, 256, 1)):
    """reference: examples/cpp/XDL/xdl.cc — embedding bags (vocab 1e6,
    dim 64, sum-aggregated) concatenated then MLP to a scalar CTR logit."""
    relu, none = ActiMode.AC_MODE_RELU, ActiMode.AC_MODE_NONE
    sparse_inputs = []
    embedded = []
    for i in range(num_embeddings):
        s = ff.create_tensor((batch_size, 1), dtype=DataType.DT_INT32,
                             name=f"xdl_sparse_{i}")
        sparse_inputs.append(s)
        e = ff.embedding(s, vocab_size, sparse_feature_size,
                         AggrMode.AGGR_MODE_SUM, name=f"xdl_emb_{i}")
        embedded.append(e)
    t = ff.concat(embedded, axis=-1)
    for i, d in enumerate(dense_dims):
        acti = none if i + 1 == len(dense_dims) else relu
        t = ff.dense(t, d, acti, name=f"xdl_d{i}")
    return sparse_inputs, ff.sigmoid(t)


# CANDLE-Uno defaults (candle_uno.cc:29-46)
_UNO_FEATURE_SHAPES = {
    "dose": 1,
    "cell.rnaseq": 942,
    "drug.descriptors": 5270,
    "drug.fingerprints": 2048,
}
_UNO_INPUT_FEATURES = {
    "dose1": "dose",
    "dose2": "dose",
    "cell.rnaseq": "cell.rnaseq",
    "drug1.descriptors": "drug.descriptors",
    "drug1.fingerprints": "drug.fingerprints",
    "drug2.descriptors": "drug.descriptors",
    "drug2.fingerprints": "drug.fingerprints",
}


def build_candle_uno(ff: FFModel, batch_size: int = 64,
                     dense_layers: Sequence[int] = (4192,) * 4,
                     dense_feature_layers: Sequence[int] = (4192,) * 8,
                     feature_shapes: Optional[Dict[str, int]] = None,
                     input_features: Optional[Dict[str, str]] = None):
    """reference: examples/cpp/candle_uno/candle_uno.cc:104-131 — per-feature
    encoder towers (shared per feature *type*), concat, dense head, scalar
    regression output (MSE loss)."""
    relu, none = ActiMode.AC_MODE_RELU, ActiMode.AC_MODE_NONE
    feature_shapes = feature_shapes or dict(_UNO_FEATURE_SHAPES)
    input_features = input_features or dict(_UNO_INPUT_FEATURES)

    inputs = []
    # towers are shared per feature TYPE (candle_uno.cc:104-131 builds one
    # feature_model per type and reuses it for drug1/drug2): stack all inputs
    # of a type along batch, run the tower once, split back per key
    by_type: Dict[str, list] = {}
    order = []
    for key, ftype in input_features.items():
        dim = feature_shapes[ftype]
        x = ff.create_tensor((batch_size, dim),
                             name=f"uno_{key.replace('.', '_')}")
        inputs.append(x)
        by_type.setdefault(ftype, []).append(x)
        order.append((key, ftype))

    encoded_by_type: Dict[str, list] = {}
    for ftype, xs in by_type.items():
        safe = ftype.replace('.', '_')
        if ftype == "dose":  # dose passes through raw (candle_uno.cc:115-121)
            encoded_by_type[ftype] = list(xs)
            continue
        t = xs[0] if len(xs) == 1 else ff.concat(xs, axis=0)
        for i, h in enumerate(dense_feature_layers):
            t = ff.dense(t, h, relu, use_bias=False, name=f"enc_{safe}_d{i}")
        if len(xs) == 1:
            encoded_by_type[ftype] = [t]
        else:
            encoded_by_type[ftype] = ff.split(t, [batch_size] * len(xs),
                                              axis=0)
    counters = {ftype: 0 for ftype in by_type}
    encoded = []
    for key, ftype in order:
        encoded.append(encoded_by_type[ftype][counters[ftype]])
        counters[ftype] += 1
    t = ff.concat(encoded, axis=-1)
    for i, h in enumerate(dense_layers):
        t = ff.dense(t, h, relu, use_bias=False, name=f"head_d{i}")
    out = ff.dense(t, 1, none, use_bias=False, name="uno_out")
    return inputs, out
