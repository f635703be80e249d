"""PyTorch frontend: torch.fx symbolic trace -> FFModel builder calls.

A port of ``flexflow_tpu.frontends.torch_fx``, itself a rebuild of the
reference's torch frontend (python/flexflow/torch/model.py, 2607 LoC):
``PyTorchModel`` traces an ``nn.Module`` with torch.fx (the reference also
supports HuggingFace's symbolic trace, :2427) and walks the fx graph
emitting FFModel ops (``torch_to_ff``, :2496). Weights are copied from the
torch module so numerics match — the basis of the reference's strongest
correctness tier, tests/align (SURVEY §4). The same graph, layer names and
``.ff`` lines as the JAX package's, so a ``.ff`` file written by one
package is read by the other. ``F.scaled_dot_product_attention`` becomes
``FFModel.sdpa``, whose op takes the flash kernels on the card when it has
no mask and no scale.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import numpy as np

from ..ffconst import ActiMode, AggrMode, DataType, PoolType
from ..model import FFModel
from ..tensor import Tensor


@contextlib.contextmanager
def _hf_trace_compat():
    """Context manager unblocking decoder-only HF fx tracing (reference
    traces the HF family generally, python/flexflow/torch/model.py:2427;
    upstream transformers >= 4.5x breaks it in two places):

    1. ``masking_utils._vmap_for_bhqkv`` builds attention masks through
       ``torch.vmap``, which cannot map over HFProxy inputs. Swapped for a
       broadcasting equivalent — every stock mask_function is elementwise
       arithmetic / advanced indexing, so reshaping the index vectors to
       (b,1,1,1)/(1,h,1,1)/(1,1,q,1)/(1,1,1,kv) computes the identical
       mask.
    2. ``(*states.shape[:-1], -1, head_dim)`` unpacks a shape proxy, which
       ``Tracer.iter`` rejects. When the proxy's installed metadata is a
       concrete ``torch.Size``, iterate SYMBOLIC ``obj[i]`` getitems (not
       the metadata values — those are the tracer's dummy dims and must
       not be baked into the graph).

    Both patches are restored on exit; eager execution is untouched.

    Known-good families under transformers 4.57: BERT, DistilBERT, T5/mT5,
    GPT-2 (+LMHead), GPT-Neo. Still blocked upstream by OTHER layers:
    OPT (HF fx bytecode wrapping: "co_varnames is too small") and
    LLaMA-style models (@check_model_inputs decorator dereferences kwargs
    that torch.fx passes as None).
    """
    import torch

    try:
        from transformers import masking_utils
        from transformers.utils import fx as hf_fx
    except ImportError:
        yield
        return

    def broadcast_for_bhqkv(mask_function, bh_indices=True):
        def fn(batch_idx, head_idx, q_idx, kv_idx):
            if bh_indices:
                q = q_idx.reshape(1, 1, -1, 1)
                kv = kv_idx.reshape(1, 1, 1, -1)
                if batch_idx is not None:
                    batch_idx = batch_idx.reshape(-1, 1, 1, 1)
                if head_idx is not None:
                    head_idx = head_idx.reshape(1, -1, 1, 1)
            else:
                q = q_idx.reshape(-1, 1)
                kv = kv_idx.reshape(1, -1)
            return mask_function(batch_idx, head_idx, q, kv)
        return fn

    orig_vmap = getattr(masking_utils, "_vmap_for_bhqkv", None)
    orig_iter = hf_fx.HFTracer.iter

    def iter_with_meta(self, obj):
        meta = getattr(obj, "_metadata", None)
        if isinstance(meta, (torch.Size, tuple)):
            return iter([obj[i] for i in range(len(meta))])
        return orig_iter(self, obj)

    if orig_vmap is not None:
        masking_utils._vmap_for_bhqkv = broadcast_for_bhqkv
    hf_fx.HFTracer.iter = iter_with_meta
    try:
        yield
    finally:
        if orig_vmap is not None:
            masking_utils._vmap_for_bhqkv = orig_vmap
        hf_fx.HFTracer.iter = orig_iter


class PyTorchModel:
    """reference: python/flexflow/torch/model.py:2408."""

    def __init__(self, module, is_hf_model: bool = False):
        self.module = module
        self.is_hf_model = is_hf_model

    def torch_to_ff(self, ffmodel: FFModel, input_tensors: List[Tensor],
                    input_names: Optional[List[str]] = None):
        """Trace the module and emit FFModel ops; returns output tensors — a
        list, or a dict for HF models returning ModelOutput dicts (reference:
        torch_to_ff, model.py:2496; hf_symbolic_trace support :2427).

        Shape arithmetic and mask plumbing in the traced graph (size/getitem/
        ones/expand/masked_fill on host values) are evaluated eagerly as
        numpy; only real tensor compute becomes graph ops. Traced buffers
        (position_ids) surface as OP_CONSTANT nodes."""
        import torch
        import torch.fx as fx

        if self.is_hf_model:
            from transformers.utils.fx import symbolic_trace as hf_trace

            with _hf_trace_compat():
                traced = hf_trace(self.module,
                                  input_names=input_names or ["input_ids"])
        else:
            traced = fx.symbolic_trace(self.module)

        env: Dict[str, Any] = {}
        inputs = list(input_tensors)
        outputs: Any = []
        modules = dict(traced.named_modules())

        for node in traced.graph.nodes:
            if node.op == "placeholder":
                env[node.name] = inputs.pop(0)
            elif node.op == "call_module":
                mod = modules[node.target]
                env[node.name] = _convert_module(
                    ffmodel, mod, _args(env, node.args), node.target)
            elif node.op == "call_function" or node.op == "call_method":
                env[node.name] = _convert_function(
                    ffmodel, node, _args(env, node.args),
                    {k: _lookup(env, v) for k, v in node.kwargs.items()})
                if node.op == "call_function" and \
                        getattr(node.target, "__name__", "") == "setitem":
                    # host setitem may have had to copy a read-only view;
                    # later uses reference the SOURCE node, so rebind it
                    src = node.args[0]
                    if isinstance(src, fx.Node):
                        env[src.name] = env[node.name]
            elif node.op == "get_attr":
                attr = _fetch_attr(self.module, node.target)
                if isinstance(attr, torch.Tensor):
                    attr = _np(attr)  # buffers stay eager until consumed
                env[node.name] = attr
            elif node.op == "output":
                out = node.args[0]
                if isinstance(out, dict):
                    outputs = {k: _lookup(env, v) for k, v in out.items()}
                elif isinstance(out, (tuple, list)):
                    outputs = [_lookup(env, o) for o in out]
                else:
                    outputs = [_lookup(env, out)]
        return outputs

    def apply(self, ffmodel: FFModel, input_tensors: List[Tensor]):
        return self.torch_to_ff(ffmodel, input_tensors)

    # ---- .ff model file format (reference: torch/model.py torch_to_string
    # :2597 / file_to_ff :2540 — "name; in,; out,; OPTYPE; params..." lines,
    # IR_DELIMITER "; ", INOUT_NODE_DELIMITER ",") ------------------------
    def torch_to_string(self) -> List[str]:
        """Serialize the traced graph to .ff IR lines (reference:
        PyTorchModel.torch_to_string). Field orders per node type match the
        reference's parse() implementations so files interchange."""
        import torch.fx as fx

        traced = fx.symbolic_trace(self.module)
        modules = dict(traced.named_modules())
        lines = []
        for node in traced.graph.nodes:
            lines.append(_node_to_ir(node, modules))
        return [ln for ln in lines if ln is not None]

    def torch_to_file(self, filename: str) -> None:
        """reference: torch/model.py:2597."""
        with open(filename, "w") as f:
            for line in self.torch_to_string():
                f.write(line + "\n")

    @staticmethod
    def file_to_ff(filename: str, ffmodel: FFModel,
                   input_tensors: List[Tensor]):
        """Rebuild an FFModel graph from a .ff file (reference:
        torch/model.py:2540 — per-line dispatch on the OPTYPE field)."""
        with open(filename) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        node_to_output: Dict[str, Any] = {}
        output_tensors: List[Tensor] = []
        input_index = 0
        for line in lines:
            items = [s.strip() for s in line.split(";")]
            name, in_s, _out_s, op = items[0], items[1], items[2], items[3]
            innodes = [s for s in in_s.split(",") if s.strip()]
            ins = [node_to_output[n] for n in innodes]
            if op == "INPUT":
                node_to_output[name] = input_tensors[input_index]
                input_index += 1
                continue
            if op == "OUTPUT":
                output_tensors.extend(ins)
                continue
            node_to_output[name] = _ir_to_op(ffmodel, op, name, ins, items)
        return output_tensors


_IR_DELIM = "; "


def _io_str(names) -> str:
    return ",".join(names) + "," if names else ""


def _node_to_ir(node, modules) -> Optional[str]:
    """One fx node -> one .ff line (field orders: reference torch/model.py
    LinearNode.parse :253, Conv2dNode :301, Pool2dNode :372, EmbeddingNode,
    DropoutMNode, ConcatNode, module activations)."""
    import operator

    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    ins = [a.name for a in node.args
           if hasattr(a, "name") and not isinstance(a, str)] \
        if node.op != "output" else None
    outs = [u.name for u in node.users]

    def line(op: str, *params) -> str:
        return _IR_DELIM.join([node.name, _io_str(ins), _io_str(outs), op]
                              + [str(p) for p in params])

    if node.op == "placeholder":
        return line("INPUT")
    if node.op == "output":
        args = node.args[0]
        args = args if isinstance(args, (tuple, list)) else (args,)
        ins = [a.name for a in args if hasattr(a, "name")]
        return _IR_DELIM.join([node.name, _io_str(ins), "", "OUTPUT"])
    if node.op == "call_module":
        mod = modules[node.target]
        if isinstance(mod, nn.Linear):
            return line("LINEAR", mod.out_features,
                        ActiMode.AC_MODE_NONE.value,
                        int(mod.bias is not None))
        if isinstance(mod, nn.Conv2d):
            return line("CONV2D", mod.out_channels, mod.kernel_size[0],
                        mod.kernel_size[1], mod.stride[0], mod.stride[1],
                        mod.padding[0], mod.padding[1],
                        ActiMode.AC_MODE_NONE.value, mod.groups,
                        int(mod.bias is not None))
        if isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
            k = mod.kernel_size if isinstance(mod.kernel_size, int) \
                else mod.kernel_size[0]
            st = mod.stride if isinstance(mod.stride, int) else \
                (mod.stride[0] if mod.stride else k)
            p = mod.padding if isinstance(mod.padding, int) \
                else mod.padding[0]
            pt = PoolType.POOL_MAX if isinstance(mod, nn.MaxPool2d) \
                else PoolType.POOL_AVG
            return line("POOL2D", k, st, p, pt.value,
                        ActiMode.AC_MODE_NONE.value)
        if isinstance(mod, nn.BatchNorm2d):
            return line("BATCH_NORM")
        if isinstance(mod, nn.LayerNorm):
            return line("LAYER_NORM")
        if isinstance(mod, nn.Embedding):
            return line("EMBEDDING", mod.num_embeddings, mod.embedding_dim)
        if isinstance(mod, nn.Dropout):
            return line("DROPOUT", mod.p)
        if isinstance(mod, nn.Flatten):
            return line("FLAT")
        simple = {nn.ReLU: "RELU", nn.Sigmoid: "SIGMOID", nn.Tanh: "TANH",
                  nn.GELU: "GELU", nn.Identity: "IDENTITY",
                  nn.Softmax: "SOFTMAX"}
        for cls, opname in simple.items():
            if isinstance(mod, cls):
                return line(opname)
        raise NotImplementedError(
            f".ff export: module {type(mod).__name__}")
    if node.op in ("call_function", "call_method"):
        t = node.target
        if t in (operator.add, torch.add):
            return line("ADD")
        if t in (operator.mul, torch.mul):
            return line("MULTIPLY")
        if t is torch.cat:
            tensors = node.args[0]
            ins = [a.name for a in tensors]
            axis = node.kwargs.get("dim", node.args[1]
                                   if len(node.args) > 1 else 0)
            return line("CONCAT", axis)
        if t is torch.flatten or t == "flatten":
            return line("FLAT")
        if t in (F.relu, torch.relu) or t == "relu":
            return line("RELU")
        if t is F.gelu or t == "gelu":
            return line("GELU")
        if t in (torch.sigmoid, F.sigmoid) or t == "sigmoid":
            return line("SIGMOID")
        if t in (torch.tanh, F.tanh) or t == "tanh":
            return line("TANH")
        if t in (F.softmax, torch.softmax) or t == "softmax":
            return line("SOFTMAX")
        raise NotImplementedError(f".ff export: function {t}")
    raise NotImplementedError(f".ff export: node op {node.op}")


def _ir_to_op(ffmodel: FFModel, op: str, name: str, ins, items):
    """One .ff line -> one FFModel builder call (reference string_to_ff
    field orders: LINEAR items[4:7]=out_dim/acti/bias, CONV2D items[4:14],
    POOL2D items[4:9], EMBEDDING items[4:6], DROPOUT items[4], CONCAT
    items[4])."""
    if op == "LINEAR":
        return ffmodel.dense(ins[0], int(items[4]),
                             activation=ActiMode(int(items[5])),
                             use_bias=bool(int(items[6])), name=name)
    if op == "CONV2D":
        return ffmodel.conv2d(
            ins[0], int(items[4]), int(items[5]), int(items[6]),
            int(items[7]), int(items[8]), int(items[9]), int(items[10]),
            activation=ActiMode(int(items[11])), groups=int(items[12]),
            use_bias=bool(int(items[13])), name=name)
    if op == "POOL2D":
        k, st, p = int(items[4]), int(items[5]), int(items[6])
        return ffmodel.pool2d(ins[0], k, k, st, st, p, p,
                              PoolType(int(items[7])), name=name)
    if op == "EMBEDDING":
        return ffmodel.embedding(ins[0], int(items[4]), int(items[5]),
                                 AggrMode.AGGR_MODE_NONE, name=name)
    if op == "DROPOUT":
        return ffmodel.dropout(ins[0], rate=float(items[4]), name=name)
    if op == "CONCAT":
        return ffmodel.concat(list(ins), axis=int(items[4]), name=name)
    if op == "BATCH_NORM":
        return ffmodel.batch_norm(ins[0], relu=False, name=name)
    if op == "LAYER_NORM":
        # the reference importer degrades this to identity (its layernorm
        # was unsupported, model.py LayerNormNode.string_to_ff); here the
        # real op exists, normalized over the trailing dim
        return ffmodel.layer_norm(ins[0], axes=[-1], name=name)
    if op == "ADD":
        return ffmodel.add(ins[0], ins[1], name=name)
    if op == "MULTIPLY":
        return ffmodel.multiply(ins[0], ins[1], name=name)
    simple = {"RELU": "relu", "SIGMOID": "sigmoid", "TANH": "tanh",
              "GELU": "gelu", "IDENTITY": "identity", "FLAT": "flat",
              "SOFTMAX": "softmax"}
    if op in simple:
        return getattr(ffmodel, simple[op])(ins[0], name=name)
    raise NotImplementedError(f".ff import: op {op}")


# module-level alias matching the reference (model.py:2607)
file_to_ff = PyTorchModel.file_to_ff


def _args(env, args):
    return [_lookup(env, a) for a in args]


def _lookup(env, a):
    import torch.fx as fx

    if isinstance(a, fx.Node):
        return env[a.name]
    if isinstance(a, (tuple, list)):
        return type(a)(_lookup(env, x) for x in a)
    if isinstance(a, slice):  # traced shapes appear inside slice bounds
        return slice(_lookup(env, a.start), _lookup(env, a.stop),
                     _lookup(env, a.step))
    return a


def _fetch_attr(module, target: str):
    obj = module
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _set_weight(ffmodel: FFModel, layer_out: Tensor, arrays: Dict[str, np.ndarray]):
    """Stash torch weights for copy after compile()."""
    layer = layer_out.owner_layer
    pending = getattr(ffmodel, "_pending_torch_weights", None)
    if pending is None:
        pending = {}
        ffmodel._pending_torch_weights = pending
    pending[layer.name] = arrays


def copy_torch_weights(ffmodel: FFModel) -> None:
    """Copy traced-module weights into the compiled model's params (call after
    ffmodel.compile). Goes through ``FFModel.set_params_numpy``, which drops
    the captured step programs (they hold the old tensors' addresses),
    keeps a mesh rank's shards and starts fresh optimizer moments, so a
    later ``fit`` trains the copied weights."""
    pending = getattr(ffmodel, "_pending_torch_weights", {})
    if not pending:
        return
    params = ffmodel.get_params_numpy()
    for lname, arrays in pending.items():
        if lname not in params:
            continue
        for wname, arr in arrays.items():
            cur = params[lname][wname]
            arr = np.asarray(arr, dtype=cur.dtype)
            assert arr.shape == cur.shape, (lname, wname, arr.shape, cur.shape)
            params[lname][wname] = arr
    ffmodel.set_params_numpy(params)


def _host_cmp_table():
    import operator

    import torch

    # NOTE: no operator.eq here — the dedicated eq branch keeps python
    # scalar/tuple == semantics (shape checks must yield a bool, not an
    # elementwise array)
    return {operator.lt: np.less, operator.gt: np.greater,
            operator.le: np.less_equal, operator.ge: np.greater_equal,
            operator.ne: np.not_equal,
            torch.lt: np.less, torch.gt: np.greater,
            torch.le: np.less_equal, torch.ge: np.greater_equal,
            torch.ne: np.not_equal, torch.eq: np.equal}


try:
    _HOST_CMP = _host_cmp_table()
except ImportError:  # torch not installed: frontend import stays lazy
    _HOST_CMP = {}


def _is_ff(v) -> bool:
    return isinstance(v, Tensor)


def _as_ff(ffmodel: FFModel, v, int_ids: bool = False):
    """Promote an eager numpy/scalar value to a graph constant when it meets
    real tensor compute."""
    if _is_ff(v):
        return v
    arr = np.asarray(v)
    if int_ids and arr.dtype != np.int32:
        # int32 ids, as the JAX package casts them, so both build one graph
        arr = arr.astype(np.int32)
    return ffmodel.constant(arr)


def _torch_dtype_of(v):
    """torch dtype of a traced value — lets torch.finfo/torch.tensor(...,
    dtype=x.dtype) evaluate eagerly."""
    import torch

    if _is_ff(v):
        from ..ffconst import dtype_to_torch

        return dtype_to_torch(v.dtype)
    return getattr(torch, str(np.asarray(v).dtype), torch.float32)


def _convert_module(ffmodel: FFModel, mod, args, name: str):
    import torch.nn as nn

    name = name.replace(".", "_")
    x = args[0]
    if isinstance(mod, nn.Embedding) and not _is_ff(x):
        x = _as_ff(ffmodel, x, int_ids=True)  # traced buffer ids
    if not _is_ff(x):
        x = _as_ff(ffmodel, x)
    if isinstance(mod, nn.Linear):
        out = ffmodel.dense(x, mod.out_features, use_bias=mod.bias is not None,
                            name=name)
        w = {"kernel": _np(mod.weight).T}
        if mod.bias is not None:
            w["bias"] = _np(mod.bias)
        _set_weight(ffmodel, out, w)
        return out
    if isinstance(mod, nn.Conv2d):
        out = ffmodel.conv2d(
            x, mod.out_channels, mod.kernel_size[0], mod.kernel_size[1],
            mod.stride[0], mod.stride[1], mod.padding[0], mod.padding[1],
            groups=mod.groups, use_bias=mod.bias is not None, name=name)
        # torch OIHW -> HWIO
        w = {"kernel": _np(mod.weight).transpose(2, 3, 1, 0)}
        if mod.bias is not None:
            w["bias"] = _np(mod.bias)
        _set_weight(ffmodel, out, w)
        return out
    if isinstance(mod, nn.BatchNorm2d):
        out = ffmodel.batch_norm(x, relu=False, name=name)
        _set_weight(ffmodel, out, {"scale": _np(mod.weight),
                                   "bias": _np(mod.bias)})
        return out
    if isinstance(mod, nn.LayerNorm):
        axes = list(range(-len(mod.normalized_shape), 0))
        out = ffmodel.layer_norm(x, axes=axes, eps=mod.eps, name=name)
        if mod.elementwise_affine:
            _set_weight(ffmodel, out, {"scale": _np(mod.weight),
                                       "bias": _np(mod.bias)})
        return out
    if isinstance(mod, nn.Embedding):
        out = ffmodel.embedding(x, mod.num_embeddings, mod.embedding_dim,
                                AggrMode.AGGR_MODE_NONE, name=name)
        _set_weight(ffmodel, out, {"weight": _np(mod.weight)})
        return out
    if isinstance(mod, nn.ReLU):
        return ffmodel.relu(x, name=name)
    if isinstance(mod, nn.GELU):
        return ffmodel.gelu(x, name=name)
    if isinstance(mod, nn.Sigmoid):
        return ffmodel.sigmoid(x, name=name)
    if isinstance(mod, nn.Tanh):
        return ffmodel.tanh(x, name=name)
    if isinstance(mod, nn.Softmax):
        return ffmodel.softmax(x, axis=mod.dim if mod.dim is not None else -1,
                               name=name)
    if isinstance(mod, nn.Dropout):
        return ffmodel.dropout(x, rate=mod.p, name=name)
    if isinstance(mod, nn.MaxPool2d):
        k = mod.kernel_size if isinstance(mod.kernel_size, tuple) else \
            (mod.kernel_size, mod.kernel_size)
        st = mod.stride if isinstance(mod.stride, tuple) else \
            (mod.stride or k[0], mod.stride or k[1])
        p = mod.padding if isinstance(mod.padding, tuple) else \
            (mod.padding, mod.padding)
        return ffmodel.pool2d(x, k[0], k[1], st[0], st[1], p[0], p[1],
                              PoolType.POOL_MAX, name=name)
    if isinstance(mod, nn.AvgPool2d):
        k = mod.kernel_size if isinstance(mod.kernel_size, tuple) else \
            (mod.kernel_size, mod.kernel_size)
        st = mod.stride if isinstance(mod.stride, tuple) else \
            (mod.stride or k[0], mod.stride or k[1])
        p = mod.padding if isinstance(mod.padding, tuple) else \
            (mod.padding, mod.padding)
        return ffmodel.pool2d(x, k[0], k[1], st[0], st[1], p[0], p[1],
                              PoolType.POOL_AVG, name=name)
    if isinstance(mod, nn.AdaptiveAvgPool2d):
        # static shapes: lower to a plain AvgPool whose kernel is
        # derived from the incoming spatial dims (torchvision resnet's
        # AdaptiveAvgPool2d((1, 1)) head)
        oh, ow = mod.output_size if isinstance(mod.output_size, tuple) else \
            (mod.output_size, mod.output_size)
        _b, _c, ih, iw = x.dims
        assert ih % oh == 0 and iw % ow == 0, \
            f"AdaptiveAvgPool2d: {ih}x{iw} not divisible by {oh}x{ow}"
        kh, kw = ih // oh, iw // ow
        return ffmodel.pool2d(x, kh, kw, kh, kw, 0, 0,
                              PoolType.POOL_AVG, name=name)
    if isinstance(mod, nn.Flatten):
        return ffmodel.flat(x, name=name)
    if isinstance(mod, nn.Identity):
        return ffmodel.identity(x, name=name)
    raise NotImplementedError(f"torch module {type(mod).__name__}")


def _convert_function(ffmodel: FFModel, node, args, kwargs):
    import operator

    import torch
    import torch.nn.functional as F

    t = node.target
    if node.op == "call_method":
        x = args[0]
        # ---- shape/meta queries: always eager (static shapes) -------------
        if t == "size":
            dims = tuple(x.dims) if _is_ff(x) else np.asarray(x).shape
            return dims[args[1]] if len(args) > 1 else dims
        if t == "dim":
            return len(x.dims) if _is_ff(x) else np.asarray(x).ndim
        # ---- eager numpy receivers (mask plumbing, traced buffers) --------
        if not _is_ff(x):
            x = np.asarray(x)
            if t == "expand":
                sizes = list(args[1:])
                off = len(sizes) - x.ndim  # torch aligns sizes to trailing dims
                shape = [x.shape[i - off] if a == -1 else int(a)
                         for i, a in enumerate(sizes)]
                return np.broadcast_to(x, shape)
            if t == "to":
                target = args[1] if len(args) > 1 else kwargs.get("dtype")
                try:
                    return x.astype(_np_dtype(target))
                except (TypeError, ValueError):
                    return x  # .to(device) and friends
            if t == "masked_fill":
                mask = np.asarray(args[1])
                return np.where(mask, args[2], x)
            if t in ("view", "reshape"):
                return x.reshape([int(a) for a in args[1:]])
            if t == "transpose":
                perm = list(range(x.ndim))
                i, j = args[1], args[2]
                perm[i], perm[j] = perm[j], perm[i]
                return np.transpose(x, perm)
            if t == "float":
                return x.astype(np.float32)
            if t == "long":
                return x.astype(np.int64)
            if t == "type_as":
                other = args[1]
                if _is_ff(other):
                    return x.astype(_np_dtype(_torch_dtype_of(other)))
                return x.astype(np.asarray(other).dtype)
            if t == "abs":
                return np.abs(x)
            if t == "bool":
                return x.astype(bool)
            if t == "int":
                return x.astype(np.int32)
            if t == "repeat":
                reps = args[1:] if len(args) > 2 or not isinstance(
                    args[1], (tuple, list)) else args[1]
                return np.tile(x, [int(r) for r in reps])
            if t == "unsqueeze":
                return np.expand_dims(x, int(args[1]))
            if t == "squeeze":
                if len(args) > 1:
                    dim = int(args[1])
                    # torch semantics: squeeze of a non-1 dim is a no-op
                    return np.squeeze(x, dim) if x.shape[dim] == 1 else x
                return np.squeeze(x)
            if t in ("contiguous", "clone", "detach"):
                return x
            if t == "cumsum":
                dim = kwargs.get("dim", args[1] if len(args) > 1 else -1)
                return np.cumsum(x, axis=int(dim))
            if t == "ne":
                return x != np.asarray(args[1])
            if t == "eq":
                return x == np.asarray(args[1])
            if t == "flatten":
                start = int(kwargs.get("start_dim",
                                       args[1] if len(args) > 1 else 0))
                end = int(kwargs.get("end_dim",
                                     args[2] if len(args) > 2 else -1))
                end = end % x.ndim
                sh = list(x.shape)
                new = sh[:start] + \
                    [int(np.prod(sh[start:end + 1]))] + sh[end + 1:]
                return x.reshape(new)
            if t in ("new_ones", "new_zeros", "new_full"):
                shape = args[1] if isinstance(args[1], (tuple, list)) \
                    else args[1:] if t != "new_full" else args[1]
                shape = [int(s) for s in shape]
                dt = kwargs.get("dtype")
                np_dt = _np_dtype(dt) if dt is not None else x.dtype
                if t == "new_full":
                    return np.full(shape, args[2], dtype=np_dt)
                fill = np.ones if t == "new_ones" else np.zeros
                return fill(shape, dtype=np_dt)
            raise NotImplementedError(f"torch method {t} on host value")
        # ---- graph ops on Tensors -----------------------------------------
        if t == "view" or t == "reshape":
            shape = [a for a in args[1:]]
            if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
                shape = list(shape[0])
            return ffmodel.reshape(x, [int(s) if isinstance(
                s, (int, np.integer)) else -1 for s in shape])
        if t == "permute":
            perm = list(args[1:])
            if len(perm) == 1 and isinstance(perm[0], (list, tuple)):
                perm = [int(p) for p in perm[0]]
            return ffmodel.transpose(x, perm)
        if t == "transpose":
            perm = list(range(len(x.dims)))
            i, j = args[1], args[2]
            perm[i], perm[j] = perm[j], perm[i]
            return ffmodel.transpose(x, perm)
        if t == "flatten":
            return ffmodel.flat(x)
        if t == "mean":
            dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
            if dims is None:
                raise NotImplementedError("full-reduce mean")
            return ffmodel.mean(x, dims=_reduce_dims(dims),
                                keepdims=kwargs.get("keepdim", False))
        if t == "sum":
            dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
            if dims is None:
                raise NotImplementedError("full-reduce sum")
            return ffmodel.reduce_sum(x, axes=_reduce_dims(dims),
                                      keepdims=kwargs.get("keepdim", False))
        if t == "pow":
            return ffmodel.pow(x, args[1])
        if t == "rsqrt":
            return ffmodel.rsqrt(x)
        if t == "exp":
            return ffmodel.exp(x)
        if t in ("split", "chunk"):
            return _convert_split(ffmodel, x, args[1:], kwargs,
                                  is_chunk=(t == "chunk"))
        if t == "unsqueeze":
            return _convert_unsqueeze(ffmodel, x, args[1:], kwargs)
        if t == "squeeze":
            return _convert_squeeze(ffmodel, x, args[1:], kwargs)
        if t == "to":
            target = args[1] if len(args) > 1 else kwargs.get("dtype")
            try:
                return ffmodel.cast(x, _ff_dtype(target))
            except (TypeError, ValueError):
                return x  # .to(device) and friends
        if t == "float":
            from ..ffconst import DataType

            return ffmodel.cast(x, DataType.DT_FLOAT)
        if t == "type_as":
            other = args[1]
            if _is_ff(other):
                return ffmodel.cast(x, other.dtype)
            from ..ffconst import numpy_to_dtype

            return ffmodel.cast(x, numpy_to_dtype(np.asarray(other).dtype))
        if t == "contiguous" or t == "clone" or t == "detach":
            return x
        raise NotImplementedError(f"torch method {t}")

    # ---- eager host-side builtins (shape arithmetic / mask construction) ---
    if t is getattr:
        obj, attr = args[0], args[1]
        if attr == "shape":
            return tuple(obj.dims) if _is_ff(obj) else np.asarray(obj).shape
        if attr == "dtype":
            return _torch_dtype_of(obj)
        if attr == "device":
            return torch.device("cpu")
        return getattr(obj, attr)  # finfo.min etc. — eager objects
    if t is operator.getitem:
        obj = args[0]
        if _is_ff(obj):
            items = args[1] if isinstance(args[1], tuple) else (args[1],)
            return ffmodel.slice_tensor(obj, items)
        return obj[args[1]]
    if t is operator.setitem:
        obj, key, val = args[0], args[1], args[2]
        keys = key if isinstance(key, tuple) else (key,)
        if not _is_ff(obj) and not _is_ff(val) and \
                not any(_is_ff(k) for k in keys):
            obj = np.asarray(obj)
            if obj.flags.writeable:
                obj[key] = val  # in place: views created earlier stay live
                return obj
            # read-only (broadcast) source: copy + rebind in the trace loop.
            # Views taken BEFORE this write won't observe it — warn.
            import warnings

            warnings.warn("fx setitem on a read-only host view: copying; "
                          "earlier-created aliases will not see this write")
            obj = np.array(obj)
            obj[key] = val
            return obj
        raise NotImplementedError("setitem involving graph tensors")
    if t is torch.ones:
        shape = args[0] if isinstance(args[0], (tuple, list)) else args
        return np.ones([int(s) for s in shape], dtype=np.float32)
    if t is torch.zeros:
        shape = args[0] if isinstance(args[0], (tuple, list)) else args
        return np.zeros([int(s) for s in shape], dtype=np.float32)
    if t is torch.tensor:
        return np.asarray(args[0],
                          dtype=_np_dtype(kwargs.get("dtype")) if
                          kwargs.get("dtype") is not None else None)
    if t is torch.finfo:
        return torch.finfo(args[0])
    if t is operator.eq:
        if not _is_ff(args[0]) and not _is_ff(args[1]):
            return args[0] == args[1]
    # ---- eager host arithmetic for static index computations (T5-style
    # relative-position buckets: arange/abs/comparisons/log/min/where all
    # run on host numpy at trace time; only the bias embedding lookup
    # enters the graph, via the nn.Embedding constant-promotion path) ------
    if t is torch.arange:
        vals = list(args if len(args) > 1 or not isinstance(
            args[0], (tuple, list)) else args[0])
        if all(float(a) == int(a) for a in vals):
            vals = [int(a) for a in vals]
            default_dt = np.int64
        else:  # float arange (frequency tables etc.) keeps real values
            default_dt = np.float32
        return np.arange(*vals, dtype=_np_dtype(kwargs.get("dtype"))
                         if kwargs.get("dtype") is not None else default_dt)
    if t is torch.abs and not _is_ff(args[0]):
        return np.abs(np.asarray(args[0]))
    if t in _HOST_CMP and not _is_ff(args[0]) and not _is_ff(args[1]):
        a, b = args[0], args[1]
        if isinstance(a, (tuple, list)) or isinstance(b, (tuple, list)):
            # shape comparisons must yield a python bool, not elementwise
            import operator as _op

            py = {np.less: _op.lt, np.greater: _op.gt,
                  np.less_equal: _op.le, np.greater_equal: _op.ge,
                  np.not_equal: _op.ne, np.equal: _op.eq}
            return py[_HOST_CMP[t]](a, b)
        return _HOST_CMP[t](np.asarray(a), np.asarray(b))
    if t is torch.log:
        if _is_ff(args[0]):
            return ffmodel.log(args[0])
        return np.log(np.asarray(args[0]))
    # elementwise two-array form only: torch.min(x, dim:int) is a reduction
    # returning (values, indices) — not supported here
    if t is torch.min and len(args) == 2 and not _is_ff(args[0]) \
            and not _is_ff(args[1]) and np.ndim(args[1]) > 0:
        return np.minimum(np.asarray(args[0]), np.asarray(args[1]))
    if t is torch.max and len(args) == 2 and not _is_ff(args[0]) \
            and not _is_ff(args[1]) and np.ndim(args[1]) > 0:
        return np.maximum(np.asarray(args[0]), np.asarray(args[1]))
    if t is torch.full_like and not _is_ff(args[0]):
        dt = kwargs.get("dtype")
        return np.full_like(np.asarray(args[0]), args[1],
                            dtype=_np_dtype(dt) if dt is not None else None)
    if t is torch.full:
        shape = [int(s) for s in args[0]]
        fill = args[1] if len(args) > 1 else kwargs["fill_value"]
        dt = kwargs.get("dtype")
        if dt is not None:
            np_dt = _np_dtype(dt)
        else:  # torch defaults float fills to f32 (not numpy's f64)
            np_dt = np.float32 if isinstance(fill, float) else None
        return np.full(shape, fill, dtype=np_dt)
    if t is torch.zeros_like and not _is_ff(args[0]):
        return np.zeros_like(np.asarray(args[0]))
    if t is getattr(torch, "diff", None) and not _is_ff(args[0]):
        # packed-sequence detection in masking_utils runs on host indices
        extra = {}
        for kw in ("prepend", "append"):
            if kwargs.get(kw) is not None:
                extra[kw] = np.asarray(kwargs[kw])
        n = int(kwargs.get("n", args[1] if len(args) > 1 else 1))
        return np.diff(np.asarray(args[0]), n=n,
                       axis=kwargs.get("dim", args[2] if len(args) > 2
                                       else -1), **extra)
    if t is torch.ones_like and not _is_ff(args[0]):
        return np.ones_like(np.asarray(args[0]))
    if t in (operator.and_, operator.or_) and not _is_ff(args[0]) \
            and not _is_ff(args[1]):
        # boolean mask combination (masking_utils.and_masks/or_masks)
        op_np = np.logical_and if t is operator.and_ else np.logical_or
        return op_np(np.asarray(args[0]), np.asarray(args[1]))
    if t in (operator.invert, torch.logical_not) and not _is_ff(args[0]):
        return np.logical_not(np.asarray(args[0]))
    if t in (torch.all, torch.any) and not _is_ff(args[0]):
        red = np.all if t is torch.all else np.any
        dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
        return red(np.asarray(args[0])) if dim is None else \
            red(np.asarray(args[0]), axis=int(dim))
    if t is torch.where and not any(_is_ff(a) for a in args[:3]):
        return np.where(np.asarray(args[0]), np.asarray(args[1]),
                        np.asarray(args[2]))
    if t is torch.where and not _is_ff(args[0]) and _is_ff(args[1]):
        # graph select with a host condition (gpt-neo causal masking:
        # where(mask, scores, finfo.min)) — lower to mask arithmetic
        m = np.asarray(args[0]).astype(np.float32)
        left = ffmodel.multiply(args[1], _as_ff(ffmodel, m))
        if _is_ff(args[2]):
            return ffmodel.add(left, ffmodel.multiply(
                args[2], _as_ff(ffmodel, 1.0 - m)))
        other = np.asarray(args[2], dtype=np.float32) * (1.0 - m)
        return ffmodel.add(left, _as_ff(ffmodel, other))
    if t is torch.triu and not _is_ff(args[0]):
        return np.triu(np.asarray(args[0]), k=kwargs.get(
            "diagonal", args[1] if len(args) > 1 else 0))
    if t is torch.tril and not _is_ff(args[0]):
        return np.tril(np.asarray(args[0]), k=kwargs.get(
            "diagonal", args[1] if len(args) > 1 else 0))
    if t is torch.nn.functional.scaled_dot_product_attention or \
            (getattr(t, "__name__", "") == "scaled_dot_product_attention"):
        # torch signature: (query, key, value, attn_mask=None, dropout_p=0.0,
        # is_causal=False, *, scale=None) — args may arrive positionally
        q, k, v = args[0], args[1], args[2]
        mask = kwargs.get("attn_mask", args[3] if len(args) > 3 else None)
        dropout_p = kwargs.get("dropout_p",
                               args[4] if len(args) > 4 else 0.0)
        is_causal = kwargs.get("is_causal",
                               args[5] if len(args) > 5 else False)
        if mask is not None and not _is_ff(mask):
            mask = np.asarray(mask)
            if mask.dtype == bool:
                # torch bool semantics: True = attend, False = -inf
                mask = None if mask.all() else _as_ff(ffmodel, mask)
            else:
                mask = mask.astype(np.float32)
                # all-zero additive mask: no-op
                mask = None if not mask.any() else _as_ff(ffmodel, mask)
        return ffmodel.sdpa(q, k, v, attn_mask=mask, dropout=dropout_p,
                            causal=is_causal, scale=kwargs.get("scale"))

    if t is torch.addmm and _is_ff(args[1]) and not _is_ff(args[0]) \
            and not _is_ff(args[2]):
        # HF Conv1D (gpt2): addmm(bias, x_2d, weight) with weight (in, out)
        # — a dense layer whose kernel is already in our layout
        w = np.asarray(args[2])
        out = ffmodel.dense(args[1], w.shape[1], use_bias=True,
                            name=node.name)
        _set_weight(ffmodel, out, {"kernel": w,
                                   "bias": np.asarray(args[0])})
        return out
    if t in (operator.add, torch.add):
        if isinstance(args[0], (tuple, list)) and \
                isinstance(args[1], (tuple, list)):
            # shape arithmetic: size()[:-1] + (nf,) concatenates
            return tuple(args[0]) + tuple(args[1])
        return _binary(ffmodel, "add", args)
    if t in (operator.sub, torch.sub):
        return _binary(ffmodel, "subtract", args)
    if t in (operator.mul, torch.mul):
        return _binary(ffmodel, "multiply", args)
    if t in (operator.truediv, torch.div):
        return _binary(ffmodel, "divide", args)
    if getattr(t, "__name__", "") == "gelu":  # torch._C._nn.gelu builtin
        return ffmodel.gelu(args[0])
    if t in (torch.matmul, torch.bmm):
        return ffmodel.batch_matmul(args[0], args[1])
    if t is F.relu or t is torch.relu:
        return ffmodel.relu(args[0])
    if t is F.gelu:
        return ffmodel.gelu(args[0])
    if t is torch.sigmoid or t is F.sigmoid:
        return ffmodel.sigmoid(args[0])
    if t is torch.tanh or t is F.tanh:
        return ffmodel.tanh(args[0])
    if t is F.softmax or t is torch.softmax:
        axis = kwargs.get("dim", args[1] if len(args) > 1 else -1)
        return ffmodel.softmax(args[0], axis=axis)
    if t is torch.cat:
        tensors = args[0]
        axis = kwargs.get("dim", args[1] if len(args) > 1 else 0)
        return ffmodel.concat(list(tensors), axis=axis)
    if t is torch.flatten:
        return ffmodel.flat(args[0])
    if t is torch.mean:
        dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
        if dims is None:
            raise NotImplementedError("full-reduce mean")
        return ffmodel.mean(args[0], dims=_reduce_dims(dims),
                            keepdims=kwargs.get("keepdim", False))
    if t is F.dropout:
        return ffmodel.dropout(args[0], rate=kwargs.get("p", 0.5))
    if t is getattr(torch, "pow", None) or t is operator.pow:
        return ffmodel.pow(args[0], args[1])
    if t is torch.rsqrt:
        return ffmodel.rsqrt(args[0])
    if t is torch.exp:
        return ffmodel.exp(args[0])
    if t is torch.sin:
        return ffmodel.sin(args[0])
    if t is torch.cos:
        return ffmodel.cos(args[0])
    if t is operator.neg:
        if not _is_ff(args[0]):
            return -args[0]
        return ffmodel.scalar_multiply(args[0], -1.0)
    if t is torch.sum:
        dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
        if dims is None:
            raise NotImplementedError("full-reduce sum")
        return ffmodel.reduce_sum(args[0], axes=_reduce_dims(dims),
                                  keepdims=kwargs.get("keepdim", False))
    if t in (torch.split, torch.chunk):
        return _convert_split(ffmodel, args[0], args[1:], kwargs,
                              is_chunk=(t is torch.chunk))
    if t is torch.unsqueeze:
        return _convert_unsqueeze(ffmodel, args[0], args[1:], kwargs)
    if t is torch.squeeze:
        return _convert_squeeze(ffmodel, args[0], args[1:], kwargs)
    raise NotImplementedError(f"torch function {t}")


# ---- shared torch-semantics helpers (reference: SplitChunkNode — one node
# class serves both x.split/x.chunk and the torch.* functions) ---------------
def _reduce_dims(dims) -> list:
    return [dims] if isinstance(dims, int) else list(dims)


def _convert_split(ffmodel: FFModel, x, rest, kwargs, is_chunk: bool):
    dim = kwargs.get("dim", rest[1] if len(rest) > 1 else 0)
    total = x.dims[dim]
    if is_chunk:
        n = rest[0]
        per = -(-total // n)  # torch.chunk: ceil division
        sizes = []
        left = total
        while left > 0:
            sizes.append(min(per, left))
            left -= per
    else:
        sizes = rest[0]
        if isinstance(sizes, int):
            # torch.split: last chunk carries the remainder
            per = sizes
            sizes = [per] * (total // per)
            if total % per:
                sizes.append(total % per)
    return tuple(ffmodel.split(x, list(sizes), axis=dim))


def _convert_unsqueeze(ffmodel: FFModel, x, rest, kwargs):
    dim = kwargs.get("dim", rest[0] if rest else None)
    assert dim is not None, "unsqueeze requires a dim"
    shape = list(x.dims)
    a = dim if dim >= 0 else len(shape) + dim + 1
    shape.insert(a, 1)
    return ffmodel.reshape(x, shape)


def _convert_squeeze(ffmodel: FFModel, x, rest, kwargs):
    dim = kwargs.get("dim", rest[0] if rest else None)
    shape = list(x.dims)
    if dim is not None:
        a = dim % len(shape)
        if shape[a] == 1:
            shape.pop(a)
    else:
        shape = [s for s in shape if s != 1] or [1]
    return ffmodel.reshape(x, shape)


def _np_dtype(torch_dtype):
    """torch dtype object -> numpy dtype (eager mask/buffer arithmetic)."""
    import torch

    if torch_dtype is None:
        return np.float32
    if isinstance(torch_dtype, np.dtype) or isinstance(torch_dtype, type):
        return np.dtype(torch_dtype)
    if torch_dtype is torch.bool:
        return np.dtype(bool)
    return np.dtype(str(torch_dtype).replace("torch.", ""))


def _ff_dtype(torch_dtype) -> DataType:
    """torch dtype object -> DataType (bfloat16 included, which numpy cannot
    name); raises TypeError or ValueError for what is not a dtype."""
    import torch

    from ..ffconst import numpy_to_dtype, str_to_dtype

    if isinstance(torch_dtype, torch.dtype):
        return str_to_dtype(str(torch_dtype).replace("torch.", ""))
    return numpy_to_dtype(_np_dtype(torch_dtype))


def _binary(ffmodel: FFModel, opname: str, args):
    a, b = args[0], args[1]
    if not _is_ff(a) and not _is_ff(b):
        # both host values (shape arithmetic / mask construction): eager
        fn = {"add": np.add, "subtract": np.subtract,
              "multiply": np.multiply, "divide": np.true_divide}[opname]
        r = fn(a, b)
        if np.ndim(r) == 0 and not isinstance(a, np.ndarray) \
                and not isinstance(b, np.ndarray):
            return r.item()
        return r
    if _is_ff(a) and isinstance(b, (int, float)):
        scalar_map = {"add": "scalar_add", "subtract": "scalar_sub",
                      "multiply": "scalar_multiply",
                      "divide": "scalar_true_divide"}
        return getattr(ffmodel, scalar_map[opname])(a, float(b))
    if _is_ff(b) and isinstance(a, (int, float)) and opname in ("add",
                                                                "multiply"):
        scalar_map = {"add": "scalar_add", "multiply": "scalar_multiply"}
        return getattr(ffmodel, scalar_map[opname])(b, float(a))
    return getattr(ffmodel, opname)(_as_ff(ffmodel, a), _as_ff(ffmodel, b))
