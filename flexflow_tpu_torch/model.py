"""FFModel: the central model object (port of ``flexflow_tpu.model``;
reference: include/flexflow/model.h:326, src/runtime/model.cc).

The builder methods record a Layer graph exactly as the JAX package does;
``compile`` lowers it to a PCG and builds an :class:`Executor` on one
device (the reference pipeline's single-device branch: no search, no
mesh); ``generate`` serves it through the paged-KV ``ServingEngine``.

The model runs on ``device`` — CUDA unless the caller asks for the CPU.
With no GPU and no explicit ``device="cpu"`` the constructor raises: the
port never drops to the CPU silently. Training (``fit``/``eval``, the
optimizers and losses), multi-device strategies and the builder methods
this slice's models do not use come in later slices.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .config import FFConfig
from .ffconst import (ActiMode, AggrMode, CompMode, DataType, LossType,
                      MetricsType, OperatorType, numpy_to_dtype)
from .layer import Layer
from .tensor import Tensor


def resolve_device(device=None):
    """``None`` means CUDA. Raises when CUDA is asked for (or implied) and
    this host has no GPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flexflow_tpu_torch runs on CUDA by default and this host has "
            "no GPU (torch.cuda.is_available() is False); pass "
            "device='cpu' to run the plain-PyTorch path on the CPU")
    return dev


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None, device=None):
        self.device = resolve_device(device)
        self.config = config or FFConfig()
        self._layers: List[Layer] = []
        self._input_tensors: List[Tensor] = []
        self.optimizer = None
        # populated by compile()
        self.pcg = None
        self.executor = None
        self.params: Optional[Dict[str, Dict[str, Any]]] = None
        self.loss_type: Optional[LossType] = None
        self.final_guid: Optional[int] = None
        self.final_out_idx = 0
        self._tensor_to_node: Dict[int, int] = {}
        self._serving_engine = None

    # ======================================================= tensor creation ==
    def create_tensor(self, dims: Sequence[int],
                      dtype: DataType = DataType.DT_FLOAT,
                      create_grad: bool = True, name: str = "") -> Tensor:
        if not isinstance(dtype, DataType):
            raise TypeError(
                f"create_tensor dtype must be a DataType, got {dtype!r} "
                "(signature: create_tensor(dims, dtype, create_grad, name))")
        t = Tensor(dims, dtype, create_grad=create_grad,
                   name=name or f"input_{len(self._input_tensors)}",
                   model=self)
        self._input_tensors.append(t)
        return t

    # ================================================================ builders ==
    def _add_layer(self, op_type: OperatorType, inputs: List[Tensor],
                   attrs: Dict[str, Any], dtype: Optional[DataType] = None,
                   name: Optional[str] = None
                   ) -> Union[Tensor, List[Tensor]]:
        from .ops import op_class_for

        dtype = dtype or (inputs[0].dtype if inputs else DataType.DT_FLOAT)
        layer = Layer(op_type, dtype, name, inputs, attrs=attrs,
                      index=len(self._layers))
        op = op_class_for(op_type)(layer.name, attrs, dtype,
                                   num_inputs=len(inputs))
        out_shapes = op.infer_output_shapes([t.dims for t in inputs])
        out_dtype = op.output_dtype([t.dtype for t in inputs])
        for wname, (shape, wdtype, init) in op.weight_specs(
                [t.dims for t in inputs]).items():
            layer.add_weight(wname, shape, wdtype, init)
        outs = []
        for i, s in enumerate(out_shapes):
            t = Tensor(s, out_dtype, owner_layer=layer, owner_idx=i,
                       model=self)
            t.name = f"{layer.name}:out{i}"
            outs.append(t)
        layer.outputs = outs
        self._layers.append(layer)
        return outs[0] if len(outs) == 1 else outs

    def dense(self, input: Tensor, out_dim: int,
              activation: ActiMode = ActiMode.AC_MODE_NONE,
              use_bias: bool = True, datatype: Optional[DataType] = None,
              kernel_initializer=None, bias_initializer=None,
              kernel_regularizer=None,
              name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OperatorType.OP_LINEAR, [input],
            {"out_dim": out_dim, "activation": activation,
             "use_bias": use_bias,
             "kernel_initializer": kernel_initializer,
             "bias_initializer": bias_initializer,
             "kernel_regularizer": kernel_regularizer},
            datatype or input.dtype, name)

    def layer_norm(self, input: Tensor, axes: Sequence[int],
                   elementwise_affine: bool = True, eps: float = 1e-5,
                   name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OperatorType.OP_LAYERNORM, [input],
            {"axes": list(axes), "elementwise_affine": elementwise_affine,
             "eps": eps}, input.dtype, name)

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: AggrMode = AggrMode.AGGR_MODE_NONE,
                  dtype: DataType = DataType.DT_FLOAT, shared_op=None,
                  kernel_initializer=None, name: Optional[str] = None
                  ) -> Tensor:
        return self._add_layer(
            OperatorType.OP_EMBEDDING, [input],
            {"num_entries": num_entries, "out_dim": out_dim, "aggr": aggr,
             "kernel_initializer": kernel_initializer}, dtype, name)

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0,
                            bias: bool = True, add_bias_kv: bool = False,
                            add_zero_attn: bool = False,
                            kernel_initializer=None, causal: bool = False,
                            name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OperatorType.OP_MULTIHEAD_ATTENTION, [query, key, value],
            {"embed_dim": embed_dim, "num_heads": num_heads, "kdim": kdim,
             "vdim": vdim, "dropout": dropout, "bias": bias,
             "add_bias_kv": add_bias_kv, "add_zero_attn": add_zero_attn,
             "kernel_initializer": kernel_initializer, "causal": causal},
            query.dtype, name)

    def add(self, x, y, inplace_a=False, name=None):
        return self._add_layer(OperatorType.OP_EW_ADD, [x, y], {}, x.dtype,
                               name)

    def constant(self, value, dtype: Optional[DataType] = None, name=None):
        """Frozen host tensor as a graph node (position ids)."""
        value = np.asarray(value)
        if dtype is None:
            dtype = numpy_to_dtype(value.dtype)
        return self._add_layer(OperatorType.OP_CONSTANT, [],
                               {"value": value}, dtype, name)

    # ================================================================= compile
    def compile(self, optimizer=None,
                loss_type: LossType =
                LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Optional[List[MetricsType]] = None,
                comp_mode: CompMode = CompMode.COMP_MODE_TRAINING,
                strategy=None, strategy_fn=None,
                final_tensor: Optional[Tensor] = None) -> None:
        """Lower the Layer graph to a PCG and build the executor on one
        device, then initialize the parameters from ``config.seed``.
        ``optimizer``, ``loss_type`` and ``metrics`` are recorded for the
        training slice; an explicit or imported strategy, ``--fusion`` and
        a multi-device search are refused until their slices land."""
        from .execution.executor import Executor

        if strategy is not None or strategy_fn is not None \
                or self.config.import_strategy_file:
            raise NotImplementedError(
                "compile: explicit/imported strategies are ported in a "
                "later slice (multi-GPU); this slice compiles for one device")
        if self.config.perform_fusion:
            raise NotImplementedError(
                "--fusion is ported in a later slice; compile without it")
        self.optimizer = optimizer
        self.loss_type = loss_type
        pcg = self.create_pcg()
        if final_tensor is not None:
            final = pcg.nodes[self._tensor_to_node[final_tensor.guid]]
            self.final_out_idx = final_tensor.owner_idx or 0
        else:
            sinks = [n for n in pcg.sinks()
                     if n.op.op_type != OperatorType.OP_INPUT]
            final = sinks[-1]
            self.final_out_idx = 0
        self.final_guid = final.guid
        self.pcg = pcg
        self.executor = Executor(pcg, self.config, self.final_guid,
                                 self.device,
                                 final_out_idx=self.final_out_idx)
        self.params = self.executor.init_params(self.config.numpy_seed())
        self._serving_engine = None

    def create_pcg(self):
        """Layer graph -> PCG (reference: create_operators_from_layers,
        src/runtime/model.cc:2785)."""
        from .ops import op_class_for
        from .parallel.pcg import PCG

        pcg = PCG()
        tensor_to_out: Dict[int, Tuple[int, int]] = {}
        for t in self._input_tensors:
            node = pcg.add_node(
                op_class_for(OperatorType.OP_INPUT)(
                    t.name, {"shape": t.dims, "dtype": t.dtype}, t.dtype, 0),
                [])
            tensor_to_out[t.guid] = (node.guid, 0)
            self._tensor_to_node[t.guid] = node.guid
        for layer in self._layers:
            op = op_class_for(layer.op_type)(
                layer.name, layer.attrs, layer.data_type,
                num_inputs=len(layer.inputs))
            node = pcg.add_node(op, [tensor_to_out[t.guid]
                                     for t in layer.inputs])
            for i, t in enumerate(layer.outputs):
                tensor_to_out[t.guid] = (node.guid, i)
                self._tensor_to_node[t.guid] = node.guid
        self.pcg = pcg
        return pcg

    # ================================================================= weights
    def get_params_numpy(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The parameters as the JAX package's ``{node_name: {wname:
        np.ndarray}}`` pytree (same names, same layouts, fp32 masters)."""
        from .utils.weights import params_to_numpy

        self._require_compiled()
        return params_to_numpy(self.params)

    def set_params_numpy(self, np_params: Dict[str, Dict[str, Any]]) -> None:
        """Load a ``{node_name: {wname: array}}`` pytree — e.g. the JAX
        package's ``ff.params`` through ``jax.device_get`` — 1:1 into this
        model. Names, shapes and dtypes must match the model's own."""
        from .utils.weights import params_from_numpy

        self._require_compiled()
        expected = {(n.name, w): (tuple(shape), dt)
                    for n, w, shape, dt, _ in self.executor.weight_entries()}
        self.params = params_from_numpy(np_params, self.device,
                                        expected=expected)
        self._serving_engine = None

    def _require_compiled(self) -> None:
        if self.executor is None:
            raise RuntimeError("call compile() first")

    def _locate_weight(self, tensor: Tensor) -> Tuple[str, str]:
        layer = tensor.owner_layer
        if layer is None or tensor.owner_idx >= 0:
            raise ValueError(f"{tensor.name} is not a weight tensor")
        return layer.name, tensor.name.split(".")[-1]

    def _get_weight_by_tensor(self, tensor: Tensor) -> np.ndarray:
        self._require_compiled()
        lname, wname = self._locate_weight(tensor)
        return self.params[lname][wname].detach().cpu().numpy()

    def _set_weight_by_tensor(self, tensor: Tensor, arr: np.ndarray) -> None:
        import torch

        self._require_compiled()
        lname, wname = self._locate_weight(tensor)
        cur = self.params[lname][wname]
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(cur.shape):
            raise ValueError(f"{tensor.name}: shape {arr.shape} != "
                             f"{tuple(cur.shape)}")
        new = dict(self.params)
        new[lname] = dict(new[lname])
        new[lname][wname] = torch.as_tensor(arr, dtype=cur.dtype).to(
            self.device)
        self.params = new
        self._serving_engine = None

    # ================================================================ serving
    def generate(self, prompts, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 max_inflight: Optional[int] = None,
                 max_decode_len: Optional[int] = None) -> List[List[int]]:
        """Autoregressive generation through the serving engine: prefill /
        decode over the paged KV pool with continuous batching over
        ``--max-inflight`` slots. Greedy when ``temperature <= 0``. Returns
        the generated continuations in submission order. The engine is
        cached on the model across calls."""
        from .serving.engine import ServingEngine

        self._require_compiled()
        eng = self._serving_engine
        if eng is None or eng.executor is not self.executor or \
                (max_inflight and eng.n_slots != max_inflight) or \
                (max_decode_len and
                 eng.requested_max_decode_len != max_decode_len):
            eng = ServingEngine(self, n_slots=max_inflight,
                                max_decode_len=max_decode_len)
            self._serving_engine = eng
        return eng.generate(prompts, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_k=top_k,
                            eos_id=eos_id, seed=seed)

    def get_layers(self) -> Dict[int, Layer]:
        return {i: layer for i, layer in enumerate(self._layers)}

    def __repr__(self) -> str:
        return (f"FFModel(layers={len(self._layers)}, "
                f"inputs={len(self._input_tensors)}, device={self.device}, "
                f"compiled={self.executor is not None})")
