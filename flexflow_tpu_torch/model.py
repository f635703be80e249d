"""FFModel: the central model object (port of ``flexflow_tpu.model``;
reference: include/flexflow/model.h:326, src/runtime/model.cc).

The builder methods record a Layer graph exactly as the JAX package does;
``compile`` lowers it to a PCG and builds an :class:`Executor` on one
device (the reference pipeline's single-device branch: no search, no
mesh); ``fit`` / ``eval`` / ``predict`` train and run it, and ``generate``
serves it through the paged-KV ``ServingEngine``. The builders are the
JAX package's, with its signatures and defaults
(flexflow_tpu/model.py:118-470).

The model runs on ``device`` — CUDA unless the caller asks for the CPU.
With no GPU and no explicit ``device="cpu"`` the constructor raises: the
port never drops to the CPU silently. ``fit`` runs the JAX package's
fault-tolerant loop (checkpoints, ``--resume``, the divergence sentinel
with rollback, SIGTERM preemption; ``resilience/``) and the ``--remat``
plan; the manual-loop calls (``set_batch`` / ``forward`` /
``zero_gradients`` / ``backward`` / ``update``, ``Tensor.set_tensor``)
drive the same executor by hand. ``--fusion`` merges op chains at
compile (``ops/fused.py``); the cache op and ``fit(recompile_state=)``
recompile the model mid-training (``execution/recompile.py``);
``--trace-file``, ``--telemetry-file`` and ``--profiler-trace-dir`` record
compile, fit, eval and serving (``obs/``).

A strategy (``compile(strategy=...)`` / ``strategy_fn=``,
``--import-strategy``, ``--mesh-shape``, ``--only-data-parallel``, or a
world size above 1 under ``torchrun``) compiles for a ``torch.distributed``
device mesh, one process per GPU: each rank holds its shards of the params
and trains on its slice of every batch, and ``fit`` / ``eval`` /
``predict`` return what the JAX package's global arrays give, the same on
every rank (``parallel/spmd.py``). Compile with none of these in one
process is the one-device path, with no process group. A strategy with a
pipeline grid ``(pp, dp, n_micro)`` trains through
``parallel/pipeline.PipelineTrainer`` on a (pp, dp) grid of ranks under
``--schedule`` / ``--virtual-stages`` and the stage remat, and ``eval`` /
``predict`` run the trained weights on the strategy's mesh. The
fault-tolerant loop, sharded checkpoints, weights over the data axis and
``--fusion`` run on a mesh too (a pipeline ``fit`` refuses the checkpoint
flags, which the JAX package ignores there). With no strategy at a world
size above 1, every rank runs the Unity search (``search/``) and the
ranks agree its plan; ``--search-num-*`` searches for another machine and
exports; ``--static-analysis strict`` runs ShardLint (``analysis/``) on
every plan; ``--compgraph`` writes the PCG's dot text; ``--profiling``
times ops through the search's simulator. ``compile`` runs
``preflight_config`` first. ``fit`` verifies the plan through the
strategy-safety cascade when ``--audit-strategy``, ``--memory-budget-mb``
or strategy chaos arms it (``resilience/fallback.py``), and runs the
closed calibration loop under ``--profile-ops`` /
``--auto-recalibrate`` (``obs/drift.py``); ``resilience.elastic_restore``
re-plans a checkpoint for the live world; ``--debug-nans`` runs the steps
eagerly and raises ``FloatingPointError`` naming the node whose output or
input grad holds a NaN. ``generate`` on a model compiled under a strategy
serves on its mesh (``serving/engine.py``): call it on every rank.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .config import FFConfig
from .ffconst import (ActiMode, AggrMode, CompMode, DataType, LossType,
                      MetricsType, OperatorType, PoolType, dtype_to_torch,
                      numpy_to_dtype)
from .execution.metrics import Metrics, PerfMetrics
from .execution.optimizers import SGDOptimizer
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


@dataclasses.dataclass
class FitHistory:
    """What the last ``fit`` saw, per executed step: the loss (one host
    transfer at the end of fit; NaN for a step the divergence sentinel
    skipped) and, under ``--profiling`` only, the step's wall seconds (each
    step then ends in a device sync)."""

    loss: List[float] = dataclasses.field(default_factory=list)
    step_s: List[float] = dataclasses.field(default_factory=list)


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
        self.metrics_obj: Optional[Metrics] = None
        self.label_tensor: Optional[Tensor] = None
        self.opt_state = None
        self._perf = PerfMetrics()
        self._rng_counter = 0
        self.fit_history = FitHistory()
        self.final_guid: Optional[int] = None
        self.final_out_idx = 0
        self._tensor_to_node: Dict[int, int] = {}
        self._serving_engine = None
        # internal: False makes fit and the serving engine run the eager
        # step bodies instead of the captured programs (the tests and
        # chip_smoke.py compare the two; no flag sets it)
        self._capture_steps = True
        # the manual-loop staging: the bound batch, per-tensor values,
        # the last backward's loss and grads
        self._staged: Dict[str, Any] = {}
        # the last fit's ResilienceSession (its counters: ``summary()``),
        # None when that fit asked for no resilience feature
        self.resilience = None
        # the step count at which the last fit stopped for a preemption
        self._preempted_at_step: Optional[int] = None
        # the CacheOps' last scores (``score_fn``), by op name
        self.cache_scores: Dict[str, float] = {}
        # the dynamic recompile's state, once a fit was given one
        self._recompile_state = None
        # the StepTelemetry of the last fit or serve run (get_telemetry),
        # and the one-fit opt-in that _make_telemetry consumes
        self._telemetry = None
        self._telemetry_requested = False
        # set by compile: the Strategy it applied and the Mesh it runs on
        # (both None on the one-device path)
        self.strategy = None
        self.mesh = None
        self.coordination = None
        # set by compile for a pipeline strategy: fit trains through it
        self._pipeline_trainer = None
        self._pipeline_param_stamp = None
        # the search's warm simulator and ranked runners-up (set by a
        # searching compile), the last fit's strategy cascade, the drift
        # loop's simulator and sentinel (kept across fits), and the
        # elastic restore's device count and the cascade's one-device
        # last resort (set around the compiles they make)
        self._search_result = None
        self._search_sim = None
        self._strategy_candidates: List[Any] = []
        self._last_cascade = None
        self._calibration_sim = None
        self._drift_sentinel = None
        self._elastic_n_dev: Optional[int] = None
        self._one_device_plan = False

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

    def conv2d(self, input: Tensor, out_channels: int, kernel_h: int,
               kernel_w: int, stride_h: int, stride_w: int, padding_h: int,
               padding_w: int, activation: ActiMode = ActiMode.AC_MODE_NONE,
               groups: int = 1, use_bias: bool = True,
               kernel_initializer=None, bias_initializer=None,
               name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OperatorType.OP_CONV2D, [input],
            {"out_channels": out_channels, "kernel_h": kernel_h,
             "kernel_w": kernel_w, "stride_h": stride_h,
             "stride_w": stride_w, "padding_h": padding_h,
             "padding_w": padding_w, "activation": activation,
             "groups": groups, "use_bias": use_bias,
             "kernel_initializer": kernel_initializer,
             "bias_initializer": bias_initializer},
            input.dtype, name)

    def pool2d(self, input: Tensor, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int, padding_w: int,
               pool_type: PoolType = PoolType.POOL_MAX,
               activation: ActiMode = ActiMode.AC_MODE_NONE,
               name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OperatorType.OP_POOL2D, [input],
            {"kernel_h": kernel_h, "kernel_w": kernel_w,
             "stride_h": stride_h, "stride_w": stride_w,
             "padding_h": padding_h, "padding_w": padding_w,
             "pool_type": pool_type, "activation": activation},
            input.dtype, name)

    def batch_norm(self, input: Tensor, relu: bool = True,
                   name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.OP_BATCHNORM, [input],
                               {"relu": relu}, input.dtype, name)

    def layer_norm(self, input: Tensor, axes: Sequence[int],
                   elementwise_affine: bool = True, eps: float = 1e-5,
                   name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OperatorType.OP_LAYERNORM, [input],
            {"axes": list(axes), "elementwise_affine": elementwise_affine,
             "eps": eps}, input.dtype, name)

    def rms_norm(self, input: Tensor, axes: Sequence[int] = (-1,),
                 eps: float = 1e-6, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.OP_RMSNORM, [input],
                               {"axes": list(axes), "eps": eps},
                               input.dtype, name)

    def batch_matmul(self, A: Tensor, B: Tensor,
                     name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.OP_BATCHMATMUL, [A, B], {},
                               A.dtype, name)

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

    # ---- elementwise -------------------------------------------------------
    def _binary(self, op_type, x, y, name=None):
        return self._add_layer(op_type, [x, y], {}, x.dtype, name)

    def add(self, x, y, inplace_a=False, name=None):
        return self._binary(OperatorType.OP_EW_ADD, x, y, name)

    def subtract(self, x, y, inplace_a=False, name=None):
        return self._binary(OperatorType.OP_EW_SUB, x, y, name)

    def multiply(self, x, y, inplace_a=False, name=None):
        return self._binary(OperatorType.OP_EW_MUL, x, y, name)

    def divide(self, x, y, inplace_a=False, name=None):
        return self._binary(OperatorType.OP_EW_DIV, x, y, name)

    def max(self, x, y, inplace_a=False, name=None):
        return self._binary(OperatorType.OP_EW_MAX, x, y, name)

    def min(self, x, y, inplace_a=False, name=None):
        return self._binary(OperatorType.OP_EW_MIN, x, y, name)

    def _unary(self, op_type, x, attrs=None, name=None):
        return self._add_layer(op_type, [x], attrs or {}, x.dtype, name)

    def exp(self, x, name=None):
        return self._unary(OperatorType.OP_EXP, x, name=name)

    def log(self, x, name=None):
        return self._unary(OperatorType.OP_LOG, x, name=name)

    def sin(self, x, name=None):
        return self._unary(OperatorType.OP_SIN, x, name=name)

    def cos(self, x, name=None):
        return self._unary(OperatorType.OP_COS, x, name=name)

    def rsqrt(self, x, name=None):
        return self._unary(OperatorType.OP_RSQRT, x, name=name)

    def pow(self, x, exponent: float, name=None):
        return self._unary(OperatorType.OP_POW, x, {"exponent": exponent},
                           name)

    def scalar_multiply(self, x, scalar: float, inplace=True, name=None):
        return self._unary(OperatorType.OP_SCALAR_MULTIPLY, x,
                           {"scalar": scalar}, name)

    def scalar_add(self, x, scalar: float, inplace=True, name=None):
        return self._unary(OperatorType.OP_SCALAR_ADD, x,
                           {"scalar": scalar}, name)

    def scalar_sub(self, x, scalar: float, inplace=True, name=None):
        return self._unary(OperatorType.OP_SCALAR_SUB, x,
                           {"scalar": scalar}, name)

    def scalar_true_divide(self, x, scalar: float, inplace=True, name=None):
        return self._unary(OperatorType.OP_SCALAR_TRUE_DIV, x,
                           {"scalar": scalar}, name)

    def relu(self, x, inplace=True, name=None):
        return self._unary(OperatorType.OP_RELU, x, name=name)

    def identity(self, x, name=None):
        return self._unary(OperatorType.OP_IDENTITY, x, name=name)

    def sigmoid(self, x, name=None):
        return self._unary(OperatorType.OP_SIGMOID, x, name=name)

    def tanh(self, x, name=None):
        return self._unary(OperatorType.OP_TANH, x, name=name)

    def elu(self, x, inplace=True, name=None):
        return self._unary(OperatorType.OP_ELU, x, name=name)

    def gelu(self, x, name=None):
        return self._unary(OperatorType.OP_GELU, x, name=name)

    def dropout(self, x, rate: float = 0.5, seed: int = 0, name=None):
        return self._unary(OperatorType.OP_DROPOUT, x,
                           {"rate": rate, "seed": seed}, name)

    # ---- shape ops -----------------------------------------------------------
    def flat(self, x, name=None):
        return self._unary(OperatorType.OP_FLAT, x, name=name)

    def softmax(self, x, axis: int = -1, name=None,
                use_pallas: bool = False):
        """``use_pallas`` opts last-axis rows the gate takes into the
        row-softmax kernel (``kernels/softmax.py``); elsewhere, and by
        default, ``torch.softmax``."""
        return self._unary(OperatorType.OP_SOFTMAX, x,
                           {"axis": axis, "use_pallas": use_pallas}, name)

    def reshape(self, x, shape: Sequence[int], name=None):
        return self._unary(OperatorType.OP_RESHAPE, x,
                           {"shape": list(shape)}, name)

    def transpose(self, x, perm: Sequence[int], name=None):
        return self._unary(OperatorType.OP_TRANSPOSE, x,
                           {"perm": list(perm)}, name)

    def reverse(self, x, axis: int, name=None):
        return self._unary(OperatorType.OP_REVERSE, x, {"axis": axis}, name)

    def slice_tensor(self, x, items, name=None):
        """Static getitem: items is a tuple of slice/int/None (the torch
        frontend's getitem; reference OP_SLICE)."""
        from .ops.tensor_ops import encode_slice_items

        return self._unary(OperatorType.OP_SLICE, x,
                           {"items": encode_slice_items(items)}, name)

    def concat(self, tensors: List[Tensor], axis: int, name=None):
        return self._add_layer(OperatorType.OP_CONCAT, list(tensors),
                               {"axis": axis}, tensors[0].dtype, name)

    def split(self, x, sizes: Union[int, List[int]], axis: int, name=None):
        if isinstance(sizes, int):
            dim = x.dims[axis % len(x.dims)]
            if dim % sizes:
                raise ValueError(f"split: {dim} does not divide into "
                                 f"{sizes} equal parts")
            sizes = [dim // sizes] * sizes
        outs = self._add_layer(OperatorType.OP_SPLIT, [x],
                               {"sizes": list(sizes), "axis": axis},
                               x.dtype, name)
        return outs if isinstance(outs, list) else [outs]

    def gather(self, x, index: Tensor, dim: int, name=None):
        return self._add_layer(OperatorType.OP_GATHER, [x, index],
                               {"dim": dim}, x.dtype, name)

    def cast(self, x, dtype: DataType, name=None):
        return self._add_layer(OperatorType.OP_CAST, [x],
                               {"target_dtype": dtype}, dtype, name)

    def mean(self, x, dims: Sequence[int], keepdims: bool = False,
             name=None):
        return self._unary(OperatorType.OP_MEAN, x,
                           {"axes": list(dims), "keepdims": keepdims}, name)

    def reduce_sum(self, x, axes: Sequence[int], keepdims: bool = False,
                   name=None):
        return self._unary(OperatorType.OP_REDUCE_SUM, x,
                           {"axes": list(axes), "keepdims": keepdims}, name)

    def top_k(self, x, k: int, sorted: bool = True, name=None,
              use_pallas: bool = False):
        """(values, int32 indices) of the k largest entries over the last
        dim; ``use_pallas`` opts shapes the gate takes into the row top-k
        kernel (``kernels/topk.py``). ``use_pallas`` comes after ``name``:
        the reference's positional signature is ``top_k(input, k, sorted,
        name)``."""
        return self._add_layer(OperatorType.OP_TOPK, [x],
                               {"k": k, "sorted": sorted,
                                "use_pallas": use_pallas}, x.dtype, name)

    def sdpa(self, q: Tensor, k: Tensor, v: Tensor,
             attn_mask: Optional[Tensor] = None, dropout: float = 0.0,
             causal: bool = False, scale: Optional[float] = None, name=None):
        """Attention core on pre-projected (batch, heads, seq, head_dim)
        tensors (``F.scaled_dot_product_attention``'s signature)."""
        inputs = [q, k, v] + ([attn_mask] if attn_mask is not None else [])
        return self._add_layer(OperatorType.OP_SDPA, inputs,
                               {"dropout": dropout, "causal": causal,
                                "scale": scale}, q.dtype, name)

    # ---- recurrent (reference: nmt/lstm.cu; ops/recurrent.py) -------------
    def lstm(self, input: Tensor, hidden_size: int,
             initial_state: Optional[Tensor] = None,
             name: Optional[str] = None) -> List[Tensor]:
        """LSTM over (batch, seq, dim) -> [(batch, seq, hidden),
        final_state (batch, 2*hidden)]; ``initial_state`` is [h, c]
        concatenated (ops/recurrent.py)."""
        inputs = [input] + ([initial_state] if initial_state is not None
                            else [])
        return self._add_layer(OperatorType.OP_LSTM, inputs,
                               {"hidden_size": hidden_size},
                               input.dtype, name)

    # ---- MoE (reference: src/ops/moe.cc, group_by.cc, aggregate.cc) --------
    def group_by(self, input: Tensor, assign: Tensor, n: int,
                 alpha: float = 1.0, name=None) -> List[Tensor]:
        outs = self._add_layer(OperatorType.OP_GROUP_BY, [input, assign],
                               {"n": n, "alpha": alpha}, input.dtype, name)
        return outs if isinstance(outs, list) else [outs]

    def aggregate(self, gate_preds: Tensor, gate_assign: Tensor,
                  true_gate_assign: Tensor, full_gate_grads: Tensor,
                  exp_preds: List[Tensor], n: int, lambda_bal: float = 0.0,
                  name=None) -> Tensor:
        ins = [gate_preds, gate_assign, true_gate_assign, full_gate_grads] + \
            list(exp_preds)
        return self._add_layer(OperatorType.OP_AGGREGATE, ins,
                               {"n": n, "lambda_bal": lambda_bal},
                               exp_preds[0].dtype, name)

    def aggregate_spec(self, gate_preds, gate_assign, true_gate_assign,
                       full_gate_grads, exp_preds: List[Tensor], n: int,
                       lambda_bal: float = 0.0, name=None) -> Tensor:
        ins = [gate_preds, gate_assign, true_gate_assign, full_gate_grads] + \
            list(exp_preds)
        return self._add_layer(OperatorType.OP_AGG_SPEC, ins,
                               {"n": n, "lambda_bal": lambda_bal},
                               exp_preds[0].dtype, name)

    def cache(self, input: Tensor, num_batches: int, score_fn=None,
              name=None):
        """Keep ``input`` across steps (``ops/moe_ops.CacheOp``): ``fit``
        runs ``score_fn(cached, fresh)`` on host copies every
        ``num_batches`` steps into ``cache_scores``, which a
        ``RecompileState`` trigger reads."""
        return self._unary(OperatorType.OP_CACHE, input,
                           {"num_batches": num_batches, "score_fn": score_fn},
                           name)

    def _moe_gate(self, input: Tensor, num_exp: int, num_select: int):
        """The router of ``moe`` and ``moe_experts``: gate dense ->
        softmax -> top_k, as the JAX builders build it (neither opts the
        softmax or the top-k into its kernel)."""
        gate = self.dense(input, num_exp, name="moe_gate")
        gate = self.softmax(gate)
        values, assign = self.top_k(gate, num_select)
        return gate, values, assign

    def moe(self, input: Tensor, num_exp: int, num_select: int,
            expert_hidden_size: int, alpha: float = 2.0,
            lambda_bal: float = 0.04) -> Tensor:
        """Composite MoE layer (reference: FFModel::moe,
        src/ops/moe.cc:20-45): gate dense -> softmax -> top_k -> group_by
        -> per-expert dense -> aggregate."""
        gate, values, assign = self._moe_gate(input, num_exp, num_select)
        grouped = self.group_by(input, assign, num_exp, alpha)
        exp_preds = [
            self.dense(g, expert_hidden_size,
                       activation=ActiMode.AC_MODE_RELU,
                       name=f"moe_expert_{i}")
            for i, g in enumerate(grouped)
        ]
        return self.aggregate(values, assign, assign, gate, exp_preds,
                              num_exp, lambda_bal)

    def experts(self, dispatched: Tensor, out_dim: int,
                activation=ActiMode.AC_MODE_RELU, use_bias: bool = True,
                name=None) -> Tensor:
        """Every expert's dense layer as one batched product over a
        stacked (n, cap, d) dispatch (ops/moe_ops.py ``ExpertsOp``)."""
        n = dispatched.dims[0]
        return self._unary(OperatorType.OP_EXPERTS, dispatched,
                           {"n": n, "out_dim": out_dim,
                            "activation": activation, "use_bias": use_bias},
                           name)

    def moe_experts(self, input: Tensor, num_exp: int, num_select: int,
                    expert_hidden_size: int, alpha: float = 2.0,
                    lambda_bal: float = 0.04) -> Tensor:
        """``moe`` through the batched Experts op: gate dense -> softmax ->
        top_k -> stacked group_by -> Experts (one batched product) ->
        aggregate. The same function as ``moe``."""
        gate, values, assign = self._moe_gate(input, num_exp, num_select)
        grouped = self._add_layer(
            OperatorType.OP_GROUP_BY, [input, assign],
            {"n": num_exp, "alpha": alpha, "stacked": True},
            input.dtype, "moe_group_by")
        exp_out = self.experts(grouped, expert_hidden_size,
                               name="moe_experts")
        return self.aggregate(values, assign, assign, gate, [exp_out],
                              num_exp, lambda_bal)

    def constant(self, value, dtype: Optional[DataType] = None, name=None):
        """Frozen host tensor as a graph node (position ids)."""
        value = np.asarray(value)
        if dtype is None:
            dtype = numpy_to_dtype(value.dtype)
        return self._add_layer(OperatorType.OP_CONSTANT, [],
                               {"value": value}, dtype, name)

    # ========================================================= observability
    def _obs_tracer(self):
        """The process tracer, enabled the first time the config asks for a
        trace file (flexflow_tpu/model.py:466-474); the no-op singleton
        otherwise."""
        from .obs import enable, get_tracer

        t = get_tracer()
        if not t.enabled and self.config.trace_file and self._writes_files():
            t = enable(trace_file=self.config.trace_file)
        return t

    def _writes_files(self) -> bool:
        """Trace, telemetry, profiler and strategy files are written by
        rank 0 alone on a mesh (every rank would write the same)."""
        if self.mesh is None:
            return True
        from .parallel.mesh import world

        return world()[0] == 0

    def get_telemetry(self):
        """StepTelemetry of the most recent fit or serve run (None when
        that run recorded none)."""
        return self._telemetry

    def _make_telemetry(self, tracer, batch_size: int, phase: str):
        """A StepTelemetry when a sink wants one, else None — the None-ness
        is the hot loop's one instrumentation gate
        (flexflow_tpu/model.py:481-515). ``_telemetry_requested`` is the
        in-process opt-in of callers that read ``get_telemetry()`` directly
        (the keras ``TelemetryCallback``); it is consumed here, so one arm
        instruments one fit. MFU is against the peak of the cards the step
        runs on: one card's times the mesh's size (the step's model FLOPs
        cover the global batch)."""
        requested = getattr(self, "_telemetry_requested", False)
        self._telemetry_requested = False
        if not (self.config.telemetry_file or tracer.enabled or requested) \
                or not self._writes_files():
            return None
        from .obs.telemetry import (StepTelemetry, detect_peak_flops,
                                    model_flops_per_step)

        tel = StepTelemetry(batch_size=batch_size, phase=phase)
        if self.pcg is not None:
            tel.flops_per_step = model_flops_per_step(self.pcg)
        peak = detect_peak_flops() if self.device.type == "cuda" else None
        if peak is not None and self.mesh is not None:
            peak *= self.mesh.numel
        tel.peak_flops = peak
        return tel

    # ================================================================= compile
    def compile(self, optimizer=None,
                loss_type: LossType =
                LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Optional[List[MetricsType]] = None,
                comp_mode: CompMode = CompMode.COMP_MODE_TRAINING,
                strategy=None, strategy_fn=None,
                final_tensor: Optional[Tensor] = None) -> None:
        """Lower the Layer graph to a PCG and build the executor on one
        device, then initialize the parameters from ``config.seed`` and the
        optimizer state (reference pipeline: src/runtime/model.cc:2803).
        The optimizer defaults to ``SGDOptimizer``; the label tensor is
        (batch, 1) int32 for sparse categorical cross-entropy, else the
        final output's shape. ``--fusion`` merges op chains into FusedOp
        regions (``ops/fused.apply_fusion``, the final anchor a barrier;
        under a strategy only the nodes it does not pin, before a
        pipeline split). The whole lowering is one ``compile`` span of the process tracer,
        and ``--trace-file`` is written after it
        (flexflow_tpu/model.py:519-538).

        The strategy (flexflow_tpu/model.py:590-671): ``strategy_fn(pcg)``
        or ``strategy``, else ``--import-strategy``'s file (each checked by
        ``preflight_strategy`` first), else with ``--mesh-shape`` a mesh of
        that shape with the batch over its first axis, else with
        ``--only-data-parallel`` (or on one device without
        ``--search-num-*``) data parallelism over every rank, else the
        Unity search (:meth:`_run_search`: the same search on every rank,
        its digest agreed). Any of them builds the device mesh and the
        executor's SPMD plan; ``--static-analysis strict`` runs ShardLint
        on the plan first; ``--export-strategy`` writes the strategy's JSON
        and ``--compgraph`` the PCG's dot text (rank 0). With none, in one
        process, the executor runs on one device. A strategy
        with a pipeline grid also builds the ``PipelineTrainer`` that
        ``fit`` trains through (flexflow_tpu/model.py:716-735): schedule
        ``--schedule`` > the strategy's > gpipe, stage remat ``--remat`` >
        the strategy's > full; it is seeded from the params at fit."""
        tracer = self._obs_tracer()
        with tracer.span("compile", layers=len(self._layers)):
            self._compile_impl(optimizer, loss_type, metrics, final_tensor,
                               strategy, strategy_fn)
        if tracer.enabled and self.config.trace_file and self._writes_files():
            # flushed after each top-level phase, so compile-only sessions
            # (and crashes later on) still leave a loadable trace
            tracer.write(self.config.trace_file)

    def _compile_impl(self, optimizer, loss_type, metrics, final_tensor,
                      strategy, strategy_fn) -> None:
        from .execution.executor import Executor
        from .resilience.preflight import preflight_config

        # flag-combination sanity before any other work; it covers values
        # set as attributes too (flexflow_tpu/model.py:556-562)
        preflight_config(self.config)
        if optimizer is not None:
            self.optimizer = optimizer
        if self.optimizer is None:
            self.optimizer = SGDOptimizer(self)
        self.loss_type = loss_type
        self.metrics_obj = Metrics(loss_type, metrics or [])
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
        # each compile decides afresh whether a --search-num-* target
        # search took the export slot, and drops an earlier search's result
        self._exported_search_target = False
        self._search_result = None
        # the ranked runners-up of this compile's search (the cascade's
        # fallback chain); a compile that does not search has none
        self._strategy_candidates = []
        # a warm simulator handed in by elastic_restore for its re-search,
        # on the live world (flexflow_tpu/model.py:599-604: the port's
        # mesh covers every rank, so elastic_restore refuses another n_dev)
        handed = self._search_sim if self._elastic_n_dev else None
        self._search_sim = None
        strategy, mesh = self._resolve_strategy(pcg, strategy, strategy_fn,
                                                handed)
        self.strategy, self.mesh = strategy, mesh
        if mesh is not None:
            self.device = mesh.device
        if (self.config.static_analysis or "on") == "strict":
            # ShardLint judges every compiled plan (explicit, imported or
            # searched) before the executor exists
            # (flexflow_tpu/model.py:643-663)
            from .analysis import StaticAnalysisError, analyze_model
            from .parallel.strategy import data_parallel_strategy

            # the one-device path judges the JAX package's 1-device plan
            self.strategy = strategy or data_parallel_strategy(pcg, 1)
            try:
                report = analyze_model(self, pcg=pcg)
            finally:
                self.strategy = strategy
            if report.errors:
                raise StaticAnalysisError(
                    report, context="compile under --static-analysis "
                    "strict")
        if self.config.export_strategy_file and self._writes_files() and \
                not self._exported_search_target:
            from .parallel.mesh import world
            from .parallel.strategy import data_parallel_strategy

            with open(self.config.export_strategy_file, "w") as f:
                f.write((strategy or data_parallel_strategy(
                    pcg, world()[1])).to_json(pcg))
        if self.config.export_strategy_computation_graph_file and \
                self._writes_files():
            with open(self.config.export_strategy_computation_graph_file,
                      "w") as f:
                f.write(pcg.to_dot(
                    include_costs=self.config.include_costs_dot_graph))
        # the host-side agreements of a mesh (rollback target, resume
        # path, preemption, checkpoint staging), made once by every rank
        from .parallel.mesh import coordination_group

        self.coordination = coordination_group() if mesh is not None \
            else None
        if self.config.perform_fusion:
            from .ops.fused import apply_fusion

            # under a strategy only the nodes it does not pin fuse, and
            # the members' entries go (flexflow_tpu/model.py:674-693),
            # before the pipeline split below
            pcg, n_fused, remap = apply_fusion(
                pcg, strategy, barrier_guids=(self.final_guid,))
            if n_fused:
                if final_tensor is not None:
                    # the barrier leaves the anchor unfused or a region
                    # tail; follow the remap either way
                    new_guid, new_idx = remap[self.final_guid]
                    self.final_guid = new_guid
                    if new_idx >= 0:
                        self.final_out_idx = new_idx
                    final = pcg.nodes[self.final_guid]
                else:
                    final = [n for n in pcg.sinks()
                             if n.op.op_type != OperatorType.OP_INPUT][-1]
                    self.final_guid = final.guid
                    self.final_out_idx = 0
        out_shape = final.out_shapes[self.final_out_idx]
        if loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
            label_shape, label_dtype = (out_shape[0], 1), DataType.DT_INT32
        else:
            label_shape = out_shape
            label_dtype = final.out_dtypes[self.final_out_idx]
        self.label_tensor = Tensor(label_shape, label_dtype, name="label",
                                   model=self)
        self.pcg = pcg
        self.executor = Executor(
            pcg, self.config, self.final_guid, self.device,
            final_out_idx=self.final_out_idx, loss_type=loss_type,
            metrics=self.metrics_obj, optimizer=self.optimizer,
            repl_labels=final.op.op_type == OperatorType.OP_AGG_SPEC,
            strategy=strategy, mesh=mesh)
        self.params = self.executor.init_params(self.config.numpy_seed())
        self.opt_state = self.optimizer.init_state(self.params)
        self._serving_engine = None
        self._pipeline_trainer = None
        self._pipeline_param_stamp = None
        if strategy is not None and strategy.pipeline:
            from .execution.remat import resolve_stage_remat
            from .parallel.pipeline import PipelineTrainer, resolve_schedule

            pp, pdp, n_micro = strategy.pipeline
            sched, v = resolve_schedule(self.config, strategy)
            self._pipeline_trainer = PipelineTrainer(
                self, pp=pp, dp=pdp, n_micro=n_micro,
                optimizer=self.optimizer, loss_type=loss_type,
                init_params=False,  # fit seeds it from the live params
                remat=resolve_stage_remat(self.config, strategy),
                schedule=sched, virtual_stages=v,
                capture=self._capture_steps and self.device.type == "cuda")

    def _resolve_strategy(self, pcg, strategy, strategy_fn, sim=None):
        """(Strategy, Mesh) of this compile, or (None, None) for the
        one-device path (:meth:`compile`). ``sim`` is a warm simulator for
        the search (an elastic restore's). The cascade's last resort in
        one process without a process group (``_one_device_plan``) keeps
        its one-rank strategy on the one-device path (mesh None), for its
        remat level."""
        import torch.distributed as dist

        from .parallel.mesh import (build_mesh, initialize_multihost,
                                    mesh_for_strategy, world)
        from .parallel.strategy import Strategy, data_parallel_strategy
        from .resilience.preflight import preflight_strategy

        c = self.config
        n_dev = world()[1]
        dev = self.device.type
        if strategy_fn is not None:
            strategy = strategy_fn(pcg)
        mesh = None
        searching = c.search_num_nodes > 0 or c.search_num_workers > 0
        if strategy is None and c.import_strategy_file:
            with open(c.import_strategy_file) as f:
                strategy = Strategy.from_json(f.read(), pcg)
        if strategy is not None:
            preflight_strategy(pcg, strategy, n_dev=n_dev,
                               batch_size=c.batch_size)
            if self._one_device_plan and n_dev == 1 and \
                    not strategy.pipeline and \
                    all(int(d) == 1 for d in strategy.mesh_shape) and \
                    not (dist.is_available() and dist.is_initialized()):
                return strategy, None
        elif c.mesh_shape:
            # an explicit mesh: the batch over its first axis
            mesh = build_mesh(c, device_type=dev)
            strategy = data_parallel_strategy(pcg, mesh.sizes[0],
                                              axis_names=mesh.axis_names)
        elif c.only_data_parallel or (n_dev == 1 and not searching):
            if n_dev > 1:
                strategy = data_parallel_strategy(pcg, n_dev)
        else:
            if n_dev > 1:
                initialize_multihost(device_type=dev)
            strategy = self._run_search(pcg, n_dev, sim)
        if strategy is None:
            return None, None
        if mesh is None:
            mesh = mesh_for_strategy(c, strategy, device_type=dev)
        return strategy, mesh

    def _run_search(self, pcg, n_dev, sim=None):
        """The Unity search's strategy for this compile
        (flexflow_tpu/model.py:766-852), or None for the one-device path.

        ``--search-num-nodes/-workers`` naming another device count than
        the world's search for that target machine (with a multi-node
        target and no machine file, the machine carries the node split),
        write ``--export-strategy`` and run data parallel on the ranks
        there are (one device: the one-device path). Otherwise every rank
        runs the same deterministic search from the same inputs (the
        analytic cost model, the same calibration file, the seeded MCMC).
        ``unity_search`` rewrites the PCG in place (greedy fusions,
        substitutions, inserted parallel-op nodes), so rank 0's strategy
        JSON alone could not be broadcast: the other ranks' PCGs would lack
        the rewritten nodes. Instead the ranks agree a digest of the
        strategy's JSON and the rewritten PCG's node list
        (:func:`_search_digest`) over the coordination group, and a
        mismatch raises on every rank, naming the ranks that differ."""
        from .parallel.mesh import world
        from .parallel.strategy import data_parallel_strategy
        from .search.unity import SearchResult, unity_search

        c = self.config
        n_search = n_dev
        nodes = c.search_num_nodes if c.search_num_nodes > 0 \
            else c.num_nodes
        if c.search_num_nodes > 0 or c.search_num_workers > 0:
            workers = (c.search_num_workers if c.search_num_workers > 0
                       else max(c.workers_per_node, 1))
            n_search = max(nodes * workers, 1)
        if n_search != n_dev:
            if c.export_strategy_file:
                machine = None
                file_used = (c.machine_model_version == 1
                             and c.machine_model_file)
                if nodes > 1 and n_search % nodes == 0 and not file_used:
                    from .search.machine_model import GPUMachineModel

                    machine = GPUMachineModel.detect(
                        n_search, num_hosts=nodes, device=self.device)
                target_pcg = pcg.copy()
                strat = unity_search(target_pcg, c, n_search,
                                     machine=machine,
                                     protected_guids=(self.final_guid,),
                                     device=self.device)
                if world()[0] == 0:
                    with open(c.export_strategy_file, "w") as f:
                        f.write(strat.to_json(target_pcg))
                self._exported_search_target = True
            else:
                import warnings

                warnings.warn(
                    "--search-num-nodes/--search-num-workers target "
                    f"{n_search} devices but {n_dev} are available and no "
                    "--export-strategy file is set; skipping the target "
                    "search and running data-parallel")
            return data_parallel_strategy(pcg, n_dev) if n_dev > 1 \
                else None
        if world()[0] != 0:
            # every rank searches; rank 0 alone writes --search-log
            import copy

            c = copy.copy(c)
            c.search_log_file = ""
        res = unity_search(pcg, c, n_dev,
                           protected_guids=(self.final_guid,),
                           return_result=True, device=self.device, sim=sim)
        if isinstance(res, SearchResult):
            self._search_result = res
            # the ranked fallback chain the strategy-safety cascade
            # degrades through (flexflow_tpu/model.py:837-850)
            self._strategy_candidates = list(res.ranked)
            # the warm simulator: the drift loop repairs THIS ruler, and an
            # elastic restore reuses its tables; a new ruler obsoletes the
            # sentinel and its simulator of an earlier compile
            self._search_sim = res.sim
            self._calibration_sim = None
            self._drift_sentinel = None
            strategy = res.strategy
        else:
            strategy = res  # nothing better: plain data parallelism
        self._agree_search(pcg, strategy)
        if n_dev == 1 and not strategy.pipeline and \
                all(d == 1 for d in strategy.mesh_shape):
            return None
        return strategy

    def _agree_search(self, pcg, strategy) -> None:
        """Every rank's search must have reached the same plan
        (:meth:`_run_search`): the digests are gathered over the
        coordination group, and any difference raises on every rank."""
        import torch.distributed as dist

        from .parallel.mesh import coordination_group

        group = coordination_group()
        digest = _search_digest(pcg, strategy)
        self._search_digest = digest
        if group is None:
            return
        got = [None] * dist.get_world_size(group)
        dist.all_gather_object(got, digest, group=group)
        odd = [r for r, d in enumerate(got) if d != got[0]]
        if odd:
            raise RuntimeError(
                f"compile: the ranks' searches disagree: ranks {odd} reached "
                f"another plan than rank 0 (digests {sorted(set(got))}); "
                "every rank must search from the same graph, config, "
                "machine and calibration")

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
        np.ndarray}}`` pytree (same names, same layouts, fp32 masters). On
        a mesh every rank gets the full arrays (each rank must call it)."""
        from .utils.weights import params_to_numpy

        self._require_compiled()
        return params_to_numpy(self.params, self.executor.gather_param)

    def set_params_numpy(self, np_params: Dict[str, Dict[str, Any]]) -> None:
        """Load a ``{node_name: {wname: array}}`` pytree — e.g. the JAX
        package's ``ff.params`` through ``jax.device_get`` — 1:1 into this
        model. Names, shapes and dtypes must match the model's own. On a
        mesh each rank passes the full arrays and keeps its shards."""
        from .utils.weights import params_from_numpy

        self._require_compiled()
        expected = {(n.name, w): (tuple(shape), dt)
                    for n, w, shape, dt, _ in self.executor.weight_entries()}
        # the captured steps hold the old tensors' addresses
        self.executor.invalidate_jit_cache()
        self.params = params_from_numpy(np_params, self.device,
                                        expected=expected,
                                        place=self.executor.shard_param)
        # fresh moments for the fresh weights
        self.opt_state = self.optimizer.init_state(self.params)
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
        # a host copy: the train step updates the params in place, so a
        # view of a CPU tensor would change under its holder
        return self.executor.gather_param(
            lname, wname,
            self.params[lname][wname]).detach().cpu().numpy().copy()

    def _set_weight_by_tensor(self, tensor: Tensor, arr: np.ndarray) -> None:
        import torch

        self._require_compiled()
        lname, wname = self._locate_weight(tensor)
        cur = self.params[lname][wname]
        arr = np.asarray(arr)
        want = tuple(tensor.dims)
        if tuple(arr.shape) != want:
            raise ValueError(f"{tensor.name}: shape {arr.shape} != {want}")
        new = dict(self.params)
        new[lname] = dict(new[lname])
        new[lname][wname] = self.executor.shard_param(
            lname, wname, torch.tensor(arr, dtype=cur.dtype))  # a copy
        self.executor.invalidate_jit_cache()
        self.params = new
        self._serving_engine = None

    # =============================================================== training
    def _next_rng(self):
        """The step's generator, seeded as the JAX package seeds its step
        key (``seed * 100003 + counter``); a CPU generator, so drawing a
        dropout seed never syncs the device."""
        import torch

        self._rng_counter += 1
        return torch.Generator().manual_seed(
            self.config.numpy_seed() * 100003 + self._rng_counter)

    @staticmethod
    def _as_input_list(x) -> List[np.ndarray]:
        if isinstance(x, (list, tuple)):
            return [np.asarray(a) for a in x]
        return [np.asarray(x)]

    def _prep_label(self, y) -> np.ndarray:
        y = np.asarray(y)
        if self.loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
            if y.ndim >= 2 and int(np.prod(y.shape[1:])) > 1:
                return y.astype(np.int32)  # token-level targets (causal LM)
            y = y.reshape(y.shape[0], 1).astype(np.int32)
        return y

    def _refuse_fit_options(self) -> None:
        """``--schedule`` / ``--virtual-stages`` without a pipeline
        strategy would be parsed and ignored, so they raise."""
        c = self.config
        if self._pipeline_trainer is None and (
                c.schedule or int(c.pipeline_virtual_stages or 0)):
            raise ValueError(
                "fit: --schedule / --virtual-stages order a pipeline "
                "strategy's microbatches, and this model compiled without "
                "a pipeline grid; compile with a strategy whose pipeline "
                "is (pp, dp, n_micro), or drop the flags")

    def fit(self, x=None, y=None, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, callbacks=None,
            recompile_state=None, shuffle: bool = True,
            chaos=None) -> PerfMetrics:
        """Training loop (reference: flexflow_cffi.py:2058-2100; the JAX
        package's SPMD loop, flexflow_tpu/model.py:875-1168): shuffled
        epochs (epoch e shuffles with seed ``config.seed + e``), batches
        staged onto the device one ahead, one train step per batch with
        the step's generator from ``_next_rng``, metrics folded on the host
        once per epoch. The step is the executor's captured program
        (``Executor.make_train_step``): on CUDA a batch shape's first step
        runs eagerly and later ones replay its CUDA graph; each step's loss
        and metrics come back as device copies, so the per-step values kept
        here stay distinct without a sync. ``--profiling`` prints the JAX
        package's ``step``, ``epoch`` and ``THROUGHPUT`` lines verbatim and
        records each step's wall in ``fit_history.step_s``.

        Fault tolerance, when the config asks for it (``--checkpoint-dir``
        / ``--checkpoint-every`` / ``--resume`` / ``--max-bad-steps``) or
        ``chaos`` (a ``resilience.ChaosPlan``) is given: a
        ``ResilienceSession`` resumes from the newest committed checkpoint
        into the same epoch and batch (``batch_iterator(start_batch=)``,
        the rng counter restored), runs each batch through the guarded step
        (one bool a step comes to the host), takes an async atomic
        checkpoint every ``--checkpoint-every`` steps, rolls back to the
        last committed one after ``--max-bad-steps`` bad steps in a row
        (cutting the LR from the second rollback on), and on SIGTERM or
        SIGINT finishes the step in flight, flushes a final checkpoint and
        returns (``_preempted_at_step``). Its counters stay readable as
        ``self.resilience.summary()``. On a mesh of several ranks every
        rank runs the session and decides alike (``resilience/session``):
        sharded checkpoints, the verdict reduced over the world, rank 0's
        rollback and resume targets, a preemption on any rank stopping
        all after the same step. The forward follows ``--remat``.
        An ``Optimizer.set_learning_rate`` since the last fit drops the
        captured steps, which baked the old rate in.

        CacheOps thread their state through the step (``init_cache``): the
        fresh values are copied into the cache tensors in place after each
        good step, and every ``num_batches`` steps ``score_fn`` runs on
        host copies into ``cache_scores``. ``recompile_state`` (a
        ``RecompileState``) is checked after every step; when it fires the
        model is compiled anew (the old programs dropped, the cache made
        anew) and the same epoch runs again (flexflow_tpu/model.py:
        1094-1128).

        Observability, when the config asks for it: ``--telemetry-file``
        (or an enabled tracer) keeps a ``StepTelemetry`` — each step then
        waits for its loss to reach the host, the opt-in sync that buys
        true step walls — and writes it at the end with the card's peak
        memory (``get_telemetry()``); the tracer gets a ``train_step``
        event a step and an ``epoch`` event an epoch (``--trace-file``
        written at the end); ``--profiler-trace-dir`` runs the loop under
        ``torch.profiler`` (``obs.start_trace``). With these off the loop
        pays one ``is not None`` test a step.

        Strategy safety (flexflow_tpu/model.py:922-933): with
        ``--audit-strategy``, ``--memory-budget-mb`` or a pending strategy
        injection in ``chaos``, ``resilience.StrategyCascade`` verifies the
        plan before the loop (ShardLint, preflight, one probe step on
        clones, the measured memory peak, the audit against a one-device
        reference) and degrades through the search's ranked runners-up to
        data parallelism with full remat; it is ``self._last_cascade``
        (None when unarmed) and its counters join the telemetry. The
        closed calibration loop (``obs.drift.CalibrationLoop``): with
        ``--profile-ops PATH`` one profiled pass a fit times every distinct
        op shape, appends the records to PATH, and the drift sentinel
        compares them with the simulator (``--drift-tolerance``); with
        ``--auto-recalibrate`` the out-of-band keys are repaired and the
        runners-up re-ranked. A pipeline strategy trains through
        :meth:`_fit_pipeline`."""
        import torch

        from .data.dataloader import batch_iterator, prefetch_iterator
        from .resilience.preflight import validate_batch
        from .resilience.session import ResilienceSession

        self._require_compiled()
        self._refuse_fit_options()
        if self._pipeline_trainer is not None:
            return self._fit_pipeline(x, y, batch_size, epochs, shuffle,
                                      chaos)
        if recompile_state is not None:
            self._recompile_state = recompile_state
            recompile_state.ffmodel = self
        xs = self._as_input_list(x)
        y = self._prep_label(y)
        batch_size = batch_size or self.config.batch_size
        epochs = epochs or self.config.epochs
        validate_batch(self, xs, y, phase="fit")
        # the strategy-safety cascade: may recompile (a new executor and
        # strategy), so it runs before anything binds them
        from .resilience.fallback import StrategyCascade

        cascade = StrategyCascade.maybe_create(self, chaos)
        self._last_cascade = cascade
        if cascade is not None:
            cascade.preverify(xs, y, batch_size)
        if getattr(self.optimizer, "_lr_changed", False):
            # set_learning_rate since the steps were captured: they baked
            # the old rate in (as the JAX keras loop watches the flag)
            self.executor.invalidate_jit_cache()
        session = None
        if ResilienceSession.wanted(self.config, chaos):
            session = ResilienceSession(self, chaos=chaos)
            session.install_signal_handlers()
        self.resilience = session
        guard = session.guard if session is not None else None
        step_fn = (None if guard is not None else
                   self.executor.make_train_step(capture=self._capture_steps))
        profiling = bool(self.config.profiling)
        cuda = self.device.type == "cuda"
        self._perf = PerfMetrics()
        self.fit_history = FitHistory()
        steps_per_epoch = xs[0].shape[0] // batch_size
        losses = []
        step_count = executed = 0
        epoch0 = skip_batches = 0
        loss_val = None
        self._preempted_at_step = None
        cache = (self.executor.init_cache()
                 if self.executor.cache_nodes else None)
        # observability: with every sink off, telemetry is None and the
        # loop below pays one test a step
        tracer = self._obs_tracer()
        telemetry = self._make_telemetry(tracer, batch_size, "train")
        self._telemetry = telemetry
        if cascade is not None:
            cascade.merge_telemetry(telemetry)
        if telemetry is not None and cuda and self.config.telemetry_file:
            torch.cuda.reset_peak_memory_stats(self.device)
        last_batch = None
        if profiling:
            self.profile_operators()
        from .obs.drift import CalibrationLoop

        calib = CalibrationLoop.maybe_create(self)
        if calib is not None:
            calib.run_pass(xs, batch_size, telemetry, step=step_count)
        tracing = bool(self.config.profiler_trace_dir) and \
            self._writes_files()
        if tracing:
            from .obs import start_trace

            start_trace(self.config.profiler_trace_dir)
        t0 = time.time()
        try:
            if session is not None:
                resumed = session.maybe_resume()
                if resumed is not None:
                    step_count, epoch0, skip_batches = resumed
                    if steps_per_epoch and skip_batches >= steps_per_epoch:
                        epoch0 += skip_batches // steps_per_epoch
                        skip_batches %= steps_per_epoch
            t0 = time.time()
            epoch = epoch0
            preempted = False
            while epoch < epochs:
                # start_batch replays an interrupted epoch's tail: the same
                # seed reproduces the shuffle, the cursor skips what the
                # restored checkpoint already consumed; on a mesh every rank
                # draws the same shuffle and stages its slice of each batch
                it = (self.executor.local_batch(b) for b in batch_iterator(
                    xs + [y], batch_size, shuffle=shuffle,
                    seed=self.config.numpy_seed() + epoch,
                    start_batch=skip_batches))
                batch_in_epoch = skip_batches
                skip_batches = 0
                epoch_metrics = []
                rolled_back = recompiled = False
                t_epoch = time.perf_counter()
                for batch in prefetch_iterator(it, self.device):
                    bx, by = batch[:-1], batch[-1]
                    if session is not None and session.chaos is not None:
                        bx = session.chaos.poison_batch(step_count, bx)
                        session.chaos.maybe_preempt(step_count, session)
                    t_step = time.perf_counter()
                    step_ok = True
                    args = (self.params, self.opt_state, bx, by,
                            self._next_rng()) + \
                        ((cache,) if cache is not None else ())
                    if guard is not None:
                        outs, step_ok = guard(*args)
                    else:
                        outs = step_fn(*args)
                    self.params, self.opt_state, loss_val, m = outs[:4]
                    if cache is not None and step_ok:
                        self._score_caches(cache, outs[4], step_count)
                        for name, fresh in outs[4].items():
                            cache[name].copy_(fresh)
                    step_count += 1
                    batch_in_epoch += 1
                    executed += 1
                    losses.append(loss_val)
                    if step_ok:
                        # a skipped step's NaN metrics stay out of the fold
                        epoch_metrics.append(m)
                    loss_f = None
                    if telemetry is not None:
                        # the opt-in sync: the loss reaches the host, so
                        # the wall is the step's
                        loss_host = float(loss_val)
                        wall = time.perf_counter() - t_step
                        loss_f = loss_host if step_ok else None
                        telemetry.record_step(wall, loss_f)
                        tracer.complete("train_step", wall, step=step_count,
                                        loss=loss_f)
                        last_batch = (bx, by)
                    if profiling:
                        if cuda:
                            torch.cuda.synchronize(self.device)
                        self.fit_history.step_s.append(
                            time.perf_counter() - t_step)
                        if step_count % max(self.config.print_freq, 1) == 0:
                            print(f"step {step_count}: loss="
                                  f"{float(loss_val):.4f}")
                    if not step_ok:
                        session.record_fault(step_count - 1)
                        if guard.should_rollback:
                            step_count, epoch, skip_batches = \
                                session.rollback()
                            if cache is not None:
                                self.executor.init_cache()  # in place
                            epoch_metrics = []  # poisoned partials dropped
                            rolled_back = True
                            break
                    if session is not None:
                        session.on_step(step_count, epoch, batch_in_epoch,
                                        steps_per_epoch)
                        if session.preempted:
                            # finish cleanly: a final committed checkpoint
                            self._preempted_at_step = step_count
                            session.note_preemption(step_count)
                            session.final_checkpoint(step_count, epoch,
                                                     batch_in_epoch,
                                                     steps_per_epoch)
                            preempted = True
                            break
                    if self._recompile_state is not None and \
                            self.recompile_on_condition(
                                self._recompile_state):
                        # a new executor: its own steps and cache, and the
                        # same epoch again (the old programs went with the
                        # old executor)
                        if guard is not None:
                            guard.executor = self.executor
                        else:
                            step_fn = self.executor.make_train_step(
                                capture=self._capture_steps)
                        cache = (self.executor.init_cache()
                                 if self.executor.cache_nodes else None)
                        recompiled = True
                        break
                # the epoch's metrics, the partial ones before a recompile
                # too (those steps trained the old graph but count)
                for m in epoch_metrics:
                    self._perf.update({k: (v.item() if torch.is_tensor(v)
                                           else v) for k, v in m.items()})
                if rolled_back or recompiled:
                    continue  # re-enter at the restored cursor / same epoch
                if preempted:
                    break
                if telemetry is not None:
                    loss_f = (float(loss_val) if loss_val is not None
                              else None)
                    telemetry.record_epoch(loss_f)
                    tracer.complete("epoch", time.perf_counter() - t_epoch,
                                    index=epoch, loss=loss_f)
                if profiling and loss_val is not None:
                    print(f"epoch {epoch}: loss={float(loss_val):.4f}")
                epoch += 1
        finally:
            if tracing:
                from .obs import stop_trace

                stop_trace()
            if session is not None:
                session.close(telemetry)
        if losses:
            self.fit_history.loss = torch.stack(losses).cpu().tolist()
        elapsed = time.time() - t0
        self._last_fit_time = elapsed
        # executed steps: a resume's skipped batches do not count, a
        # rollback's replayed ones do
        self._last_fit_samples = executed * batch_size
        if elapsed > 0:
            throughput = self._last_fit_samples / elapsed
            if tracer.enabled:
                tracer.counter("throughput_samples_per_sec",
                               round(throughput, 2))
            if profiling:
                print(f"THROUGHPUT = {throughput:.2f} samples/s")
        if telemetry is not None:
            telemetry.finalize()
            if self.config.telemetry_file and last_batch is not None:
                from .obs.telemetry import capture_memory_analysis

                telemetry.device_memory = capture_memory_analysis(
                    self.executor, self.params, self.opt_state, *last_batch)
            if self.config.telemetry_file:
                telemetry.write(self.config.telemetry_file)
        if tracer.enabled and self.config.trace_file and self._writes_files():
            tracer.write(self.config.trace_file)
        return self._perf

    def _fit_pipeline(self, x, y, batch_size, epochs, shuffle,
                      chaos) -> PerfMetrics:
        """The training loop of a pipeline strategy
        (flexflow_tpu/model.py:1184-1267): every batch through
        ``PipelineTrainer.train_step``, then the trained weights copied
        back into the executor's params on the strategy's mesh, so
        ``eval``, ``predict`` and ``get_params_numpy`` see them. The
        trainer is seeded from those params when they changed since the
        last pipeline fit (a weight edit, ``set_params_numpy``); unchanged,
        it keeps its params and optimizer state across fits. The
        microbatch count is re-derived for the batch size. ``chaos``
        raises ``ValueError`` as the JAX package does; the checkpoint
        flags, which the JAX package ignores here, raise, naming
        themselves (``save_checkpoint`` on the model works: the params are
        synced back after each fit). Metrics are the loss's (``train_all`` and the loss
        sum); accuracy-style metrics come from ``eval``."""
        import torch

        from .data.dataloader import batch_iterator
        from .resilience.preflight import validate_batch

        if chaos is not None:
            raise ValueError(
                "chaos injection targets the SPMD fit loop; the pipeline "
                "trainer is not covered")
        c = self.config
        flags = [f for on, f in (
            (bool(c.checkpoint_dir), "--checkpoint-dir"),
            (bool((c.resume or "").strip()), "--resume"),
            (int(c.max_bad_steps or 0) > 0, "--max-bad-steps"),
            (bool(c.audit_strategy), "--audit-strategy"),
            (int(c.memory_budget_mb or 0) > 0, "--memory-budget-mb"),
            (bool(c.profile_ops), "--profile-ops")) if on]
        if flags:
            raise NotImplementedError(
                f"fit: {', '.join(flags)} on a pipeline strategy "
                f"{'is' if len(flags) == 1 else 'are'} refused: the JAX "
                "package's pipeline loop ignores them, and the port does "
                "not take a flag it would ignore (ROADMAP C, kept "
                "deviation); save_checkpoint / restore_checkpoint on the "
                "model save and restore the stages' synced-back params")
        xs = self._as_input_list(x)
        y = self._prep_label(y)
        batch_size = batch_size or c.batch_size
        epochs = epochs or c.epochs
        validate_batch(self, xs, y, phase="fit")
        tr = self._pipeline_trainer
        if getattr(self.optimizer, "_lr_changed", False):
            # the stages' update programs baked the old rate in
            tr.reset_programs()
            self.optimizer._lr_changed = False
        stamp = self.executor._params_stamp(self.params)
        if tr.params is None or self._pipeline_param_stamp is None or \
                not self.executor._stamp_matches(self._pipeline_param_stamp,
                                                 stamp):
            tr.load_params(self.get_params_numpy())
        # the microbatch count was chosen for config.batch_size; re-derive
        # it for the batch size actually passed
        if batch_size % tr.dp != 0:
            raise ValueError(
                f"pipeline strategy needs batch_size % dp == 0 "
                f"(batch {batch_size}, dp {tr.dp})")
        micro_ok = [m for m in (2 * tr.pp, tr.pp, 2, 1)
                    if batch_size % m == 0 and
                    (batch_size // m) % tr.dp == 0 and
                    (tr.schedule != "interleaved" or m % tr.pp == 0)]
        if not micro_ok:
            raise ValueError(
                f"pipeline schedule {tr.schedule!r} found no microbatch "
                f"count for batch_size {batch_size} (pp={tr.pp}, "
                f"dp={tr.dp}); use a batch divisible by pp*dp")
        tr.n_micro = micro_ok[0]
        loss_key = {
            LossType.LOSS_CATEGORICAL_CROSSENTROPY: "cce_loss",
            LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
                "sparse_cce_loss",
            LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE: "mse_loss",
            LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE: "mse_loss",
        }.get(self.loss_type, "sparse_cce_loss")
        self._perf = PerfMetrics()
        self.fit_history = FitHistory()
        tracer = self._obs_tracer()
        telemetry = self._make_telemetry(tracer, batch_size,
                                         "train_pipeline")
        self._telemetry = telemetry
        t0 = time.time()
        step = 0
        losses = []
        loss_f = None
        for epoch in range(epochs):
            it = batch_iterator(xs + [y], batch_size, shuffle=shuffle,
                                seed=c.numpy_seed() + epoch)
            t_epoch = time.perf_counter()
            for batch in it:
                bx, by = batch[:-1], batch[-1]
                t_step = time.perf_counter()
                loss_f = tr.train_step(list(bx), by, rng_seed=step)
                step += 1
                wall = time.perf_counter() - t_step
                losses.append(loss_f)
                if c.profiling:
                    self.fit_history.step_s.append(wall)
                if telemetry is not None:
                    telemetry.record_step(wall, loss_f)
                    tracer.complete("train_step", wall, step=step,
                                    loss=loss_f)
                self._perf.update({"train_all": by.shape[0],
                                   loss_key: loss_f * by.shape[0]})
                if c.profiling and step % max(c.print_freq, 1) == 0:
                    print(f"step {step}: loss={loss_f:.4f}")
            if telemetry is not None:
                telemetry.record_epoch(loss_f)
                tracer.complete("epoch", time.perf_counter() - t_epoch,
                                index=epoch, loss=loss_f)
        trained = tr.export_params()
        self.executor.invalidate_jit_cache()
        self.params = {n: {w: self.executor.shard_param(
            n, w, torch.from_numpy(trained[n][w]).to(t.dtype))
            for w, t in ws.items()} for n, ws in self.params.items()}
        self.opt_state = self.optimizer.init_state(self.params)
        self._serving_engine = None
        # the sync point: a following fit without a weight edit reuses the
        # trainer's params and optimizer state
        self._pipeline_param_stamp = self.executor._params_stamp(self.params)
        self.fit_history.loss = losses
        self._last_fit_time = time.time() - t0
        self._last_fit_samples = step * batch_size
        if self._last_fit_time > 0:
            throughput = self._last_fit_samples / self._last_fit_time
            if tracer.enabled:
                tracer.counter("throughput_samples_per_sec",
                               round(throughput, 2))
            if c.profiling:
                print(f"THROUGHPUT = {throughput:.2f} samples/s")
        if telemetry is not None:
            telemetry.finalize()
            if c.telemetry_file:
                telemetry.write(c.telemetry_file)
        if tracer.enabled and c.trace_file and self._writes_files():
            tracer.write(c.trace_file)
        return self._perf

    def eval(self, x=None, y=None, batch_size: Optional[int] = None
             ) -> PerfMetrics:
        """Loss and metrics over every batch, the last one partial
        (reference: flexflow_cffi.py:2102); an ``eval`` span of the
        process tracer, and ``--trace-file`` written after it
        (flexflow_tpu/model.py:1306-1320)."""
        import torch

        from .data.dataloader import batch_iterator, to_device
        from .resilience.preflight import validate_batch

        self._require_compiled()
        xs = self._as_input_list(x)
        y = self._prep_label(y)
        batch_size = batch_size or self.config.batch_size
        validate_batch(self, xs, y, phase="eval")
        estep = self.executor.make_eval_step()

        tracer = self._obs_tracer()
        perf = PerfMetrics()
        t_eval = time.perf_counter()
        n_batches = 0
        loss_val = None
        ex = self.executor
        for batch in batch_iterator(xs + [y], batch_size,
                                    drop_remainder=False):
            # this rank's slice, or the whole of a short last batch
            batch = ex.local_batch(batch)
            staged = to_device(batch, self.device)
            loss_val, m = estep(self.params, staged[:-1], staged[-1])
            perf.update({k: (v.item() if torch.is_tensor(v) else v)
                         for k, v in m.items()})
            n_batches += 1
        if tracer.enabled:
            tracer.complete("eval", time.perf_counter() - t_eval,
                            batches=n_batches,
                            loss=(float(loss_val) if loss_val is not None
                                  else None))
            if self.config.trace_file and self._writes_files():
                # eval-only workloads get their trace file too
                tracer.write(self.config.trace_file)
        return perf

    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """Batched inference forward; the final partial batch is padded to
        the full batch (repeating its last row) and trimmed, so every call
        sees the compiled batch shape. Outputs stay on the device until the
        end; floating outputs come back as float32 (numpy has no bf16)."""
        from .data.dataloader import batch_iterator, to_device
        from .resilience.preflight import validate_batch

        self._require_compiled()
        xs = self._as_input_list(x)
        batch_size = batch_size or self.config.batch_size
        validate_batch(self, xs, None, phase="predict")
        fwd = self.executor.make_forward()
        # static rows per sample of the final output
        final = self.pcg.nodes[self.final_guid]
        out_rows = final.out_shapes[self.final_out_idx][0]
        in_rows = self.pcg.input_nodes()[0].out_shapes[0][0]
        per_sample = out_rows // in_rows if in_rows and \
            out_rows % in_rows == 0 else None
        outs = []
        tail_rows = None
        for batch in batch_iterator(xs, batch_size, drop_remainder=False):
            nb = batch[0].shape[0]
            if nb < batch_size and per_sample is not None:
                pad = batch_size - nb
                batch = [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)],
                                        axis=0) for a in batch]
                tail_rows = nb
            batch = self.executor.local_batch(batch)
            outs.append(fwd(self.params, to_device(batch, self.device)))
        host = [o.float().cpu().numpy() if o.is_floating_point()
                else o.cpu().numpy() for o in outs]
        if tail_rows is not None:
            host[-1] = host[-1][:tail_rows * per_sample]
        return np.concatenate(host, axis=0)

    # ---- manual-loop API (model.cc:2415-2469; flexflow_tpu/model.py:
    # 1398-1520) -----------------------------------------------------------
    def init_operators(self) -> None:
        """Kept for the reference's API: ops hold no state to create."""

    def init_layers(self) -> None:
        """The reference's name for :meth:`init_operators` (no-op)."""

    def _staged_batch(self, what: str):
        self._require_compiled()
        self._ensure_staged_batch()
        batch = self._staged.get("batch")
        if batch is None:
            raise RuntimeError(f"{what}: bind a batch first via "
                               "next_batch/set_batch/set_tensor")
        return batch

    def forward(self, seq_length: Optional[int] = None) -> None:
        """The inference forward of the bound batch (``predict``'s); its
        output is kept as the staged logits."""
        xs, _ = self._staged_batch("forward()")
        self._staged["logits"] = self.executor.make_forward()(self.params,
                                                              xs)

    def zero_gradients(self) -> None:
        self._staged.pop("grads", None)

    def backward(self, seq_length: Optional[int] = None) -> None:
        """Loss and grads of the bound batch: the train step's forward
        (dropout from the next step generator, the ``--remat`` plan) and
        ``autograd`` over the fp32 masters. Refuses to train against the
        zero label placeholder that forward-only staging binds."""
        xs, y = self._staged_batch("backward()")
        if self._staged.get("label_placeholder"):
            raise RuntimeError(
                "backward() needs a real label batch: stage one via "
                "label_tensor.set_tensor(...) or set_batch(x, y) — refusing "
                "to train against the zero placeholder")
        loss, _logits, grads = self.executor.loss_and_grads(
            self.params, xs, y, self._next_rng())
        self._staged["loss"], self._staged["grads"] = loss, grads

    def update(self) -> None:
        """The optimizer's in-place update with the last backward's
        grads."""
        grads = self._staged.get("grads")
        if grads is None:
            raise RuntimeError("update(): call backward() first")
        self.params, self.opt_state = self.optimizer.update(
            self.params, grads, self.opt_state)

    def set_batch(self, x, y) -> None:
        """Bind inputs ``x`` and labels ``y`` on the device for the manual
        loop."""
        from .data.dataloader import to_device

        batch = self.executor.local_batch(self._as_input_list(x) +
                                          [self._prep_label(y)])
        xs = to_device(batch[:-1], self.device)
        (lab,) = to_device(batch[-1:], self.device)
        self._staged["batch"] = (xs, lab)
        self._staged["label_placeholder"] = False

    def _stage_tensor_value(self, tensor, np_array) -> None:
        """``Tensor.set_tensor`` host staging (reference:
        ParallelTensorBase::set_tensor, parallel_tensor.cc:698): the next
        forward / backward binds the staged input and label values as one
        batch."""
        per = self._staged.setdefault("per_tensor", {})
        per[tensor.guid] = np.asarray(np_array)
        self._staged["per_tensor_dirty"] = True

    def _label_placeholder(self) -> np.ndarray:
        import torch

        return torch.zeros(self.label_tensor.dims, dtype=dtype_to_torch(
            self.label_tensor.dtype)).numpy()

    def _ensure_staged_batch(self) -> None:
        if not self._staged.get("per_tensor_dirty"):
            return
        per = self._staged.get("per_tensor", {})
        if not all(t.guid in per for t in self._input_tensors):
            return
        xs = [per[t.guid] for t in self._input_tensors]
        placeholder = False
        if self.label_tensor is not None and self.label_tensor.guid in per:
            y = per[self.label_tensor.guid]
        elif self.label_tensor is not None:
            # forward-only staging: a zero placeholder keeps forward()
            # usable, and backward() refuses it
            y = self._label_placeholder()
            placeholder = True
        else:
            return
        self.set_batch(xs, y)
        self._staged["label_placeholder"] = placeholder
        self._staged["per_tensor_dirty"] = False

    def _activation_value(self, tensor) -> np.ndarray:
        """``get_tensor`` of an activation: the inference forward of the
        bound batch, that layer's output (float32 for 16-bit values)."""
        import torch

        from .ops.base import OpContext

        xs, _ = self._staged_batch(f"reading activation {tensor.name}")
        guid = self._tensor_to_node[tensor.guid]
        ex = self.executor
        with torch.inference_mode():
            params, xs = ex._cast_for_compute(self.params, list(xs),
                                              cache=True)
            vals = ex.forward_outputs(params, ex._bind_inputs(xs),
                                      OpContext(training=False,
                                                device=self.device))
        out = ex._replicate_output(guid, tensor.owner_idx,
                                   vals[guid][tensor.owner_idx])
        return (out.float() if out.is_floating_point() else out).cpu() \
            .numpy()

    def _staged_tensor_value(self, tensor) -> np.ndarray:
        per = self._staged.get("per_tensor", {})
        if tensor.guid in per:
            return np.asarray(per[tensor.guid])
        if self.label_tensor is not None and tensor is self.label_tensor:
            return self._label_placeholder()
        raise KeyError(f"{tensor.name}: no value staged; call set_tensor")

    def create_data_loader(self, batch_tensor: Tensor, full_array):
        """A loader of ``batch_tensor``-sized batches of ``full_array``
        (reference: flexflow_cffi.py:2447)."""
        from .data.dataloader import SingleDataLoader

        return SingleDataLoader(self, batch_tensor, full_array)

    def get_perf_metrics(self) -> PerfMetrics:
        return self._perf

    def reset_metrics(self) -> None:
        """reference: flexflow_cffi.py:1968."""
        self._perf = PerfMetrics()

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

    def get_layer_by_id(self, layer_id: int) -> Layer:
        return self._layers[layer_id]

    def get_layer_by_name(self, name: str) -> Optional[Layer]:
        return next((layer for layer in self._layers if layer.name == name),
                    None)

    def get_tensor_by_id(self, id: int) -> Tensor:
        """Weight tensors in declaration order (reference:
        flexflow_cffi.py:2179, the parameter id over the whole model)."""
        return [w for layer in self._layers for w in layer.weights][id]

    # ---- the search's simulator -------------------------------------------
    def profile_operators(self, max_ops: int = 8) -> None:
        """Per-op timing printout behind ``--profiling``
        (flexflow_tpu/model.py:1526-1564; reference: FFConfig::profiling,
        model.cc:110,155): the ``max_ops`` heaviest distinct op shapes (by
        the analytic cost) are timed standalone by
        ``Simulator.measure_operator_cost`` on this model's device, in the
        step's compute dtype, and printed once, each beside the analytic
        forward time. The rows stay on ``self.per_op_profile``: (name, op
        type, measured s, analytic s). ``max_ops=0`` times nothing: a
        caller that wants ``--profiling``'s step walls alone calls it so
        before ``fit``."""
        if getattr(self, "_per_op_profiled", False) or self.pcg is None:
            return
        self._per_op_profiled = True
        self.per_op_profile = []
        if max_ops <= 0:
            return
        from .search.calibration import dtype_label
        from .search.machine_model import GPUMachineModel
        from .search.simulator import OpSharding, Simulator

        sim = Simulator(GPUMachineModel.detect(1, device=self.device),
                        dtype_label=dtype_label(self.config))
        distinct = {}
        for node in self.pcg.compute_nodes():
            in_shapes = [self.pcg.nodes[g].out_shapes[i]
                         for g, i in node.inputs]
            key = sim._op_key(node, in_shapes)
            if key not in distinct:
                est = sim.op_cost(node, in_shapes, OpSharding()).forward_time
                distinct[key] = (est, node, in_shapes)
        heaviest = sorted(distinct.values(), key=lambda x: -x[0])[:max_ops]
        tracer = self._obs_tracer()
        cdtype = self.executor._compute_dtype()
        print("PER-OP PROFILE (fwd, measured standalone, "
              f"top {len(heaviest)} by estimated cost):")
        for est, node, in_shapes in heaviest:
            in_dtypes = [self.pcg.nodes[g].out_dtypes[i]
                         for g, i in node.inputs]
            try:
                t = sim.measure_operator_cost(
                    node, in_shapes, compute_dtype=cdtype,
                    in_dtypes=in_dtypes, device=self.device)
            except Exception:
                continue  # not measurable standalone, as in the JAX loop
            self.per_op_profile.append(
                (node.name, node.op.op_type.name, t, est))
            if tracer.enabled:
                tracer.event("per_op_profile", op=node.name,
                             op_type=node.op.op_type.name,
                             forward_us=round(t * 1e6, 1))
            print(f"  {node.name:24s} {node.op.op_type.name:28s} "
                  f"{t * 1e6:10.1f} us")

    # ---- recompilation (reference: RecompileState, model.cc:2422) ---------
    def _score_caches(self, cache, fresh, step_count: int) -> None:
        """Host-side cache scoring (reference: cache.cc score tasks;
        flexflow_tpu/model.py:1566-1577): every ``num_batches`` steps each
        CacheOp's ``score_fn(cached, fresh)`` runs on host copies, the two
        tensors brought over in one copy; other steps copy nothing."""
        import torch

        for node in self.executor.cache_nodes:
            nb = max(int(node.op.attrs.get("num_batches", 1) or 1), 1)
            score_fn = node.op.attrs.get("score_fn")
            if (step_count + 1) % nb or score_fn is None:
                continue
            old = cache[node.name]
            both = torch.stack([old, fresh[node.name].to(old.dtype)]).cpu()
            if both.dtype == torch.bfloat16:  # numpy has no bf16
                both = both.float()
            self.cache_scores[node.name] = float(score_fn(
                both[0].numpy(), both[1].numpy()))

    def recompile_on_condition(self, recompile_state) -> bool:
        """Run the trigger; when it fires, ``alter`` the model and compile
        it anew (``execution.recompile.recompile``)."""
        if recompile_state.trigger():
            recompile_state.alter(self)
            from .execution.recompile import recompile

            recompile(self)
            return True
        return False

    def __repr__(self) -> str:
        return (f"FFModel(layers={len(self._layers)}, "
                f"inputs={len(self._input_tensors)}, device={self.device}, "
                f"compiled={self.executor is not None})")


def train_flops_per_step(ff: FFModel) -> int:
    """Model FLOPs of one training step of a compiled model: three times
    the forward FLOPs (forward, input grads, weight grads) of every op
    that counts its own — convolutions, dense layers, batched matmuls,
    attention with its projections, LSTMs, experts — each op's
    ``flops()`` at its compiled shapes. Norms, pooling, activations and
    the loss are left out, as the matmul count of
    ``bert_train_flops_per_step`` leaves them out. It reads only the
    graph, so it serves every model family."""
    from .ops.base import op_flops

    pcg = ff.pcg
    total = 0
    for node in pcg.compute_nodes():
        ins = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
        total += op_flops(node.op, ins, node.out_shapes, elementwise=False)
    return 3 * total


def _search_digest(pcg, strategy) -> str:
    """sha256 of a searched plan: the strategy's JSON and the rewritten
    PCG's nodes in order (name, op type, inputs by producer name, output
    shapes). The names the rewrites make embed node guids, which each
    process counts from its start, so ranks agree when they built the same
    graphs in the same order (as one script on every rank does)."""
    import hashlib
    import json

    names = {n.guid: n.name for n in pcg.topo_order()}
    nodes = [[n.name, n.op.op_type.name,
              [[names[g], i] for g, i in n.inputs],
              [list(x) for x in n.out_shapes]] for n in pcg.topo_order()]
    text = strategy.to_json(pcg) + json.dumps(nodes)
    return hashlib.sha256(text.encode()).hexdigest()[:16]
