"""Shape and data-movement ops, reductions, top-k and the batched matmul
(port of ``flexflow_tpu.ops.tensor_ops``; reference: src/ops/{reshape,
transpose,reverse,concat,split,gather,reduce,mean,topk,batch_matmul}.cc).
Each is one PyTorch call, as each is one XLA op in the JAX package; only
top-k has a kernel of its own (``kernels/topk.py``, on opt-in)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ffconst import DataType, OperatorType
from .base import Op, OpContext, register_op


@register_op(OperatorType.OP_RESHAPE)
class ReshapeOp(Op):
    """attrs: shape (new shape, batch included; -1 allowed once)."""

    def infer_output_shapes(self, input_shapes):
        target = list(self.attrs["shape"])
        vol = int(np.prod(input_shapes[0]))
        if -1 in target:
            i = target.index(-1)
            rest = int(np.prod([t for t in target if t != -1]))
            target[i] = vol // rest
        if int(np.prod(target)) != vol:
            raise ValueError(f"{self.name}: cannot reshape "
                             f"{tuple(input_shapes[0])} to {tuple(target)}")
        return [tuple(target)]

    def forward(self, params, inputs, ctx: OpContext):
        out_shape = self.infer_output_shapes([tuple(inputs[0].shape)])[0]
        return [inputs[0].reshape(out_shape)]


@register_op(OperatorType.OP_TRANSPOSE)
class TransposeOp(Op):
    """attrs: perm (full permutation, reference: src/ops/transpose.cc)."""

    def infer_output_shapes(self, input_shapes):
        s = input_shapes[0]
        return [tuple(s[p] for p in self.attrs["perm"])]

    def forward(self, params, inputs, ctx: OpContext):
        return [inputs[0].permute(*self.attrs["perm"])]


@register_op(OperatorType.OP_REVERSE)
class ReverseOp(Op):
    """attrs: axis."""

    def infer_output_shapes(self, input_shapes):
        return [input_shapes[0]]

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        return [torch.flip(inputs[0], dims=(self.attrs["axis"],))]


@register_op(OperatorType.OP_CONCAT)
class ConcatOp(Op):
    """attrs: axis; variadic inputs (reference: src/ops/concat.cc)."""

    def infer_output_shapes(self, input_shapes):
        axis = self.attrs["axis"] % len(input_shapes[0])
        out = list(input_shapes[0])
        out[axis] = sum(s[axis] for s in input_shapes)
        return [tuple(out)]

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        return [torch.cat(list(inputs), dim=self.attrs["axis"])]


@register_op(OperatorType.OP_SPLIT)
class SplitOp(Op):
    """attrs: sizes (list), axis (reference: src/ops/split.cc)."""

    def infer_output_shapes(self, input_shapes):
        s = input_shapes[0]
        axis = self.attrs["axis"] % len(s)
        outs = []
        for sz in self.attrs["sizes"]:
            o = list(s)
            o[axis] = sz
            outs.append(tuple(o))
        return outs

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        return list(x.split(list(self.attrs["sizes"]),
                            dim=self.attrs["axis"] % x.dim()))


@register_op(OperatorType.OP_GATHER)
class GatherOp(Op):
    """torch.gather semantics (reference: src/ops/gather.cc:440).

    inputs: (input, index); attrs: dim. output shape == index shape.
    ``jnp.take_along_axis`` never raises on an out-of-range index (it
    clamps or fills); ``torch.gather`` raises on the CPU and trips a
    device-side assert on CUDA. Indices are passed through as given:
    keeping them in range is the caller's part."""

    def infer_output_shapes(self, input_shapes):
        return [input_shapes[1]]

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        x, idx = inputs
        return [torch.gather(x, self.attrs["dim"] % x.dim(), idx.long())]


@register_op(OperatorType.OP_REDUCE_SUM)
class ReduceSumOp(Op):
    """attrs: axes, keepdims (reference: src/ops/reduce.cc)."""

    def _axes(self, ndim):
        return tuple(sorted(a % ndim for a in self.attrs["axes"]))

    def infer_output_shapes(self, input_shapes):
        s = input_shapes[0]
        axes = self._axes(len(s))
        keep = self.attrs.get("keepdims", False)
        out = [(1 if keep else None) if i in axes else d
               for i, d in enumerate(s)]
        return [tuple(d for d in out if d is not None)]

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        return [x.sum(dim=self._axes(x.dim()),
                      keepdim=self.attrs.get("keepdims", False))]


@register_op(OperatorType.OP_REDUCE_MEAN)
class ReduceMeanOp(ReduceSumOp):
    """attrs: axes, keepdims."""

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        return [x.mean(dim=self._axes(x.dim()),
                       keepdim=self.attrs.get("keepdims", False))]


@register_op(OperatorType.OP_MEAN)
class MeanOp(ReduceMeanOp):
    """reference: src/ops/mean.cc."""


@register_op(OperatorType.OP_TOPK)
class TopKOp(Op):
    """attrs: k, sorted, use_pallas. outputs: (values, int32 indices) over
    the last dim (reference: src/ops/topk.cc). ``torch.topk`` by default;
    on opt-in (``use_pallas``) a shape the kernel gate takes
    (``kernels/topk.py``: 1 <= k <= 8, rows a multiple of 128, on CUDA)
    goes through the row top-k kernel, as the JAX op routes to its Pallas
    kernel. Values keep x's dtype; ties go to the lowest index on the
    kernel route, as ``lax.top_k`` sends them. ``torch.topk`` does not
    specify its order among ties, so on that route (the MoE router's,
    which does not opt in) a tie may pick another expert than JAX does;
    the parity tests draw gates without ties."""

    def infer_output_shapes(self, input_shapes):
        s = input_shapes[0]
        out = tuple(s[:-1]) + (self.attrs["k"],)
        return [out, out]

    def output_dtypes(self, input_dtypes, num_outputs):
        return [input_dtypes[0], DataType.DT_INT32]

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        from ..kernels.topk import should_use_topk_kernel, topk

        (x,) = inputs
        k = self.attrs["k"]
        if should_use_topk_kernel(x, k,
                                  opt_in=self.attrs.get("use_pallas", False)):
            values, indices = topk(x, k)
        else:
            values, indices = torch.topk(x, k, dim=-1)
        return [values, indices.to(torch.int32)]


@register_op(OperatorType.OP_BATCHMATMUL)
class BatchMatmulOp(Op):
    """(b, m, k) x (b, k, n) -> (b, m, n) (reference: src/ops/
    batch_matmul.cc, cuBLAS strided-batched). The JAX op computes it
    outside any kernel with ``preferred_element_type=float32`` and casts
    the result to the input's dtype; ``torch.matmul`` accumulates 16-bit
    products in fp32 and rounds the result once, the same thing."""

    def infer_output_shapes(self, input_shapes):
        a, b = input_shapes
        if a[-1] != b[-2]:
            raise ValueError(f"{self.name}: cannot multiply {tuple(a)} by "
                             f"{tuple(b)}")
        return [tuple(a[:-1]) + (b[-1],)]

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        a, b = inputs
        return [torch.matmul(a, b)]

    def flops(self, input_shapes, output_shapes):
        a = input_shapes[0]
        n = output_shapes[0][-1]
        return 2 * int(np.prod(a)) * n


@register_op(OperatorType.OP_SLICE)
class SliceOp(Op):
    """Static tensor slicing / indexing (reference: OP_SLICE, ffconst.h; the
    torch frontend's getitem). attrs: items — a tuple where each element is
    ("slice", start, stop, step) with None encoded as "none", ("index", i),
    or ("newaxis",). Torch slices take no negative step: a slice with one
    reads the flipped dimension with the mirrored positive slice, which
    selects the same elements in the same order."""

    def _indexer(self):
        def dec(v):
            return None if v == "none" else v

        idx = []
        for it in self.attrs["items"]:
            if it[0] == "slice":
                idx.append(slice(dec(it[1]), dec(it[2]), dec(it[3])))
            elif it[0] == "index":
                idx.append(int(it[1]))
            elif it[0] == "newaxis":
                idx.append(None)
            else:
                raise ValueError(f"bad slice item {it}")
        return tuple(idx)

    def infer_output_shapes(self, input_shapes):
        # zero-stride view: shape inference without allocating the input
        ref = np.broadcast_to(np.int8(0), input_shapes[0])
        return [tuple(ref[self._indexer()].shape)]

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        (x,) = inputs
        idx, flip = [], []
        dim = 0
        for it in self._indexer():
            if isinstance(it, slice) and (it.step or 1) < 0:
                picked = range(*it.indices(x.shape[dim]))
                n = x.shape[dim]
                first = n - 1 - picked[0] if len(picked) else 0
                it = slice(first, first + len(picked) * -it.step, -it.step)
                flip.append(dim)
            idx.append(it)
            dim += it is not None
        if flip:
            x = torch.flip(x, dims=flip)
        return [x[tuple(idx)]]


def encode_slice_items(items) -> Tuple:
    """Python (slice | int | None) tuple -> hashable SliceOp attrs encoding."""
    enc = []
    for it in items:
        if isinstance(it, slice):
            n = "none"
            enc.append(("slice",
                        n if it.start is None else int(it.start),
                        n if it.stop is None else int(it.stop),
                        n if it.step is None else int(it.step)))
        elif it is None:
            enc.append(("newaxis",))
        elif isinstance(it, (int, np.integer)):
            enc.append(("index", int(it)))
        else:
            raise NotImplementedError(f"slice item {it!r}")
    return tuple(enc)
