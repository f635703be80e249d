"""Executor: runs a PCG's ops as plain PyTorch on one device.

Port of ``flexflow_tpu.execution.executor`` for this slice: parameter
init, the mixed-precision cast, the graph forward with node overrides, and
the three serving programs — per-bucket prefill, chunk prefill and the
one-token decode step. JAX jits each program once per shape; here each is a
plain Python function run eagerly under ``torch.inference_mode()``, and the
decode step updates the KV pool and cursors in place instead of donating
them. The training step, sharding and remat come in later slices.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from ..ffconst import DataType, OperatorType, dtype_to_torch
from ..ops.base import OpContext
from ..parallel.pcg import PCG, PCGNode


class Executor:
    def __init__(self, pcg: PCG, config, final_guid: int, device,
                 final_out_idx: int = 0):
        self.pcg = pcg
        self.config = config
        self.final_guid = final_guid
        self.final_out_idx = final_out_idx
        self.device = device
        # serving programs by key — ("prefill", bucket, max_len) etc.
        self._serving_fns: Dict[Tuple, Callable] = {}
        # (params dict, its compute-dtype copy): the cast runs once per
        # params object, not once per step
        self._cast_cache: Optional[Tuple[Any, Any]] = None

    # ------------------------------------------------------------------ params
    def _node_input_shapes(self, node: PCGNode) -> List[Tuple[int, ...]]:
        return [self.pcg.nodes[g].out_shapes[i] for g, i in node.inputs]

    def weight_entries(self):
        """[(node, wname, shape, dtype, init)] in topo order."""
        entries = []
        for node in self.pcg.compute_nodes():
            in_shapes = self._node_input_shapes(node)
            for wname, (shape, dtype, init) in node.op.weight_specs(
                    in_shapes).items():
                entries.append((node, wname, shape, dtype, init))
        return entries

    def init_params(self, seed: int = 0) -> Dict[str, Dict[str, Any]]:
        """{node_name: {wname: tensor}} on the executor's device, drawn on
        the CPU from one ``torch.Generator`` seeded with ``seed`` (the same
        weights on every device)."""
        import torch

        gen = torch.Generator().manual_seed(int(seed))
        params: Dict[str, Dict[str, Any]] = {}
        for node, wname, shape, dtype, init in self.weight_entries():
            w = init(gen, shape, dtype_to_torch(dtype))
            params.setdefault(node.name, {})[wname] = w.to(self.device)
        return params

    # --------------------------------------------------------- mixed precision
    def _compute_dtype(self):
        """torch dtype for forward compute, or None for the params' own.
        Master weights stay fp32; layer norm statistics and attention
        scores stay fp32 inside the ops."""
        cd = getattr(self.config, "compute_dtype", None)
        if cd is None or cd == DataType.DT_NONE:
            return None
        return dtype_to_torch(cd)

    def _cast_for_compute(self, params, xs):
        cdtype = self._compute_dtype()
        if cdtype is None:
            return params, xs
        cached = self._cast_cache
        if cached is None or cached[0] is not params:
            cast = {n: {w: (t.to(cdtype) if t.is_floating_point() else t)
                        for w, t in ws.items()}
                    for n, ws in params.items()}
            cached = self._cast_cache = (params, cast)
        xs = [x.to(cdtype) if x.is_floating_point() else x for x in xs]
        return cached[1], xs

    @staticmethod
    def _logits_f32(logits):
        return logits.float() if logits.is_floating_point() else logits

    # ----------------------------------------------------------------- forward
    def forward_outputs(self, params, bound_inputs: Dict[int, Any],
                        ctx: OpContext,
                        overrides: Optional[Dict[int, List[Any]]] = None
                        ) -> Dict[int, List[Any]]:
        """Run the graph; returns {node_guid: [outputs]}. ``overrides``
        substitutes the outputs of specific compute nodes without running
        them — the serving hook that replaces the baked position ids."""
        values: Dict[int, List[Any]] = {}
        for node in self.pcg.topo_order():
            op = node.op
            if op.op_type in (OperatorType.OP_INPUT, OperatorType.OP_WEIGHT):
                values[node.guid] = [bound_inputs[node.guid]]
                continue
            if overrides is not None and node.guid in overrides:
                values[node.guid] = overrides[node.guid]
                continue
            inputs = [values[g][i] for g, i in node.inputs]
            values[node.guid] = op.forward(params.get(node.name, {}), inputs,
                                           ctx)
        return values

    def _bind_inputs(self, xs: List[Any]) -> Dict[int, Any]:
        input_nodes = self.pcg.input_nodes()
        if len(xs) != len(input_nodes):
            raise ValueError(
                f"model has {len(input_nodes)} inputs, got {len(xs)}")
        return {n.guid: x for n, x in zip(input_nodes, xs)}

    def forward(self, params, xs):
        """Whole-sequence inference forward (no KV cache): the final
        output in fp32. The plain reference the serving steps are held
        against. Baked position ids are regenerated as ``arange(seq)`` for
        the width of ``xs[0]`` (the builder baked them for its declared
        batch and sequence; for that shape the two are equal)."""
        import torch

        with torch.inference_mode():
            params, xs = self._cast_for_compute(params, list(xs))
            ctx = OpContext(training=False, device=self.device)
            b, seq = xs[0].shape[:2]
            pos = torch.arange(seq, dtype=torch.int32,
                               device=self.device).expand(b, seq)
            values = self.forward_outputs(
                params, self._bind_inputs(xs), ctx,
                overrides={g: [pos] for g in self._position_const_guids()})
            return self._logits_f32(
                values[self.final_guid][self.final_out_idx])

    # ----------------------------------------------------------------- serving
    def _position_const_guids(self) -> List[int]:
        """Compute nodes holding the baked position-id constant."""
        from ..serving.kvcache import is_position_constant

        return [node.guid for node in self.pcg.compute_nodes()
                if node.op.op_type == OperatorType.OP_CONSTANT
                and is_position_constant(node.op.attrs.get("value"))]

    def make_prefill_step(self, bucket_len: int, max_decode_len: int):
        """``(params, xs, lengths) -> (logits, last_logits, cache)``: run the
        whole right-padded prompt (``bucket_len`` wide) and return each
        causal attention node's prompt k/v rows in ``cache``. ``lengths``
        are the true prompt lengths; ``last_logits`` (batch, vocab) are
        taken at ``lengths - 1``.

        Pad rows' position ids are clamped to the row's last real position:
        a bucket may be wider than the position table, where ``jnp.take``
        would fill and torch indexing raises. Real rows are unchanged (a
        causal row never sees the pad rows after it)."""
        key = ("prefill", int(bucket_len), int(max_decode_len))
        fn = self._serving_fns.get(key)
        if fn is not None:
            return fn
        pos_guids = self._position_const_guids()
        from ..serving.kvcache import ServingState

        def prefill(params, xs, lengths):
            import torch

            with torch.inference_mode():
                params, xs = self._cast_for_compute(params, list(xs))
                lengths = lengths.to(torch.int32)
                sv = ServingState(mode="prefill", max_len=max_decode_len,
                                  positions=torch.zeros_like(lengths),
                                  lengths=lengths)
                ctx = OpContext(training=False, device=self.device,
                                serving=sv)
                b = xs[0].shape[0]
                pos = torch.arange(bucket_len, dtype=torch.int32,
                                   device=self.device).expand(b, bucket_len)
                pos = torch.minimum(pos, (lengths - 1).clamp(min=0)[:, None])
                values = self.forward_outputs(
                    params, self._bind_inputs(xs), ctx,
                    overrides={g: [pos] for g in pos_guids})
                logits = self._logits_f32(
                    values[self.final_guid][self.final_out_idx])
                idx = (lengths.long() - 1).clamp(0, logits.shape[1] - 1)
                last = logits[torch.arange(b, device=logits.device), idx]
                return logits, last, sv.cache_out

        self._serving_fns[key] = prefill
        return prefill

    def make_chunk_prefill_step(self, chunk_len: int, max_decode_len: int,
                                block_size: int):
        """``(params, xs, state, table_row, start, n_new) ->
        (last_logits, state)``: one prefill chunk of ``chunk_len`` token
        slots of a SINGLE request against the paged pool. ``xs`` carries
        the chunk's ids ``(1, chunk_len)`` (rows beyond ``n_new`` are pad),
        ``table_row`` the slot's (mb,) block-table row, ``start`` the
        chunk's first position. The chunk's k/v rows are written into the
        pool in place; lengths and the block tables are untouched (the
        engine arms the slot only when its whole prompt is in)."""
        key = ("chunk", int(chunk_len), int(max_decode_len), int(block_size))
        fn = self._serving_fns.get(key)
        if fn is not None:
            return fn
        pos_guids = self._position_const_guids()
        from ..serving.kvcache import ServingState

        def chunk(params, xs, state, table_row, start, n_new):
            import torch

            with torch.inference_mode():
                params, xs = self._cast_for_compute(params, list(xs))
                start_t = torch.tensor([int(start)], dtype=torch.int32,
                                       device=self.device)
                n_t = torch.tensor([int(n_new)], dtype=torch.int32,
                                   device=self.device)
                sv = ServingState(mode="chunk", max_len=max_decode_len,
                                  positions=start_t, lengths=n_t,
                                  cache_in=state.caches,
                                  block_tables=table_row[None, :],
                                  block_size=int(block_size))
                ctx = OpContext(training=False, device=self.device,
                                serving=sv)
                # pad rows past the last real token would index past the
                # position table when start + chunk_len overhangs the
                # context: clamp them to the last real position
                pos = start_t + torch.arange(chunk_len, dtype=torch.int32,
                                             device=self.device)
                pos = torch.minimum(pos, start_t + n_t - 1)[None, :]
                values = self.forward_outputs(
                    params, self._bind_inputs(xs), ctx,
                    overrides={g: [pos] for g in pos_guids})
                logits = self._logits_f32(
                    values[self.final_guid][self.final_out_idx])
                idx = min(max(int(n_new) - 1, 0), logits.shape[1] - 1)
                return logits[:, idx], state

        self._serving_fns[key] = chunk
        return chunk

    def make_decode_step(self, max_decode_len: int, exact: bool = False,
                         block_size: int = 0):
        """``(params, xs, state) -> (logits, state)``: ONE token per slot
        through the graph, writing each slot's k/v at its ``lengths``
        cursor into the paged pool and advancing the cursors — all in
        place. ``exact=True`` reads attention through the plain gather
        path instead of the flash-decode kernel."""
        key = ("decode", int(max_decode_len), bool(exact), int(block_size))
        fn = self._serving_fns.get(key)
        if fn is not None:
            return fn
        pos_guids = self._position_const_guids()
        from ..serving.kvcache import ServingState

        def decode(params, xs, state):
            import torch

            with torch.inference_mode():
                params, xs = self._cast_for_compute(params, list(xs))
                sv = ServingState(mode="decode", max_len=max_decode_len,
                                  positions=state.lengths,
                                  cache_in=state.caches, exact=exact,
                                  block_tables=state.block_tables,
                                  block_size=int(block_size))
                ctx = OpContext(training=False, device=self.device,
                                serving=sv)
                values = self.forward_outputs(
                    params, self._bind_inputs(xs), ctx,
                    overrides={g: [state.lengths[:, None]]
                               for g in pos_guids})
                logits = self._logits_f32(
                    values[self.final_guid][self.final_out_idx])[:, 0]
                state.caches.update(sv.cache_out)
                state.lengths += 1
                return logits, state

        self._serving_fns[key] = decode
        return decode
