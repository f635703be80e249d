"""Parameter carry between the two packages.

The JAX package's params pytree is ``{node_name: {wname: array}}``
(``flexflow_tpu.execution.executor.Executor.init_params``); this port keeps
the same node names, weight names and layouts, so a pytree fetched with
``jax.device_get`` loads here 1:1 and the two packages run the same
weights. Numpy is the only interchange type: nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


def params_from_numpy(np_params: Dict[str, Dict[str, Any]], device,
                      expected: Optional[Dict[Tuple[str, str],
                                              Tuple[Tuple[int, ...],
                                                    Any]]] = None,
                      place=None) -> Dict[str, Dict[str, Any]]:
    """``{node: {wname: array}}`` -> the same pytree of torch tensors on
    ``device``. With ``expected`` ({(node, wname): (shape, DataType)}, as
    the model declares them) every entry must be present with its shape
    and is cast to its declared dtype; unknown entries raise. ``place(node,
    wname, full)`` (``Executor.shard_param``) turns each full CPU tensor
    into what this rank holds, its shard under a strategy."""
    import torch

    from ..ffconst import dtype_to_torch

    got = {(n, w) for n, ws in np_params.items() for w in ws}
    if expected is not None:
        missing = sorted(set(expected) - got)
        extra = sorted(got - set(expected))
        if missing or extra:
            raise ValueError(f"params do not match the model: missing "
                             f"{missing[:5]}, unexpected {extra[:5]}")
    out: Dict[str, Dict[str, Any]] = {}
    for node, ws in np_params.items():
        for wname, arr in ws.items():
            a = np.asarray(arr)
            dtype = None
            if expected is not None:
                shape, dt = expected[(node, wname)]
                if tuple(a.shape) != tuple(shape):
                    raise ValueError(f"{node}.{wname}: shape {a.shape}, the "
                                     f"model declares {tuple(shape)}")
                dtype = dtype_to_torch(dt)
            t = torch.tensor(a, dtype=dtype)  # a copy, never a view
            out.setdefault(node, {})[wname] = (
                place(node, wname, t) if place is not None
                else t.to(device))
    return out


def params_to_numpy(params: Dict[str, Dict[str, Any]], gather=None
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`params_from_numpy`: host copies (the train
    step updates the params in place, so a view of a CPU tensor would
    change under its holder). ``gather(node, wname, local)``
    (``Executor.gather_param``) makes the full array from a rank's shard;
    every rank must call it, in the same order."""
    def full(node, w, t):
        return gather(node, w, t) if gather is not None else t

    return {node: {w: full(node, w, t).detach().cpu().numpy().copy()
                   for w, t in ws.items()}
            for node, ws in params.items()}
