"""Ticket counters of the kernels that split a row across CTAs and merge
the parts in the launch's last CTA (flash decode, top-k).

A kernel's counters live on each device it ran on. They are made zeroed
outside any CUDA-graph capture, and every launch leaves them zero (the CTA
that takes the last ticket resets its counter), so launches that share
them must run on one stream. Every buffer ever handed to a launch is kept
alive: a captured graph holds its pointer.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

_buffers: Dict[Tuple[str, int], List] = {}


def ticket_buffer(kernel: str, device, n: int):
    """``kernel``'s int32 ticket counters on ``device``, at least ``n``."""
    import torch

    bufs = _buffers.setdefault((kernel, device.index), [])
    if bufs and bufs[-1].numel() >= n:
        return bufs[-1]
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{kernel}: its ticket counters are created on the first eager "
            "call; launch it once outside CUDA-graph capture first")
    bufs.append(torch.zeros(max(n, 2 * bufs[-1].numel() if bufs else n),
                            dtype=torch.int32, device=device))
    return bufs[-1]
