"""Kernel launch counters that a step program's capture can read back.

Each kernel module keeps its launches in a :class:`LaunchCounts`: a dict
of counts whose increments made on a stream being captured are also
recorded for that capture (``execution/graphs.StepProgram``), so the
program learns the launches its graph holds: those its backward makes
from autograd's device thread too, and none of what other threads
(ranks that are threads of one process, a test harness) launch on their
own streams meanwhile.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

# the raw handle of each stream being captured -> its launches so far
_capturing: Dict[int, Dict[Tuple[str, str], int]] = {}


class LaunchCounts(dict):
    """``{kernel: launches}`` of the kernel module ``module``."""

    def __init__(self, module: str, kernels: Iterable[str]):
        super().__init__(dict.fromkeys(kernels, 0))
        self.module = module

    def __setitem__(self, kernel: str, value: int) -> None:
        if _capturing and value > self.get(kernel, 0):
            import torch

            rec = _capturing.get(torch.cuda.current_stream().cuda_stream)
            if rec is not None:
                key = (self.module, kernel)
                rec[key] = rec.get(key, 0) + value - self.get(kernel, 0)
        super().__setitem__(kernel, value)


def start_recording(stream) -> None:
    """Keep the launches made on ``stream`` from now on (its capture
    starts)."""
    _capturing[stream.cuda_stream] = {}


def stop_recording(stream) -> Dict[Tuple[str, str], int]:
    """The launches made on ``stream`` since :func:`start_recording`."""
    return _capturing.pop(stream.cuda_stream, {})
