"""Weight initializers (port of ``flexflow_tpu.execution.initializers``;
reference: src/runtime/initializer.cc).

Each initializer is ``__call__(generator, shape, dtype) -> torch.Tensor``,
drawing from an explicit CPU ``torch.Generator`` so a seed gives the same
weights on every device. The streams differ from ``jax.random``'s: the two
packages agree on weights by carrying them over
(``utils/weights.params_from_numpy``), never by reseeding.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class Initializer:
    seed: int = 0

    def __call__(self, generator, shape: Sequence[int], dtype):
        raise NotImplementedError

    def _seeded(self, generator):
        """An initializer with its own seed draws from a generator derived
        from the executor's stream and that seed, so two initializers with
        different seeds give different weights (reference: each
        initializer task is seeded with its own seed)."""
        if not self.seed:
            return generator
        import torch

        base = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        return torch.Generator().manual_seed(base ^ int(self.seed))


class GlorotUniformInitializer(Initializer):
    """Xavier/Glorot uniform (reference: initializer.cc GlorotUniform)."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    @staticmethod
    def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
        if len(shape) < 1:
            return 1, 1
        if len(shape) == 1:
            return shape[0], shape[0]
        if len(shape) == 2:
            return shape[0], shape[1]
        receptive = int(np.prod(shape[:-2]))
        return shape[-2] * receptive, shape[-1] * receptive

    def __call__(self, generator, shape, dtype):
        import torch

        fan_in, fan_out = self._fans(tuple(shape))
        limit = float(np.sqrt(6.0 / max(fan_in + fan_out, 1)))
        u = torch.rand(tuple(shape), generator=self._seeded(generator))
        return (u * (2 * limit) - limit).to(dtype)


class ZeroInitializer(Initializer):
    def __call__(self, generator, shape, dtype):
        import torch

        return torch.zeros(tuple(shape), dtype=dtype)


class ConstantInitializer(Initializer):
    def __init__(self, value: float):
        self.value = value

    def __call__(self, generator, shape, dtype):
        import torch

        return torch.full(tuple(shape), self.value, dtype=dtype)


class UniformInitializer(Initializer):
    def __init__(self, seed: int = 0, min_val: float = 0.0,
                 max_val: float = 1.0):
        self.seed = seed
        self.min_val = min_val
        self.max_val = max_val

    def __call__(self, generator, shape, dtype):
        import torch

        u = torch.rand(tuple(shape), generator=self._seeded(generator))
        return (self.min_val + (self.max_val - self.min_val) * u).to(dtype)


class NormInitializer(Initializer):
    def __init__(self, seed: int = 0, mean: float = 0.0,
                 stddev: float = 1.0):
        self.seed = seed
        self.mean = mean
        self.stddev = stddev

    def __call__(self, generator, shape, dtype):
        import torch

        n = torch.randn(tuple(shape), generator=self._seeded(generator))
        return (self.mean + self.stddev * n).to(dtype)


DefaultWeightInitializer = GlorotUniformInitializer
DefaultBiasInitializer = ZeroInitializer
