"""Keras-frontend initializers (a port of
``flexflow_tpu.frontends.keras_initializers``; reference:
python/flexflow/keras/initializers.py — thin wrappers binding keras names to
the core initializer objects). The reference's RandomNormal mistakenly binds
UniformInitializer (initializers.py:49-54); here it is a real normal."""
from __future__ import annotations

from ..execution.initializers import (ConstantInitializer,
                                      GlorotUniformInitializer,
                                      NormInitializer, UniformInitializer,
                                      ZeroInitializer)


class Initializer:
    """reference: initializers.py Initializer — carries the core handle."""

    def __init__(self):
        self._ffhandle = None

    @property
    def ffhandle(self):
        return self._ffhandle


class DefaultInitializer(Initializer):
    pass


class Zeros(Initializer):
    def __init__(self):
        super().__init__()
        self._ffhandle = ZeroInitializer()


class GlorotUniform(Initializer):
    def __init__(self, seed=0):
        super().__init__()
        self.seed = seed
        self._ffhandle = GlorotUniformInitializer(seed or 0)


class RandomUniform(Initializer):
    def __init__(self, minval=-0.05, maxval=0.05, seed=None):
        super().__init__()
        self._ffhandle = UniformInitializer(seed or 0, minval, maxval)


class RandomNormal(Initializer):
    def __init__(self, mean=0.0, stddev=0.05, seed=None):
        super().__init__()
        self._ffhandle = NormInitializer(seed or 0, mean, stddev)


class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__()
        self._ffhandle = ConstantInitializer(value)


def resolve(init):
    """keras object / core initializer / None -> core initializer or None."""
    if init is None:
        return None
    if isinstance(init, Initializer):
        return init.ffhandle
    return init  # already a core initializer
