"""Keras-frontend weight regularizers (a port of
``flexflow_tpu.frontends.keras_regularizers``; reference:
python/flexflow/keras/regularizers.py — L1/L2 carrying (RegularizerMode,
lambda)). Unlike the reference, the penalty is actually applied here: layers
record a ("l1"|"l2", lambda) spec on their kernel attrs and the op's forward
adds lambda * ||W||_1 or lambda * sum(W^2) to the training loss through the
aux-loss hook (the same channel as the MoE load-balance term)."""
from __future__ import annotations

from ..ffconst import RegularizerMode


class Regularizer:
    def __init__(self):
        self.type = RegularizerMode.REG_MODE_NONE
        self._lambda = 0.0

    def spec(self):
        if self.type == RegularizerMode.REG_MODE_L1:
            return ("l1", self._lambda)
        if self.type == RegularizerMode.REG_MODE_L2:
            return ("l2", self._lambda)
        return None


class L1(Regularizer):
    def __init__(self, l1: float):
        super().__init__()
        self.type = RegularizerMode.REG_MODE_L1
        self._lambda = float(l1)


class L2(Regularizer):
    def __init__(self, l2: float):
        super().__init__()
        self.type = RegularizerMode.REG_MODE_L2
        self._lambda = float(l2)


def resolve(reg):
    """keras Regularizer / "l1"/"l2" string / spec tuple / None ->
    ("l1"|"l2", lambda) or None."""
    if reg is None:
        return None
    if isinstance(reg, Regularizer):
        return reg.spec()
    if isinstance(reg, str):  # keras string shorthand, default rate 0.01
        if reg not in ("l1", "l2"):
            raise ValueError(f"unknown regularizer {reg!r}")
        return (reg, 0.01)
    kind, lam = reg
    if kind not in ("l1", "l2"):
        raise ValueError(f"unknown regularizer kind {kind!r}")
    return (kind, float(lam))
