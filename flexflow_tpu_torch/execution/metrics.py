"""Training metrics (port of ``flexflow_tpu.execution.metrics``; reference:
src/metrics_functions/metrics_functions.cc).

``Metrics.compute`` returns per-batch scalars as device tensors (no host
sync inside the step); ``PerfMetrics`` folds them on the host, once per
epoch in ``fit``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from ..ffconst import LossType, MetricsType

_LOSS_FIELDS = ("cce_loss", "sparse_cce_loss", "mse_loss", "rmse_loss",
                "mae_loss")


@dataclasses.dataclass
class PerfMetrics:
    """Accumulated counters (reference: metrics_functions.h:25-44)."""

    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0

    def update(self, other: Dict[str, float]) -> None:
        self.train_all += int(other.get("train_all", 0))
        self.train_correct += int(other.get("train_correct", 0))
        for f in _LOSS_FIELDS:
            setattr(self, f, getattr(self, f) + float(other.get(f, 0.0)))

    def accuracy(self) -> float:
        return self.train_correct / max(self.train_all, 1)

    def get_accuracy(self) -> float:
        """reference name (flexflow_cffi.py PerfMetrics.get_accuracy —
        returns percent)."""
        return self.accuracy() * 100.0

    def mean(self, field: str) -> float:
        return getattr(self, field) / max(self.train_all, 1)


class Metrics:
    """A loss type and a list of MetricsType computed against the final
    op's output (reference: include/flexflow/metrics_functions.h)."""

    def __init__(self, loss_type: LossType, metrics: List[MetricsType]):
        self.loss_type = loss_type
        self.measures = list(metrics)

    def compute(self, logits, labels) -> Dict[str, object]:
        """Per-batch metrics: {name: scalar tensor} plus the python int
        ``train_all`` (reference: Metrics::compute,
        metrics_functions.cc:68)."""
        import torch

        out: Dict[str, object] = {"train_all": logits.shape[0]}
        sparse = self.loss_type == \
            LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
        feat = tuple(range(1, logits.dim()))

        def logp():
            return torch.log(torch.clamp(logits, 1e-12, 1.0))

        for m in self.measures:
            if m == MetricsType.METRICS_ACCURACY:
                pred = torch.argmax(logits, dim=-1)
                if sparse:
                    ref = labels.reshape(labels.shape[0]).to(pred.dtype)
                else:
                    ref = torch.argmax(labels, dim=-1)
                out["train_correct"] = (pred == ref).sum()
            elif m == MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY:
                li = labels.reshape(labels.shape[0]).long()
                out["sparse_cce_loss"] = -torch.gather(
                    logp(), 1, li[:, None]).sum()
            elif m == MetricsType.METRICS_CATEGORICAL_CROSSENTROPY:
                out["cce_loss"] = -(labels * logp()).sum()
            elif m == MetricsType.METRICS_MEAN_SQUARED_ERROR:
                out["mse_loss"] = torch.square(logits - labels).mean(
                    dim=feat).sum()
            elif m == MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR:
                out["rmse_loss"] = torch.sqrt(torch.square(
                    logits - labels).mean(dim=feat)).sum()
            elif m == MetricsType.METRICS_MEAN_ABSOLUTE_ERROR:
                out["mae_loss"] = (logits - labels).abs().mean(
                    dim=feat).sum()
        return out
