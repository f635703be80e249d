"""Loss functions (port of ``flexflow_tpu.execution.losses``; reference:
src/loss_functions/loss_functions.cc).

The loss is a scalar function of the final output and the labels; autograd
derives dLoss/dlogits. The math is the JAX package's, term for term:
sparse categorical cross-entropy consumes *probabilities* (the graph ends
in a softmax op, as in the reference), ``log(clip(p, 1e-12, 1))``.
"""
from __future__ import annotations

from ..ffconst import LossType


def _log_probs(p):
    import torch

    return torch.log(torch.clamp(p, 1e-12, 1.0))


def loss_value(loss_type: LossType, logits, labels,
               repl_labels: bool = False):
    import torch

    if repl_labels:
        k = logits.shape[0] // labels.shape[0]
        labels = torch.repeat_interleave(labels, k, dim=0)

    if loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        # token-level targets ((b, s, vocab) probs vs (b, s) labels) flatten
        # to one class axis, as in the (b, vocab) classification case
        labels = labels.reshape(-1)
        logp = _log_probs(logits.reshape(-1, logits.shape[-1]))
        nll = -torch.gather(logp, 1, labels.long()[:, None])
        return nll.mean()
    if loss_type == LossType.LOSS_CATEGORICAL_CROSSENTROPY:
        return -(labels * _log_probs(logits)).sum(dim=-1).mean()
    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE:
        return torch.square(logits - labels).mean()
    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE:
        # sum over features, mean over batch
        return torch.square(logits - labels).sum(
            dim=tuple(range(1, logits.dim()))).mean()
    if loss_type == LossType.LOSS_IDENTITY:
        return logits.mean()
    raise ValueError(f"unknown loss {loss_type}")
