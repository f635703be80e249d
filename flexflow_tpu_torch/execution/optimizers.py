"""Optimizers: SGD (momentum, nesterov, weight decay) and Adam (port of
``flexflow_tpu.execution.optimizers``; reference: src/runtime/optimizer.cc).

``update(params, grads, state)`` keeps the JAX package's signature and
formulas, but updates the fp32 master tensors and the state tensors IN
PLACE under ``torch.no_grad()`` and returns the same objects: where the JAX
step donates its param and state buffers to XLA and gets new ones back,
this saves a second copy of the model and its moments. Each formula runs as
``torch._foreach_*`` passes over all tensors at once (a few launches a step
instead of several per tensor), term for term in the JAX order. The step
counter ``state["step"]`` is a 0-d int32 tensor on the params' device,
incremented in place, and Adam's bias correction ``alpha_t`` is computed
from it on the device in fp32: a captured step (``execution/graphs.py``)
reads the new count on every replay, and eager and captured steps run the
same code.

Adam is the reference's, not ``torch.optim.Adam``:
``alpha_t = alpha * sqrt(1 - beta2^t) / (1 - beta1^t)`` and
``p -= alpha_t * m / (sqrt(v) + eps)`` — eps is added to sqrt(v) and not
bias-corrected, where torch's Adam divides by ``sqrt(v_hat) + eps``.
"""
from __future__ import annotations


def _leaves(params):
    return [(n, w) for n, ws in params.items() for w in ws]


def _flat(tree, names):
    return [tree[n][w] for n, w in names]


def _with_decay(gs, ps, wd: float):
    """g + wd * p (a fresh list; the caller's grads stay untouched)."""
    import torch

    if not wd:
        return gs
    return torch._foreach_add(gs, torch._foreach_mul(ps, wd))


def _step_counter(params):
    """A zero 0-d int32 step count on the params' device."""
    import torch

    device = next((t.device for ws in params.values() for t in ws.values()),
                  torch.device("cpu"))
    return torch.zeros((), dtype=torch.int32, device=device)


def _zeros_like(params, dtype=None):
    import torch

    return {n: {w: torch.zeros_like(t, dtype=dtype) for w, t in ws.items()}
            for n, ws in params.items()}


class Optimizer:
    def init_state(self, params):
        raise NotImplementedError

    def update(self, params, grads, state):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    """reference: optimizer.h:36-60 (lr, momentum, nesterov,
    weight_decay)."""

    def __init__(self, ffmodel=None, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def init_state(self, params):
        if self.momentum == 0.0:
            return {"step": _step_counter(params)}
        return {"step": _step_counter(params),
                "velocity": _zeros_like(params)}

    def update(self, params, grads, state):
        """p -= lr * (g + wd * p), or with momentum v = mom * v + g and
        p -= lr * (g + mom * v if nesterov else v); in place."""
        import torch

        lr, mom = self.lr, self.momentum
        names = _leaves(params)
        with torch.no_grad():
            ps = _flat(params, names)
            gs = _with_decay(_flat(grads, names), ps, self.weight_decay)
            if mom == 0.0:
                torch._foreach_sub_(ps, torch._foreach_mul(gs, lr))
            else:
                vs = _flat(state["velocity"], names)
                torch._foreach_mul_(vs, mom)
                torch._foreach_add_(vs, gs)
                step = (torch._foreach_add(gs, torch._foreach_mul(vs, mom))
                        if self.nesterov else vs)
                torch._foreach_sub_(ps, torch._foreach_mul(step, lr))
            state["step"].add_(1)
        return params, state


class AdamOptimizer(Optimizer):
    """reference: optimizer.h:77-96 (alpha, beta1, beta2, weight_decay,
    epsilon; bias-corrected alpha_t).

    ``moment_dtype`` (a torch dtype, e.g. ``torch.bfloat16``) stores m and
    v in a reduced dtype; the update math stays fp32 (moments upcast, the
    fresh values rounded once when stored). None keeps the reference's
    numerics."""

    def __init__(self, ffmodel=None, alpha: float = 0.001,
                 beta1: float = 0.9, beta2: float = 0.999,
                 weight_decay: float = 0.0, epsilon: float = 1e-8,
                 moment_dtype=None):
        self.alpha = alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.weight_decay = weight_decay
        self.epsilon = epsilon
        self.moment_dtype = moment_dtype

    def init_state(self, params):
        dt = self.moment_dtype
        return {"step": _step_counter(params), "m": _zeros_like(params, dt),
                "v": _zeros_like(params, dt)}

    def alpha_t(self, step):
        """alpha * sqrt(1 - b2^t) / (1 - b1^t) in fp32, as the jitted JAX
        step computes it, for the step count tensor ``step``: a 0-d fp32
        tensor on its device."""
        import torch

        t = step.to(torch.float32)
        b1t = torch.pow(self.beta1, t)
        b2t = torch.pow(self.beta2, t)
        return self.alpha * torch.sqrt(1.0 - b2t) / (1.0 - b1t)

    def update(self, params, grads, state):
        import torch

        b1, b2 = self.beta1, self.beta2
        reduced = self.moment_dtype is not None
        names = _leaves(params)
        with torch.no_grad():
            state["step"].add_(1)
            alpha_t = self.alpha_t(state["step"])
            ps = _flat(params, names)
            gs = _with_decay(_flat(grads, names), ps, self.weight_decay)
            ms, vs = _flat(state["m"], names), _flat(state["v"], names)
            mf = [m.float() for m in ms] if reduced else ms
            vf = [v.float() for v in vs] if reduced else vs
            torch._foreach_mul_(mf, b1)
            torch._foreach_add_(mf, torch._foreach_mul(gs, 1 - b1))
            torch._foreach_mul_(vf, b2)
            torch._foreach_add_(vf, torch._foreach_mul(
                torch._foreach_mul(gs, gs), 1 - b2))
            denom = torch._foreach_add(torch._foreach_sqrt(vf), self.epsilon)
            torch._foreach_sub_(ps, torch._foreach_div(
                torch._foreach_mul(mf, alpha_t), denom))
            if reduced:
                torch._foreach_copy_(ms, mf)
                torch._foreach_copy_(vs, vf)
        return params, state
