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

``update(..., ok=...)`` is the divergence sentinel's guarded update
(``Executor.make_train_step(guard=True)``): ``ok`` is a 0-d bool tensor
on the device, and since a captured step cannot branch on the host, the
skip is data, not control. Every write goes to fresh tensors, which are
committed with ``torch.where(ok, new, old)``, and the step count grows
by ``ok``: on a bad step every param, moment and the count keep their
bits; on a good one the result is bitwise the unguarded update (the same
operations on the same values). Masking by multiplying with ``ok`` would
not do: ``NaN * 0`` is NaN.

The update walks the params in groups of at most ``_GROUP_ELEMS``
elements: its ``_foreach`` temporaries (Adam's are three fp32 copies of
the grads at once) then stay a group's size instead of setting the
step's peak memory above the activations' — the peak ``--remat`` is
there to lower. Every operation is elementwise, so the grouping changes
no bit.

Adam is the reference's, not ``torch.optim.Adam``:
``alpha_t = alpha * sqrt(1 - beta2^t) / (1 - beta1^t)`` and
``p -= alpha_t * m / (sqrt(v) + eps)`` — eps is added to sqrt(v) and not
bias-corrected, where torch's Adam divides by ``sqrt(v_hat) + eps``.
"""
from __future__ import annotations


# elements a group of the update holds (256 MB of fp32; BERT-Large's
# 302 M params walk in 5 groups)
_GROUP_ELEMS = 1 << 26


def _leaves(params):
    return [(n, w) for n, ws in params.items() for w in ws]


def _groups(params):
    """The params' (node, weight) names in order, cut into groups of at
    most ``_GROUP_ELEMS`` elements (a larger tensor makes a group
    alone)."""
    out, cur, size = [], [], 0
    for n, w in _leaves(params):
        k = params[n][w].numel()
        if cur and size + k > _GROUP_ELEMS:
            out.append(cur)
            cur, size = [], 0
        cur.append((n, w))
        size += k
    if cur:
        out.append(cur)
    return out


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


def _first(op: str, xs, arg, ok):
    """``xs op= arg`` as the first write of an update to a state list: in
    place, or, under a guard, into fresh tensors that :func:`_commit`
    writes back."""
    import torch

    if ok is None:
        getattr(torch, f"_foreach_{op}_")(xs, arg)
        return xs
    return getattr(torch, f"_foreach_{op}")(xs, arg)


def _commit(xs, news, ok) -> None:
    """Write an update's values ``news`` into the state list ``xs``: all of
    them (or nothing to do when they were written in place), or, under a
    guard, each element where ``ok`` holds."""
    import torch

    if ok is None:
        if news is not xs:
            torch._foreach_copy_(xs, news)
        return
    for x, n in zip(xs, news):
        torch.where(ok, n.to(x.dtype), x, out=x)


def _count(state, ok) -> None:
    """The step count grows by one, or under a guard by ``ok``."""
    import torch

    state["step"].add_(1 if ok is None else ok.to(torch.int32))


class Optimizer:
    def init_state(self, params):
        raise NotImplementedError

    def update(self, params, grads, state, ok=None):
        raise NotImplementedError

    def set_learning_rate(self, lr: float) -> None:
        """reference: optimizer.h set_learning_rate (the keras LR callback,
        the sentinel's reduced-LR rollback). A captured step bakes the rate
        in as a constant, so the caller drops the programs
        (``Executor.invalidate_jit_cache``); ``_lr_changed`` tells a loop
        that watches it."""
        if hasattr(self, "lr"):
            self.lr = float(lr)
        else:
            self.alpha = float(lr)
        self._lr_changed = True


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

    def update(self, params, grads, state, ok=None):
        """p -= lr * (g + wd * p), or with momentum v = mom * v + g and
        p -= lr * (g + mom * v if nesterov else v); in place, or guarded by
        ``ok`` (module doc)."""
        import torch

        lr, mom = self.lr, self.momentum
        with torch.no_grad():
            for names in _groups(params):
                ps = _flat(params, names)
                gs = _with_decay(_flat(grads, names), ps, self.weight_decay)
                if mom == 0.0:
                    pn = _first("sub", ps, torch._foreach_mul(gs, lr), ok)
                else:
                    vs = _flat(state["velocity"], names)
                    vn = _first("mul", vs, mom, ok)
                    torch._foreach_add_(vn, gs)
                    step = (torch._foreach_add(gs,
                                               torch._foreach_mul(vn, mom))
                            if self.nesterov else vn)
                    pn = _first("sub", ps, torch._foreach_mul(step, lr), ok)
                    _commit(vs, vn, ok)
                _commit(ps, pn, ok)
            _count(state, ok)
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

    def update(self, params, grads, state, ok=None):
        """In place, or guarded by ``ok`` (module doc): on a bad step the
        count stays, so ``alpha_t`` does not move either."""
        import torch

        b1, b2 = self.beta1, self.beta2
        reduced = self.moment_dtype is not None
        with torch.no_grad():
            _count(state, ok)
            alpha_t = self.alpha_t(state["step"])
            for names in _groups(params):
                ps = _flat(params, names)
                gs = _with_decay(_flat(grads, names), ps, self.weight_decay)
                ms, vs = _flat(state["m"], names), _flat(state["v"], names)
                mf = [m.float() for m in ms] if reduced else ms
                vf = [v.float() for v in vs] if reduced else vs
                mf = _first("mul", mf, b1, ok)
                torch._foreach_add_(mf, torch._foreach_mul(gs, 1 - b1))
                vf = _first("mul", vf, b2, ok)
                torch._foreach_add_(vf, torch._foreach_mul(
                    torch._foreach_mul(gs, gs), 1 - b2))
                denom = torch._foreach_add(torch._foreach_sqrt(vf),
                                           self.epsilon)
                pn = _first("sub", ps, torch._foreach_div(
                    torch._foreach_mul(mf, alpha_t), denom), ok)
                _commit(ps, pn, ok)
                _commit(ms, mf, ok)
                _commit(vs, vf, ok)
        return params, state
