"""Shared pieces of the frontend tests (tests/test_torch_frontend_*.py): the
plain torch modules that both packages trace, and the trace-compile-copy
sequence each package runs on them. Imports neither jax nor
``flexflow_tpu``: the package under test is passed in, so the card test
(tests/test_torch_frontend_cuda.py) uses it without the JAX package.

The modules are the JAX package's own frontend cases
(tests/test_frontends.py, tests/test_frontends_full.py), an attention
block over ``F.scaled_dot_product_attention`` with each mask form, and a
post-LN encoder shaped like the BERT-Large proxy
(flexflow_tpu_torch/models/bert.py) at a narrow width: q/k/v/o linears,
``view``/``transpose`` into heads, SDPA without mask or scale, residual,
LayerNorm, a GELU MLP, residual, LayerNorm; then a mean over the
sequence, a 2-way linear head and a softmax.
"""
import importlib

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class TorchMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(16, 32)
        self.act = nn.ReLU()
        self.ln = nn.LayerNorm(32)
        self.fc2 = nn.Linear(32, 4)

    def forward(self, x):
        h = self.act(self.fc1(x))
        h = self.ln(h)
        return self.fc2(h) + 1.0


class TorchConvNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.bnless_pool = nn.MaxPool2d(2)
        self.flat = nn.Flatten()
        self.fc = nn.Linear(8 * 4 * 4, 5)

    def forward(self, x):
        h = torch.relu(self.conv(x))
        h = self.bnless_pool(h)
        return self.fc(self.flat(h))


class TorchT5Block(nn.Module):
    """T5LayerNorm-style normalization + split/sum/unsqueeze."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(16, 32)

    def forward(self, x):
        h = self.fc(x)
        var = h.pow(2).mean(-1, keepdim=True)
        h = h * torch.rsqrt(var + 1e-6)
        a, b = h.chunk(2, dim=-1)
        s = torch.sum(a * b, 1, keepdim=True)
        return (h + s).squeeze(0).unsqueeze(0)


class TorchRaggedSplit(nn.Module):
    """Non-divisible split/chunk + kwarg dims (torch remainder semantics)."""

    def forward(self, x):  # x: (b, 10)
        a, b, c, d = x.split(3, dim=1)
        e, f, g = torch.chunk(x, 3, dim=1)
        s = (a.sum(dim=1, keepdim=True) + d + g.sum(1, keepdim=True))
        return s.squeeze(dim=1).unsqueeze(dim=1) + e.mean(dim=1,
                                                          keepdim=True)


class TorchAdaptivePool(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 6, 3, padding=1)
        self.pool = nn.AdaptiveAvgPool2d((1, 1))
        self.flat = nn.Flatten()
        self.fc = nn.Linear(6, 4)

    def forward(self, x):
        return self.fc(self.flat(self.pool(torch.relu(self.conv(x)))))


class TorchSDPA(nn.Module):
    """q/k/v projections, heads by view/transpose, SDPA with ``mode``'s
    mask: "none", "causal", "bool" (a buffer, True = attend) or "additive"
    (a float buffer added to the scores)."""

    def __init__(self, mode: str, seq: int = 8, d: int = 32, heads: int = 4):
        super().__init__()
        self.mode, self.heads, self.dh, self.d = mode, heads, d // heads, d
        self.q, self.k, self.v = (nn.Linear(d, d) for _ in range(3))
        g = torch.Generator().manual_seed(7)
        if mode == "bool":
            m = torch.rand(1, 1, seq, seq, generator=g) > 0.3
            m[..., 0] = True  # every query attends at least one key
            self.register_buffer("mask", m)
        elif mode == "additive":
            self.register_buffer("mask",
                                 torch.randn(1, 1, seq, seq, generator=g))

    def forward(self, x):
        b, n, _ = x.shape
        q = self.q(x).view(b, n, self.heads, self.dh).transpose(1, 2)
        k = self.k(x).view(b, n, self.heads, self.dh).transpose(1, 2)
        v = self.v(x).view(b, n, self.heads, self.dh).transpose(1, 2)
        if self.mode in ("bool", "additive"):
            a = F.scaled_dot_product_attention(q, k, v, attn_mask=self.mask)
        else:
            a = F.scaled_dot_product_attention(
                q, k, v, is_causal=self.mode == "causal")
        return a.transpose(1, 2).reshape(b, n, self.d)


class EncoderLayer(nn.Module):
    def __init__(self, d: int, heads: int, inter: int):
        super().__init__()
        self.heads, self.dh, self.d = heads, d // heads, d
        self.q, self.k, self.v, self.o = (nn.Linear(d, d) for _ in range(4))
        self.ln1 = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, inter)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(inter, d)
        self.ln2 = nn.LayerNorm(d)

    def forward(self, x):
        b, n, _ = x.shape
        q = self.q(x).view(b, n, self.heads, self.dh).transpose(1, 2)
        k = self.k(x).view(b, n, self.heads, self.dh).transpose(1, 2)
        v = self.v(x).view(b, n, self.heads, self.dh).transpose(1, 2)
        a = F.scaled_dot_product_attention(q, k, v)
        a = self.o(a.transpose(1, 2).reshape(b, n, self.d))
        x = self.ln1(a + x)
        return self.ln2(self.fc2(self.act(self.fc1(x))) + x)


class Encoder(nn.Module):
    """The BERT-Large proxy's architecture as a plain module (its full
    width is d 1024, 16 heads, 24 layers, intermediate 4096)."""

    def __init__(self, d: int = 64, heads: int = 4, layers: int = 2,
                 inter: int = 0, classes: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d, heads, inter or 4 * d) for _ in range(layers))
        self.cls = nn.Linear(d, classes)
        self.sm = nn.Softmax(dim=-1)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return self.sm(self.cls(x.mean(dim=1)))


def fx(pkg):
    """``pkg.frontends.torch_fx`` of the package under test."""
    return importlib.import_module(pkg.__name__ + ".frontends.torch_fx")


def traced(pkg, module, in_shapes, batch: int, loss=None, optimizer=None,
           compute_bf16: bool = False, device="cpu", metrics=None,
           seed: int = 3):
    """``module`` traced through ``PyTorchModel`` into a fresh FFModel of
    ``pkg`` (the JAX package takes no ``device``), compiled and given the
    module's weights by ``copy_torch_weights``."""
    config = pkg.FFConfig()
    config.batch_size, config.seed = batch, seed
    if compute_bf16:
        config.compute_dtype = pkg.DataType.DT_BFLOAT16
    ff = pkg.FFModel(config) if device is None else \
        pkg.FFModel(config, device=device)
    ins = [ff.create_tensor((batch,) + tuple(s)) for s in in_shapes]
    fx(pkg).PyTorchModel(module).torch_to_ff(ff, ins)
    ff.compile(optimizer=optimizer,
               loss_type=loss or
               pkg.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
               metrics=metrics or [])
    fx(pkg).copy_torch_weights(ff)
    return ff


def seeded(cls, *args, seed: int = 0, **kw):
    torch.manual_seed(seed)
    return cls(*args, **kw).eval()


def inputs(shape, seed: int = 0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
