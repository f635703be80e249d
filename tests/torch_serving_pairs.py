"""Shared fixtures of the port's serving parity tests
(tests/test_torch_serving_resilience.py, test_torch_serving_chaos.py, the
fleet, tenancy, journal and failover files):
the tiny GPT-2 of ``tests/test_serving_resilience.py`` (hidden 64, 4
heads, 2 layers, seq 16, vocab 100) built in both packages with the JAX
weights carried over by ``set_params_numpy``, each package's serving names
in one namespace, and the scripted clock. A test writes its scenario once,
as a function of such a namespace, runs it through both packages and
compares what they give.
"""
import types

import numpy as np
import pytest
import torch

import jax

import flexflow_tpu as fj
import flexflow_tpu.resilience as jres
import flexflow_tpu.serving as jsv
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.resilience as tres
import flexflow_tpu_torch.serving as tsv
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2

torch.set_num_threads(2)

PKG_NAMES = ("ServingEngine", "ContinuousBatchScheduler", "Request",
             "OverloadError", "QueueFullError", "ServingRejection",
             "AdmissionController", "ServingFleet", "OUTCOMES",
             "FLEET_MIN_RETRY_AFTER_MS", "QuotaExceededError",
             "TenantRegistry", "WeightedFairQueue", "RequestJournal",
             "NOOP_JOURNAL", "NoopJournal", "FleetCrashed",
             "JournalCorruptError", "journal_from_config", "plan_replicas",
             "parse_tenant_tiers")


def _namespace(name, ff, serving, resilience):
    ns = types.SimpleNamespace(name=name, ff=ff,
                               ChaosPlan=resilience.ChaosPlan,
                               FleetChaosPlan=resilience.FleetChaosPlan,
                               fleet=serving.fleet,
                               scheduler=serving.scheduler)
    for n in PKG_NAMES:
        setattr(ns, n, getattr(serving, n))
    return ns


@pytest.fixture(scope="module")
def pkgs():
    """{"jax": ..., "torch": ...}: each package's tiny GPT-2 (the same
    weights) and serving names."""
    jc = fj.FFConfig()
    jc.batch_size = 8
    jff = fj.FFModel(jc)
    jax_build_gpt2(jff, JaxGPT2Config.tiny(batch_size=8))
    jff.compile(optimizer=fj.SGDOptimizer(jff),
                loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    tc = ft.FFConfig()
    tc.batch_size = 8
    tff = ft.FFModel(tc, device="cpu")
    build_gpt2(tff, GPT2Config.tiny(batch_size=8))
    tff.compile()
    tff.set_params_numpy(jax.device_get(jff.params))
    return {"jax": _namespace("jax", jff, jsv, jres),
            "torch": _namespace("torch", tff, tsv, tres)}


def both(pkgs, scenario):
    """``scenario(ns)`` run through each package: (jax's, torch's)."""
    return scenario(pkgs["jax"]), scenario(pkgs["torch"])


def set_config(pkgs, **fields):
    """Set config fields on both models; returns the old values."""
    old = {k: getattr(pkgs["jax"].ff.config, k) for k in fields}
    for p in pkgs.values():
        for k, v in fields.items():
            setattr(p.ff.config, k, v)
    return old


def prompts(n, seed=0, lo=3, hi=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def engine(p, **kw):
    """The JAX file's engine: 2 slots, max_decode_len the model's seq."""
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_decode_len", 16)
    return p.ServingEngine(p.ff, **kw)


class ScriptedClock:
    """Deterministic ms clock: advances a fixed amount per call, so every
    deadline and drain decision is a function of the call sequence (both
    engines must read it at the same points to decide alike)."""

    def __init__(self, step_ms=5.0):
        self.t = 0.0
        self.step_ms = step_ms

    def __call__(self):
        self.t += self.step_ms
        return self.t


def ledger(stats):
    """The counters both packages' ServingStats carry, as a dict."""
    return {k: getattr(stats, k) for k in (
        "outcomes", "sheds", "deadline_misses", "quarantines",
        "decode_retries", "drains", "replans", "drained_returned",
        "requests_served", "tokens_generated", "prefills")}
