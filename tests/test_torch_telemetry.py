"""The port's step telemetry, tracer wiring and profiler trace
(``flexflow_tpu_torch/obs``, ``FFModel.compile`` / ``fit`` / ``eval`` /
``generate``) against the JAX package's (``tests/test_observability.py``,
``tests/test_resilience.py``):

* ``StepTelemetry.summary()`` on the same walls, losses and counters is the
  JAX class's, key for key and with the same rounding;
* ``model_flops_per_step`` gives the JAX integer on the BERT-tiny and
  GPT-2-tiny graphs, and the same under ``--fusion``;
* a ``fit`` of the small resilience model with ``--telemetry-file``,
  ``--trace-file``, a checkpoint directory and a NaN batch writes the JAX
  run's JSON: the ``resilience`` block equal, the same keys but for
  ``device_memory`` (XLA's compiled-memory stats; the port records the
  card's peak, and nothing on the CPU), ``model_flops_per_step`` equal,
  the first loss within ``FIRST_LOSS_TOL`` and the rest within
  ``LOSS_BAND``; the Chrome trace holds the JAX run's events, name for
  name and count for count, through ``eval``;
* ``compile`` and ``eval`` write ``--trace-file`` on their own, and
  ``generate`` writes ``--telemetry-file`` (the flags were parsed and then
  ignored before); with every sink off nothing is written and
  ``get_telemetry()`` is None;
* ``--profiler-trace-dir`` writes a Chrome trace whose ranges name the
  graph's nodes (the executor's ``record_function`` scopes);
* ``obs.start_server`` raises, naming itself.
"""
import collections
import json
import os

import numpy as np
import pytest
import torch

import flexflow_tpu.obs as jobs
import flexflow_tpu_torch.obs as tobs
from flexflow_tpu.models import bert as jbert
from flexflow_tpu.models import gpt2 as jgpt2
from flexflow_tpu.resilience import ChaosPlan as JaxChaosPlan
from flexflow_tpu_torch.models import bert as tbert
from flexflow_tpu_torch.models import gpt2 as tgpt2
from flexflow_tpu_torch.models import train_flops_per_step
from flexflow_tpu_torch.ops.base import hookless_flops
from flexflow_tpu_torch.ops.fused import apply_fusion
from flexflow_tpu_torch.resilience import ChaosPlan
from torch_resilience_pairs import (data, fj, ft, params_of, seed_params,
                                    small_model)

# the first step's loss across the packages from equal params: summation
# order only; the later steps of the 18-step run drift as
# ``torch_resilience_pairs.STEP_TOL`` notes for the params (losses of
# order 1-14 measured 1.7e-6 apart at most against JAX on one device,
# 1.9e-4 relative on the tests' 8-device CPU mesh); the band is five times
# the latter
FIRST_LOSS_TOL = dict(rtol=1e-5, atol=0.0)
LOSS_BAND = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(autouse=True)
def _tracers_off():
    """Each test starts and ends with both packages' tracers disabled."""
    tobs.disable()
    jobs.disable()
    yield
    tobs.disable()
    jobs.disable()


# ------------------------------------------------------------- telemetry
def _fill(tel):
    for wall, loss in ((1.0, 2.0), (0.1, 1.0), (0.2, 0.5), (0.1, 0.4)):
        tel.record_step(wall, loss)
    tel.record_epoch(0.4)
    tel.flops_per_step, tel.peak_flops = 3 * 10 ** 12, 989e12
    tel.fault_events, tel.recovery_events, tel.checkpoints_saved = 1, 1, 4
    tel.last_resume_step = 2
    tel.requests_served, tel.tokens_generated = 3, 24
    tel.serving_p50_token_ms, tel.serving_tokens_per_s = 1.23456, 812.5
    tel.serving_host_overhead_fraction = 0.123456
    tel.serving_prefix_hits, tel.serving_prefix_tokens_reused = 2, 32
    tel.serving_prefill_tokens_computed = 7
    tel.finalize()


def test_step_telemetry_summary_math():
    tel = tobs.StepTelemetry(batch_size=10)
    _fill(tel)
    assert tel.first_step_s() == 1.0
    assert tel.steady_step_s() == 0.1
    assert tel.samples_per_sec() == pytest.approx(100.0)
    s = tel.summary()
    assert s["compile_overhead_s"] == pytest.approx(0.9)
    assert s["loss_history"] == [2.0, 1.0, 0.5, 0.4]
    want = jobs.StepTelemetry(batch_size=10)
    _fill(want)
    w = want.summary()
    del s["total_wall_s"], w["total_wall_s"]
    assert s == w


def _graphs(pkg_bert, pkg_gpt2):
    return {"bert": lambda ff: pkg_bert.build_bert(ff,
                                                   pkg_bert.BertConfig.tiny()),
            "gpt2": lambda ff: pkg_gpt2.build_gpt2(ff,
                                                   pkg_gpt2.GPT2Config.tiny())}


@pytest.mark.parametrize("model", ["bert", "gpt2"])
def test_model_flops_per_step_equals_jax(model):
    """The same integer as the JAX function on the same graph; a fused
    graph counts the same (a region sums its sub-ops), and so does
    ``train_flops_per_step``, the matmul count."""
    jff = fj.FFModel(fj.FFConfig())
    _graphs(jbert, jgpt2)[model](jff)
    want = jobs.model_flops_per_step(jff.create_pcg())
    counts = {}
    for fusion in (False, True):
        c = ft.FFConfig()
        c.batch_size, c.perform_fusion = 8, fusion
        tff = ft.FFModel(c, device="cpu")
        _graphs(tbert, tgpt2)[model](tff)
        pcg = tff.create_pcg()
        assert tobs.model_flops_per_step(pcg) == want
        assert tobs.model_flops_per_step(apply_fusion(pcg)[0]) == want
        tff.compile()
        assert tobs.model_flops_per_step(tff.pcg) == want
        counts[fusion] = train_flops_per_step(tff)
        # the JAX count is the matmul count and the hookless ops' elements
        assert want == counts[fusion] + 3 * hookless_flops(tff.pcg)
    assert counts[True] == counts[False] > 0


# ------------------------------------------------------- fit, eval, trace
def _files(tmp_path, pkg):
    return (str(tmp_path / f"{pkg.__name__}_tel.json"),
            str(tmp_path / f"{pkg.__name__}_trace.json"))


def test_fit_telemetry_and_trace_equal_jax(tmp_path):
    x, y = data()
    runs, init = {}, None
    for pkg, plan, obs in ((ft, ChaosPlan, tobs), (fj, JaxChaosPlan, jobs)):
        tel_path, trace_path = _files(tmp_path, pkg)
        ff = small_model(pkg, checkpoint_dir=str(tmp_path / pkg.__name__),
                         checkpoint_every=2, max_bad_steps=1,
                         telemetry_file=tel_path, trace_file=trace_path)
        if init is None:
            init = params_of(ff)
        else:
            seed_params(ff, init)
        ff.fit(x, y, epochs=2, chaos=plan(nan_at_steps={11}))
        ff.eval(x, y)
        obs.disable()
        with open(tel_path) as f, open(trace_path) as g:
            runs[pkg] = (ff.get_telemetry(), json.load(f), json.load(g))
    tel, got, trace = runs[ft]
    _jtel, want, jtrace = runs[fj]
    assert tel.summary()["resilience"] == got["resilience"]
    assert got["resilience"] == want["resilience"] == {
        "fault_events": 1, "recovery_events": 1, "skipped_steps": 1,
        "checkpoints_saved": 8, "last_resume_step": 10}
    assert set(got) == set(want) - {"device_memory"}
    for k in ("phase", "steps", "batch_size", "model_flops_per_step"):
        assert got[k] == want[k], k
    # 16 steps, the poisoned one (no loss recorded) and the replay
    assert got["steps"] == 18 and len(got["loss_history"]) == 17
    np.testing.assert_allclose(got["loss_history"][0],
                               want["loss_history"][0], **FIRST_LOSS_TOL)
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               **LOSS_BAND)
    np.testing.assert_allclose(got["epoch_loss"], want["epoch_loss"],
                               **LOSS_BAND)

    def names(tr):
        return collections.Counter((e["name"], e["ph"])
                                   for e in tr["traceEvents"])

    assert names(trace) == names(jtrace)
    assert names(trace)[("train_step", "X")] == 18


def test_compile_and_eval_write_the_trace_file(tmp_path):
    """``compile`` and ``eval`` flush ``--trace-file`` themselves, in both
    packages, with the same events."""
    x, y = data()
    events = {}
    for pkg, obs in ((ft, tobs), (fj, jobs)):
        _tel, trace_path = _files(tmp_path, pkg)
        ff = small_model(pkg, trace_file=trace_path)
        with open(trace_path) as f:
            after_compile = {e["name"] for e in json.load(f)["traceEvents"]}
        ff.eval(x, y)
        with open(trace_path) as f:
            after_eval = [e["name"] for e in json.load(f)["traceEvents"]]
        obs.disable()
        events[pkg] = (after_compile, sorted(after_eval))
    assert events[ft] == events[fj]
    assert events[ft] == ({"compile"}, ["compile", "eval"])


def test_generate_writes_the_telemetry_file(tmp_path):
    c = ft.FFConfig()
    c.batch_size, c.telemetry_file = 8, str(tmp_path / "serve.json")
    ff = ft.FFModel(c, device="cpu")
    tgpt2.build_gpt2(ff, tgpt2.GPT2Config.tiny())
    ff.compile()
    outs = ff.generate([[1, 2, 3], [4, 5]], max_new_tokens=4,
                       max_inflight=2, max_decode_len=16)
    with open(c.telemetry_file) as f:
        tel = json.load(f)
    assert tel["phase"] == "serving" and tel["batch_size"] == 2
    assert tel["serving"]["requests_served"] == 2
    assert tel["serving"]["tokens_generated"] == sum(map(len, outs)) == 8
    assert ff.get_telemetry().tokens_generated == 8


def test_sinks_off_write_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ff = small_model()
    x, y = data()
    ff.fit(x, y, epochs=1)
    ff.eval(x, y)
    assert ff.get_telemetry() is None
    assert os.listdir(tmp_path) == []
    assert len(tobs.get_tracer().events) == 0


def test_profiler_trace_dir_names_the_nodes(tmp_path):
    """``--profiler-trace-dir`` runs fit under ``torch.profiler``: one
    Chrome trace in the directory, whose ranges name each node of the
    graph (every step is eager on the CPU)."""
    d = str(tmp_path / "prof")
    ff = small_model(profiler_trace_dir=d)
    x, y = data()
    ff.fit(x[:16], y[:16], epochs=1)
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        ranges = {e["name"] for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"}
    nodes = {n.name for n in ff.pcg.compute_nodes()}
    assert nodes <= ranges, nodes - ranges


def test_profiler_passthroughs(tmp_path):
    with pytest.raises(NotImplementedError, match="obs.start_server"):
        tobs.start_server()
    tobs.start_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        tobs.start_trace(str(tmp_path))
    torch.ones(4).sum()
    path = tobs.stop_trace()
    assert os.path.dirname(path) == str(tmp_path) and os.path.isfile(path)
    with tobs.trace_dir(str(tmp_path)) as t:
        torch.ones(4).sum()
    assert os.path.isfile(t.path) and t.path != path
    assert tobs.detect_peak_flops() is None  # no card here
