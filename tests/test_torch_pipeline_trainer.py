"""The port's ``PipelineTrainer`` and pipeline ``fit`` on four gloo ranks
(``tests/torch_pipeline_pairs.py`` runs the ranks): what the trainer does
beyond the numbers of tests/test_torch_pipeline.py.

* Host-to-device copies a step do not grow with the microbatch count (one
  per (chunk, feed) and one of the labels, each rank taking its rows).
* The (microbatch, chunk) entries a rank holds awaiting backward never
  exceed ``pipeline_in_flight`` (in chunks: v of them make one device's
  share under interleaved).
* Stage remat ``none``, ``selective`` and ``full`` give the same grads
  within 1e-6 (read off one SGD step at learning rate 1).
* A stage cut whose feed skips a chunk (a residual across stages) trains:
  gpipe and 1f1b bitwise equal, the first step within 1e-5 of one device.
* ``compile(strategy_fn=)`` with a 1f1b grid, then ``fit`` / ``eval`` /
  ``predict``, lowers the loss and leaves every rank with the same params
  (as tests/test_pipeline_schedules.py:361-395), also with ranks past the
  grid (pp 2 x dp 1 on four ranks), which hold no stage and get the
  trained weights at the end of ``fit``.
* ``fit(chaos=)`` raises ``ValueError`` as the JAX package does; the
  checkpoint flags raise, naming themselves.
* Under the process tracer each rank records a ``pipeline_fwd`` span for
  every forward of its chunks but the last (fused with its backward) and
  a ``pipeline_bwd`` span for every backward, with the microbatch, chunk,
  pipe device and schedule (flexflow_tpu/parallel/pipeline.py:783-819).
"""
import numpy as np
import pytest

import torch_dist_pairs as tp
import torch_pipeline_pairs as pairs
from flexflow_tpu_torch.parallel.pipeline import pipeline_in_flight
from torch_pipeline_refs import (TOL, assert_trees_close,
                                 assert_trees_equal, port_one_device,
                                 weights, write_case)

WORLD = 4
MICROS = (2, 4, 8)
LIVE = (("gpipe", 1), ("1f1b", 1), ("interleaved", 2))
REMATS = ("none", "selective", "full")
SKIP_SCHEDULES = ("gpipe", "1f1b")
FITS = {"fit_2x2": (2, 2), "fit_2x1": (2, 1)}
EPOCHS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline_trainer"))
    ws = {m: weights(m) for m in ("mlp", "bert", "skip")}
    cases = []

    def add(name, model, kind, args, **extra):
        x, y = pairs.data(model)
        write_case(root, name, x, y, ws[model], **extra)
        cases.append((name, kind, args))

    for n in MICROS:
        add(f"micro{n}", "mlp", "train", dict(
            model="mlp", pp=2, dp=2, n_micro=n, schedule="1f1b", steps=1))
    for sched, v in LIVE:
        add(f"live_{sched}", "bert", "train", dict(
            model="bert", pp=4, dp=1, n_micro=8, schedule=sched,
            virtual_stages=v, steps=1))
    for level in REMATS:
        add(f"remat_{level}", "bert", "train", dict(
            model="bert", pp=2, dp=2, n_micro=4, remat=level,
            opt="sgd:1.0", steps=1))
    for sched in SKIP_SCHEDULES:
        add(f"skip_{sched}", "skip", "train", dict(
            model="skip", pp=4, dp=1, n_micro=4, schedule=sched))
    for name, (pp, dp) in FITS.items():
        add(name, "mlp", "compile_fit", dict(
            model="mlp", pp=pp, dp=dp, n_micro=4, schedule="1f1b"),
            epochs=np.int64(EPOCHS))
    add("refuse", "mlp", "refuse", dict(model="mlp", pp=2, dp=2, n_micro=4,
                                        schedule="1f1b"))
    add("spans", "mlp", "spans", dict(model="mlp", pp=2, dp=2, n_micro=4,
                                      schedule="interleaved",
                                      virtual_stages=2))
    procs = pairs.start(WORLD, root, cases)
    x, y = pairs.data("skip")
    one = port_one_device("skip", ws["skip"], x, y)
    tp.finish(procs, root, timeout=300)
    return root, ws, one


def test_host_copies_do_not_grow_with_n_micro(runs):
    root, _ws, _one = runs
    for rank in range(WORLD):
        copies = [int(tp.load(root, f"micro{n}", rank)["host_copies"])
                  for n in MICROS]
        # stage 0 ranks: the model input; the last stage's: the labels
        assert copies == [1] * len(MICROS), copies


@pytest.mark.parametrize("sched,v", LIVE)
def test_live_boundary_tensors_within_pipeline_in_flight(runs, sched, v):
    root, _ws, _one = runs
    bound = v * pipeline_in_flight(sched, 4, 8, v)
    peaks = [int(tp.load(root, f"live_{sched}", r)["peak_live"])
             for r in range(WORLD)]
    assert max(peaks) <= bound, (peaks, bound)
    if sched == "gpipe":  # gpipe holds every microbatch on every stage
        assert peaks == [8] * WORLD


def test_stage_remat_levels_give_the_same_grads(runs):
    root, ws, _one = runs
    for rank in range(WORLD):
        grads = {}
        for level in REMATS:
            p = tp.unflat("p0", tp.load(root, f"remat_{level}", rank))
            grads[level] = {n: {w: ws["bert"][n][w] - a for w, a in
                                p[n].items()} for n in p}
        for level in REMATS[1:]:
            assert_trees_close(grads["none"], grads[level], rtol=0,
                               atol=1e-6)


def test_a_feed_that_skips_a_chunk_trains(runs):
    root, _ws, (one_loss, _g, one_params) = runs
    got = {s: tp.load(root, f"skip_{s}", 0) for s in SKIP_SCHEDULES}
    feeds = [tuple(int(a) for a in f.split("<"))
             for f in got["gpipe"]["feeds"]]
    assert any(c - src >= 2 for c, src in feeds), feeds
    for rank in range(WORLD):
        want = tp.load(root, "skip_gpipe", rank)
        other = tp.load(root, "skip_1f1b", rank)
        for s in range(2):
            assert other[f"loss{s}"] == want[f"loss{s}"]
            assert_trees_equal(tp.unflat(f"p{s}", want),
                               tp.unflat(f"p{s}", other))
        assert float(want["loss1"]) < float(want["loss0"])
        np.testing.assert_allclose(float(want["loss0"]), one_loss, **TOL)
        assert_trees_close(one_params, tp.unflat("p0", want), **TOL)


@pytest.mark.parametrize("name", sorted(FITS))
def test_compile_fit_eval_predict_through_a_1f1b_grid(runs, name):
    root, _ws, _one = runs
    x, _y = pairs.data("mlp")
    got = [tp.load(root, name, r) for r in range(WORLD)]
    for g in got:
        assert str(g["schedule"]) == "1f1b"
        assert float(g["after"]) < float(g["before"])
        assert len(g["losses"]) == EPOCHS
        assert g["pred"].shape == (len(x), 10)
    for g in got[1:]:
        np.testing.assert_array_equal(g["losses"], got[0]["losses"])
        np.testing.assert_array_equal(g["pred"], got[0]["pred"])
        assert_trees_equal(tp.unflat("p", got[0]), tp.unflat("p", g))


def test_chaos_and_checkpoint_flags_raise_by_name(runs):
    root, _ws, _one = runs
    got = tp.load(root, "refuse", 0)
    assert "chaos" in str(got["chaos"])
    for field, flag in (("checkpoint_dir", "--checkpoint-dir"),
                        ("resume", "--resume"),
                        ("max_bad_steps", "--max-bad-steps")):
        msg = str(got[field])
        assert flag in msg and "pipeline" in msg, msg


def test_tracer_spans_name_microbatch_stage_device_and_schedule(runs):
    root, _ws, _one = runs
    for rank in range(WORLD):
        got = sorted(str(e) for e in tp.load(root, "spans", rank)["spans"])
        d = rank // 2  # pp 2 x dp 2: rank d * 2 + j
        chunks = (d, d + 2)  # v 2: chunk c on device c % 2
        want = sorted(
            [f"pipeline_fwd:{m}:{c}:{d}:interleaved" for m in range(4)
             for c in chunks if c != 3] +
            [f"pipeline_bwd:{m}:{c}:{d}:interleaved" for m in range(4)
             for c in chunks])
        assert got == want
