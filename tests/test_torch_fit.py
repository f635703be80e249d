"""``fit``, ``eval`` and ``predict`` of the port against the JAX package's.

The tiny BERT proxy (with the accuracy metric) and the tiny causal GPT-2 of
``torch_training_pairs``, flash attention on every layer, the JAX weights
carried over. ``fit`` with ``shuffle=True`` over 2 epochs of 12 samples
(6 Adam steps): the per-step losses within 1e-5 (JAX's from its step
telemetry, the port's from ``fit_history``), the ``PerfMetrics`` counts
equal and the trained params within rtol 1e-4 / atol 1e-5. ``predict``
over 10 samples (a padded partial batch) and ``eval`` within 1e-5 and
equal counts. The dataloader yields the JAX package's batches, shuffled
or not, and its prefetch thread passes errors on and stops when left.
"""
import numpy as np
import pytest

import jax

from torch_training_pairs import (B, N_SAMPLES, TOL, assert_trees_close,
                                  build_pair, data)


@pytest.mark.parametrize("model", ["bert", "gpt2"])
def test_fit_two_shuffled_epochs_match_jax(model):
    jff, tff = build_pair(model, accuracy=model == "bert")
    x, y = data(model, n=N_SAMPLES, seed=1)
    jff._telemetry_requested = True  # per-step losses in JAX's telemetry
    jperf = jff.fit(x, y, epochs=2, shuffle=True)
    tperf = tff.fit(x, y, epochs=2, shuffle=True)
    jlosses = jff._telemetry.loss_history
    assert len(jlosses) == len(tff.fit_history.loss) == 2 * N_SAMPLES // B
    np.testing.assert_allclose(tff.fit_history.loss, jlosses, **TOL)
    assert tperf.train_all == jperf.train_all == 2 * N_SAMPLES
    assert tperf.train_correct == jperf.train_correct
    assert_trees_close(jax.device_get(jff.params), tff.get_params_numpy(),
                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model", ["bert", "gpt2"])
def test_eval_and_predict_match_jax(model):
    jff, tff = build_pair(model, accuracy=model == "bert")
    # 10 samples: the last batch is partial (predict pads and trims it)
    x, y = data(model, n=10, seed=2)
    np.testing.assert_allclose(tff.predict(x), np.asarray(jff.predict(x)),
                               **TOL)
    # eval runs a partial last batch unpadded; GPT-2's position ids are
    # baked for the declared batch in both packages, so it evaluates whole
    # batches only
    n = 10 if model == "bert" else 8
    jperf, tperf = jff.eval(x[:n], y[:n]), tff.eval(x[:n], y[:n])
    assert tperf.train_all == jperf.train_all == n
    assert tperf.train_correct == jperf.train_correct


def test_batches_match_jax_and_prefetch_stops_cleanly():
    """``batch_iterator`` yields the JAX package's batches (its shuffle and
    gathers); ``prefetch_iterator`` stages them in order, passes a
    producer error on, and joins its thread when left early."""
    import threading

    import torch

    from flexflow_tpu.data.dataloader import batch_iterator as jax_batches
    from flexflow_tpu_torch.data.dataloader import (SingleDataLoader,
                                                    batch_iterator,
                                                    prefetch_iterator)

    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal((22, 3)).astype(np.float32),
              rng.integers(0, 9, (22, 1)).astype(np.int32)]
    for shuffle, drop in ((True, True), (False, False), (True, False)):
        want = list(jax_batches(arrays, 4, shuffle=shuffle, seed=11,
                                drop_remainder=drop))
        got = list(batch_iterator(arrays, 4, shuffle=shuffle, seed=11,
                                  drop_remainder=drop))
        assert len(got) == len(want)
        for gb, wb in zip(got, want):
            for g, w in zip(gb, wb):
                np.testing.assert_array_equal(g, np.asarray(w))
    dev = torch.device("cpu")
    staged = list(prefetch_iterator(batch_iterator(arrays, 4), dev))
    assert len(staged) == 5
    assert torch.equal(staged[2][0], torch.from_numpy(arrays[0][8:12]))

    def broken():
        yield [arrays[0][:4]]
        raise RuntimeError("source failed")

    with pytest.raises(RuntimeError, match="source failed"):
        list(prefetch_iterator(broken(), dev))
    loader = SingleDataLoader(None, type("T", (), {"dims": (8, 3)}),
                              arrays[0])
    assert loader.num_batches == 2
    batches = [loader.next_batch() for _ in range(3)]
    np.testing.assert_array_equal(batches[1], arrays[0][8:16])
    np.testing.assert_array_equal(batches[2], arrays[0][:8])  # wraps
    before = threading.active_count()
    it = prefetch_iterator(batch_iterator(arrays, 2), dev, depth=1)
    next(it)
    it.close()
    assert threading.active_count() <= before
