"""The port's checkpoints (``flexflow_tpu_torch/execution/checkpoint.py``)
against the JAX package's rules (``tests/test_resilience.py:88-216, 548``):
atomic commit, garbage and uncommitted directories skipped, the pre-marker
format still read, empty and missing directories, checksums that catch a
flipped byte and a truncation, the async manager's retention and stale
staging sweep, pruning, and the exact-resume batch cursor. Then what the
port adds: a save -> restore roundtrip is bitwise for the params and the
SGD, momentum, nesterov and Adam state (the step count included), restores
into the live tensors in place, refuses a model of other shapes, and
writes the JAX package's ``meta.json`` and ``train_state.json`` keys.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.execution.checkpoint import (
    STALE_TMP_AGE_S, CheckpointCorruptError, CheckpointManager,
    is_committed, latest_checkpoint, list_checkpoints, prune_checkpoints,
    read_meta, read_train_state, restore_checkpoint, save_checkpoint,
    verify_checkpoint)
from flexflow_tpu_torch.resilience import corrupt_checkpoint
from torch_resilience_pairs import (BATCH, assert_params, data, params_of,
                                    small_model, state_arrays)


def _trained(opt="sgd", epochs=1):
    ff = small_model(opt=opt)
    x, y = data()
    ff.fit(x, y, epochs=epochs)
    return ff


# ===================================================== atomic commit protocol
def test_save_commits_atomically(tmp_path):
    ff = _trained()
    path = save_checkpoint(ff, str(tmp_path), step=3,
                           train_state={"step": 3, "epoch": 0,
                                        "batch_in_epoch": 3,
                                        "rng_counter": ff._rng_counter})
    assert os.path.basename(path) == "step_3"
    assert is_committed(path)
    assert verify_checkpoint(path) == []
    assert read_train_state(path)["batch_in_epoch"] == 3
    assert sorted(os.listdir(path)) == [
        "COMMIT", "meta.json", "opt_state.pt", "params.pt",
        "strategy.json", "train_state.json"]
    assert not [d for d in os.listdir(tmp_path) if ".tmp." in d]
    # overwrite of the same step is allowed and stays committed
    path2 = save_checkpoint(ff, str(tmp_path), step=3)
    assert path2 == path and is_committed(path)


def test_latest_skips_uncommitted_and_garbage(tmp_path):
    ff = small_model()
    p1 = save_checkpoint(ff, str(tmp_path), step=1)
    torn = tmp_path / "step_9"
    torn.mkdir()
    (torn / "meta.json").write_text('{"step": 9')  # truncated json too
    (tmp_path / "step_5.tmp.12345").mkdir()
    (tmp_path / "step_x").mkdir()
    (tmp_path / "not_a_checkpoint").write_text("x")
    assert latest_checkpoint(str(tmp_path)) == p1
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [1]
    p2 = save_checkpoint(ff, str(tmp_path), step=2)
    corrupt_checkpoint(p2, mode="uncommit")
    assert latest_checkpoint(str(tmp_path)) == p1
    with pytest.raises(CheckpointCorruptError, match="commit marker"):
        restore_checkpoint(ff, p2)


def test_legacy_pre_marker_checkpoint_still_restores(tmp_path):
    """A checkpoint without marker, ``format_version`` and checksums (the
    pre-marker format) counts as committed and restores; a meta that
    declares ``format_version`` without its marker does not."""
    ff = _trained()
    legacy = tmp_path / "step_4"
    legacy.mkdir()
    torch.save(ff.params, str(legacy / "params.pt"))
    torch.save(ff.opt_state, str(legacy / "opt_state.pt"))
    (legacy / "meta.json").write_text(json.dumps(
        {"step": 4, "mesh_shape": [1], "axis_names": ["data"]}))
    assert is_committed(str(legacy))
    assert latest_checkpoint(str(tmp_path)) == str(legacy)
    ff2 = small_model()
    assert restore_checkpoint(ff2, str(legacy)) == 4
    assert_params(params_of(ff2), params_of(ff))
    torn = tmp_path / "step_5"
    torn.mkdir()
    (torn / "meta.json").write_text(json.dumps(
        {"step": 5, "format_version": 1}))
    assert not is_committed(str(torn))
    assert latest_checkpoint(str(tmp_path)) == str(legacy)


def test_latest_checkpoint_empty_and_missing(tmp_path):
    assert latest_checkpoint(str(tmp_path / "nope")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    assert list_checkpoints(str(tmp_path / "nope")) == []


@pytest.mark.parametrize("mode", ["truncate", "flip"])
def test_checksums_catch_corruption(tmp_path, mode):
    ff = small_model()
    p1 = save_checkpoint(ff, str(tmp_path), step=1)
    p2 = save_checkpoint(ff, str(tmp_path), step=2)
    before = state_arrays(ff)
    corrupt_checkpoint(p2, mode=mode)
    assert verify_checkpoint(p2) != []
    with pytest.raises(CheckpointCorruptError, match="checksum"):
        restore_checkpoint(ff, p2)
    # nothing of the model was touched
    for a, b in zip(state_arrays(ff), before):
        np.testing.assert_array_equal(a, b)
    # verify=True falls back past the corrupted latest to the good one
    assert latest_checkpoint(str(tmp_path), verify=True) == p1
    assert latest_checkpoint(str(tmp_path)) == p2


def test_manager_async_retention(tmp_path):
    """Async saves commit in the background; retention keeps the newest N
    committed checkpoints and sweeps a dead writer's old staging dir but
    not a fresh one (a live writer's, mid-save)."""
    ff = small_model()
    stale = tmp_path / "step_0.tmp.99999"
    stale.mkdir()
    old = time.time() - STALE_TMP_AGE_S - 60
    os.utime(stale, (old, old))
    fresh = tmp_path / "step_0.tmp.88888"
    fresh.mkdir()
    mgr = CheckpointManager(ff, str(tmp_path), keep=2)
    try:
        for s in range(1, 6):
            mgr.save_async(s, {"step": s, "epoch": 0, "batch_in_epoch": s,
                               "rng_counter": s})
        mgr.flush()
        assert mgr.saved == 5 and not mgr.errors
        assert mgr.last_committed_step == 5
        assert [s for s, _ in list_checkpoints(str(tmp_path))] == [4, 5]
        assert not stale.exists()
        assert fresh.exists()
        assert [s for s, _b, _t in mgr.saves] == [1, 2, 3, 4, 5]
        nbytes = sum(t.numel() * 4 for ws in ff.params.values()
                     for t in ws.values()) + 4  # + the int32 step count
        assert all(b == nbytes for _s, b, _t in mgr.saves)
        assert len(mgr.blocked_s) == 5
        # the sync path writes the live state, and skips a committed step
        assert mgr.save_sync(5) == mgr.last_committed_path
        assert mgr.save_sync(6).endswith("step_6")
    finally:
        mgr.close()
    assert not mgr._worker.is_alive()


def test_manager_snapshot_is_taken_at_save_async(tmp_path):
    """The snapshot is the state when ``save_async`` ran, not when the
    writer got to it: a step taken right after does not leak in."""
    ff = small_model()
    x, y = data()
    mgr = CheckpointManager(ff, str(tmp_path), keep=3)
    try:
        want = params_of(ff)
        mgr.save_async(0)
        ff.fit(x[:BATCH], y[:BATCH], epochs=1)
        mgr.flush()
    finally:
        mgr.close()
    fresh = small_model()
    restore_checkpoint(fresh, mgr.last_committed_path)
    assert_params(params_of(fresh), want)


def test_prune_keeps_newest(tmp_path):
    ff = small_model()
    paths = [save_checkpoint(ff, str(tmp_path), step=s) for s in (1, 2, 3)]
    removed = prune_checkpoints(str(tmp_path), keep=1)
    assert paths[0] in removed and paths[1] in removed
    assert latest_checkpoint(str(tmp_path)) == paths[2]


# ================================================================ roundtrip
@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov", "adam",
                                 "adam_bf16_moments"])
def test_roundtrip_is_bitwise_and_in_place(tmp_path, opt):
    """save -> restore gives every param and optimizer-state tensor back
    bit for bit (the 0-d int32 step count too), written into the model's
    live tensors; one more step from the restored model equals one more
    step from the saved one."""
    a = _trained(opt)
    assert int(a.opt_state["step"]) == 8
    path = save_checkpoint(a, str(tmp_path), step=8)
    b = small_model(opt=opt)
    live = [(t, t.data_ptr()) for t in
            _leaves(b.params) + _leaves(b.opt_state)]
    assert restore_checkpoint(b, path) == 8
    for t, ptr in live:
        assert t.data_ptr() == ptr  # in place
    assert [t for t, _ in live] == _leaves(b.params) + _leaves(b.opt_state)
    for got, want in zip(state_arrays(b), state_arrays(a)):
        np.testing.assert_array_equal(got, want)
    assert b.opt_state["step"].dtype == torch.int32
    x, y = data()
    a.fit(x[:BATCH], y[:BATCH], epochs=1)
    b.fit(x[:BATCH], y[:BATCH], epochs=1)
    for got, want in zip(state_arrays(b), state_arrays(a)):
        np.testing.assert_array_equal(got, want)


def _leaves(tree):
    from flexflow_tpu_torch.execution.graphs import _tensors_of

    return _tensors_of(tree)


def test_restore_refuses_another_model(tmp_path):
    path = save_checkpoint(small_model(), str(tmp_path), step=1)
    import flexflow_tpu_torch as ft

    cfg = ft.FFConfig()
    cfg.batch_size = BATCH
    other = ft.FFModel(cfg, device="cpu")
    x = other.create_tensor((BATCH, 16), name="x")
    other.dense(other.relu(other.dense(x, 48, name="d1")), 10, name="d2")
    other.compile(optimizer=ft.SGDOptimizer(None, lr=0.05))
    with pytest.raises(CheckpointCorruptError, match="d1"):
        restore_checkpoint(other, path)
    adam = small_model(opt="adam")
    with pytest.raises(CheckpointCorruptError, match="opt_state"):
        restore_checkpoint(adam, path)


def test_metadata_keys_match_the_jax_package(tmp_path):
    """``meta.json``, the marker and ``train_state.json`` carry the JAX
    package's keys, the one-device layout and a crc32 per payload."""
    import jax  # noqa: F401  (the JAX package's checkpoint)
    from flexflow_tpu.execution.checkpoint import \
        save_checkpoint as jax_save
    from torch_resilience_pairs import fj

    ts = {"step": 2, "epoch": 0, "batch_in_epoch": 2, "rng_counter": 2}
    jp = jax_save(small_model(fj), str(tmp_path / "jax"), step=2,
                  train_state=ts)
    tp = save_checkpoint(small_model(), str(tmp_path / "torch"), step=2,
                         train_state=ts)
    jm, tm = read_meta(jp), read_meta(tp)
    assert set(tm) == set(jm)
    assert tm["mesh_shape"] == [1] and tm["n_devices"] == 1
    assert tm["format_version"] == jm["format_version"]
    assert set(tm["checksums"]) == {"opt_state.pt", "params.pt",
                                    "strategy.json", "train_state.json"}
    assert read_train_state(tp) == read_train_state(jp) == ts
    with open(os.path.join(tp, "COMMIT")) as f, \
            open(os.path.join(jp, "COMMIT")) as g:
        assert set(json.load(f)) == set(json.load(g))


# ================================================== exact-resume machinery
def test_batch_iterator_start_batch():
    from flexflow_tpu.data.dataloader import batch_iterator as jax_batches
    from flexflow_tpu_torch.data.dataloader import batch_iterator

    x = np.arange(64).reshape(64, 1).astype(np.float32)
    full = [b[0].ravel().tolist()
            for b in batch_iterator([x], 8, shuffle=True, seed=5)]
    tail = [b[0].ravel().tolist()
            for b in batch_iterator([x], 8, shuffle=True, seed=5,
                                    start_batch=3)]
    assert tail == full[3:]
    assert tail == [np.asarray(b[0]).ravel().tolist()
                    for b in jax_batches([x], 8, shuffle=True, seed=5,
                                         start_batch=3)]
    full = [b[0].ravel().tolist() for b in batch_iterator([x], 8)]
    tail = [b[0].ravel().tolist()
            for b in batch_iterator([x], 8, start_batch=6)]
    assert tail == full[6:]
    assert list(batch_iterator([x], 8, shuffle=True, start_batch=8)) == []
