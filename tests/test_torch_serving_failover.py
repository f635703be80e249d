"""Device-loss failover in the port's serving engine
(``flexflow_tpu_torch/serving/engine.py`` ``_decode_with_failover`` and
``_rebuild_lost_state``, ``serving/resilience.py``) against the JAX
package (``tests/test_serving_resilience.py:309-361``), in the sync and the
async loop:

* a scripted ``ChaosPlan.drop_devices_at`` mid-decode replans once through
  ``elastic_replan`` and the pool survives the hop: the streams are an
  undisturbed run's;
* a real loss raised from inside the dispatch with the pool's buffers gone
  (``untyped_storage().resize_(0)``, the port's stand-in for JAX's
  ``leaf.delete()``) replans, rebuilds the pool and re-prefills every live
  stream: the streams hold, every request ends ok;
* the detector: the JAX package's markers word for word and the CUDA
  runtime's own texts for a device unavailable, off the bus or lost are
  device loss; an illegal address, a launch failure and a kernel build
  error are faults of the program, and they propagate (from the dispatch,
  the health probe and the fleet's tick) instead of replanning;
* two engines of one model used in turns keep their own pool-bound program
  entries; a pool reset and a rebuild release the engine's entries.
"""
import pytest
import torch

import flexflow_tpu.serving.resilience as jres
import flexflow_tpu_torch.serving.resilience as tres
from torch_fleet_pairs import make_fleet
from torch_serving_pairs import both, engine, pkgs, prompts  # noqa: F401

LOOPS = ["sync", "async"]


@pytest.mark.parametrize("loop", LOOPS)
def test_device_drop_auto_replans_decode_state_bitwise(pkgs, loop):
    ps = prompts(4, seed=8)

    def run(p):
        base = engine(p, serve_loop=loop).generate(ps, max_new_tokens=5)
        eng = engine(p, serve_loop=loop)
        chaos = p.ChaosPlan(drop_devices_at={2: 4})
        outs = eng.generate(ps, max_new_tokens=5, chaos=chaos)
        plan = eng.plan
        return (base, outs, chaos.devices_dropped, eng.stats.replans,
                plan is not None and
                plan.mesh_shape[0] * plan.mesh_shape[1] <= 4,
                dict(eng.stats.outcomes))

    j, t = both(pkgs, run)
    assert t == j
    base, outs, dropped, replans, planned, outcomes = t
    assert outs == base and dropped == [2] and replans == 1 and planned
    assert outcomes == {"ok": 4}


def _lose_buffers(p, eng, tree):
    if p.name == "jax":
        import jax

        for leaf in jax.tree_util.tree_leaves(tree):
            leaf.delete()
    else:
        from flexflow_tpu_torch.execution.graphs import _tensors_of

        for t in _tensors_of(tree):
            t.untyped_storage().resize_(0)


@pytest.mark.parametrize("loop", LOOPS)
def test_real_loss_with_dead_state_reprefills_bitwise(pkgs, loop):
    ps = prompts(3, seed=11)

    def run(p):
        base = engine(p, exact_decode=True, serve_loop=loop).generate(
            ps, max_new_tokens=5)
        eng = engine(p, exact_decode=True, serve_loop=loop)
        real = eng._decode_fn
        fired = []

        def patched(guard=False):
            fn = real(guard=guard)

            def wrapper(params, toks, state):
                if eng.stats.decode_steps == 2 and not fired:
                    fired.append(True)
                    _lose_buffers(p, eng, (state, eng._last_tokens))
                    raise RuntimeError(
                        "FAILED_PRECONDITION: Device is lost")
                return fn(params, toks, state)
            return wrapper

        eng._decode_fn = patched
        outs = eng.generate(ps, max_new_tokens=5, chaos=p.ChaosPlan())
        return (base, outs, bool(fired), eng.stats.replans,
                dict(eng.stats.outcomes))

    j, t = both(pkgs, run)
    assert t == j
    base, outs, fired, replans, outcomes = t
    assert fired and outs == base and replans == 1
    assert outcomes == {"ok": 3}


LOSS = ["device_unavailable", "DEVICE UNAVAILABLE",
        "FAILED_PRECONDITION: Device is lost", "TPU is unhealthy",
        "chip unreachable", "slice has been terminated"]
CUDA_LOSS = ["CUDA error: CUDA-capable device(s) is/are busy or unavailable",
             "flash_decode: CUDA error 46 (CUDA-capable device(s) is/are "
             "busy or unavailable)",
             "NVML: GPU has fallen off the bus", "nvmlDeviceGetHandle: "
             "GPU is lost"]
PROGRAM = ["CUDA error: an illegal memory access was encountered",
           "flash_decode: CUDA error 700 (an illegal memory access was "
           "encountered)",
           "topk: CUDA error 719 (unspecified launch failure)",
           "CUDA error: misaligned address"]
OTHER = ["shape mismatch in matmul", "RESOURCE_EXHAUSTED: out of memory",
         "replica mesh fell off the network"]


@pytest.mark.parametrize("msg", LOSS + CUDA_LOSS + PROGRAM + OTHER)
def test_device_loss_detector_and_its_negatives(msg):
    exc = RuntimeError(msg)
    if msg in LOSS:
        assert tres.looks_like_device_loss(exc)
        assert jres.looks_like_device_loss(exc)
    elif msg in CUDA_LOSS:
        assert tres.looks_like_device_loss(exc)
    else:
        assert not tres.looks_like_device_loss(exc)
        assert not jres.looks_like_device_loss(exc)
    assert tres.looks_like_program_fault(exc) == (msg in PROGRAM)
    assert tres.looks_like_device_loss(tres.DeviceLossError(2))
    assert not tres.looks_like_program_fault(tres.DeviceLossError(2))


def _kernel_fault(kind, monkeypatch, tmp_path):
    """An error of the port's kernel layer (``kernels/build.py``) raised for
    real on this machine: nvcc missing, nvcc failing, a library that does
    not load, a build directory that cannot be made; or a launch check's
    CUDA error."""
    import shutil

    import torch.utils.cpp_extension as cpp_extension

    from flexflow_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.delitem(build._LOADED, "topk", raising=False)
    try:
        if kind == "nvcc_missing":
            monkeypatch.setattr(build.shutil, "which", lambda _name: None)
            monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
            build.nvcc_path()
        elif kind == "nvcc_failed":
            monkeypatch.setattr(build, "nvcc_path",
                                lambda: shutil.which("false"))
            build.build_all(["topk"])
        elif kind == "cdll":
            (tmp_path / "_build").mkdir()
            with open(build.library_path("topk"), "wb") as f:
                f.write(b"not a shared library")
            build.load("topk")
        elif kind == "build_dir":
            (tmp_path / "file").write_text("")
            monkeypatch.setattr(build, "BUILD_DIR",
                                str(tmp_path / "file" / "_build"))
            build.build_all(["topk"])
        else:
            lib = type("Lib", (), {"ff_cuda_error_string":
                                   staticmethod(lambda code: kind.encode())})
            build.check(lib, 700, "flash_decode")
    except build.KernelFault as e:
        return e
    raise AssertionError(f"{kind}: the kernel layer raised nothing")


BUILD_FAULTS = ["nvcc_missing", "nvcc_failed", "cdll", "build_dir"]
LAUNCH_FAULTS = ["an illegal memory access was encountered",
                 "unspecified launch failure"]


@pytest.mark.parametrize("kind", BUILD_FAULTS + LAUNCH_FAULTS)
def test_kernel_layer_faults_are_program_faults(kind, monkeypatch,
                                                tmp_path):
    exc = _kernel_fault(kind, monkeypatch, tmp_path)
    assert tres.looks_like_program_fault(exc)
    assert not tres.looks_like_device_loss(exc)
    if kind == "nvcc_missing":
        assert "nvcc not found" in str(exc)
    elif kind == "nvcc_failed":
        assert "nvcc failed" in str(exc)
    elif kind in ("cdll", "build_dir"):
        assert isinstance(exc.__cause__, OSError)


@pytest.mark.parametrize("fault", PROGRAM[1:3] + OTHER[:1] + BUILD_FAULTS)
def test_program_faults_propagate_without_a_replan(pkgs, fault, monkeypatch,
                                                   tmp_path):
    """A kernel fault raised from the decode dispatch propagates: no
    replan, no rebuild (the JAX engine propagates non-loss errors too);
    the health probe and the fleet's tick re-raise it as well. The build
    faults are the kernel layer's own errors (a kernel builds at its first
    launch, inside a replica's tick)."""
    p = pkgs["torch"]
    with monkeypatch.context() as m:
        exc = _kernel_fault(fault, m, tmp_path) if fault in BUILD_FAULTS \
            else RuntimeError(fault)
    program = fault in PROGRAM or fault in BUILD_FAULTS
    eng = engine(p)

    def broken(guard=False):
        def step(params, toks, state):
            raise exc
        return step

    eng._decode_fn = broken
    with pytest.raises(RuntimeError) as ei:
        eng.generate(prompts(2, seed=1), max_new_tokens=3,
                     chaos=p.ChaosPlan())
    assert ei.value is exc and eng.stats.replans == 0
    probe = engine(p)
    probe._prefill_fn = lambda bucket: broken()
    if program:
        with pytest.raises(RuntimeError) as ei:
            probe.health_probe()
        assert ei.value is exc
    else:
        assert probe.health_probe() is False
    fleet = make_fleet(p)

    def dispatch(*_args, **_kw):
        raise exc

    fleet.replicas[0].engine._dispatch_decode = dispatch
    if program:
        with pytest.raises(RuntimeError) as ei:
            fleet.generate(prompts(4, seed=2), max_new_tokens=3)
        assert ei.value is exc
    else:
        fleet.generate(prompts(4, seed=2), max_new_tokens=3)
        assert fleet.replicas[0].health == "dead"
        assert fleet.stats.outcomes == {"ok": 4}


def test_state_buffers_lost_reads_storage_not_shape():
    t = torch.zeros(4, 3)
    assert not tres.state_buffers_lost({"a": (t, t)}, None)
    dead = torch.zeros(2, 2)
    dead.untyped_storage().resize_(0)
    assert tres.state_buffers_lost({"a": (t, dead)})
    assert not tres.state_buffers_lost(torch.zeros(0))


def test_engines_in_turns_keep_their_own_program_entries(pkgs):
    """Two engines of one model alternate: each keeps its own chunk and
    decode programs, whose entries (the graphs on the card) survive the
    other's runs; a pool reset releases the engine's entries, and the
    rebuilt pool is entered once more."""
    p = pkgs["torch"]
    ps = prompts(3, seed=12)
    a, b = engine(p, kv_block_size=8, prefill_chunk_tokens=8), \
        engine(p, kv_block_size=8, prefill_chunk_tokens=8)
    want = a.generate(ps, max_new_tokens=4)
    prog_a = a._decode_fn(a._last_guard).program
    prog_b = b._decode_fn(b._last_guard).program
    assert prog_a is not prog_b
    entries = dict(prog_a._entries)
    assert entries
    for _ in range(2):
        assert b.generate(ps, max_new_tokens=4) == want
        assert a.generate(ps, max_new_tokens=4) == want
        assert all(prog_a._entries[k] is e for k, e in entries.items())
    assert not any(k[0] in ("decode", "chunk")
                   for k in p.ff.executor._serving_fns)
    assert any(fn.program is prog_a for fn in a._pool_fns.values())
    assert prog_a in a.programs() and prog_a not in b.programs()
    a.reset_decode_pool()
    assert a.state is None and not prog_a._entries
    assert prog_b._entries  # the other engine's entries stay
    assert a.generate(ps, max_new_tokens=4) == want
    assert len(prog_a._entries) == 1 and a._decode_fn(
        a._last_guard).program is prog_a


def test_fleet_replicas_keep_their_own_decode_programs(pkgs):
    p = pkgs["torch"]
    fleet = make_fleet(p)
    fleet.generate(prompts(6, seed=13), max_new_tokens=4)
    progs = [r.engine._decode_fn(True).program for r in fleet.replicas]
    assert progs[0] is not progs[1]
    assert all(len(pr._entries) == 1 for pr in progs)
    firsts = [next(iter(pr._entries.values())) for pr in progs]
    fleet.generate(prompts(6, seed=14), max_new_tokens=4)
    assert [next(iter(pr._entries.values())) for pr in progs] == firsts


def test_async_rebuild_propagates_a_program_fault_from_the_settle(
        pkgs, monkeypatch):
    """In the async loop a lost decode state first settles the step in
    flight; a kernel fault surfacing there propagates (a settle whose
    buffers died with the device is dropped instead)."""
    from flexflow_tpu_torch.kernels.build import KernelFault
    from flexflow_tpu_torch.serving import engine as tengine

    p = pkgs["torch"]
    eng = engine(p, serve_loop="async")
    fault = KernelFault("topk: CUDA error 700 (an illegal memory access "
                        "was encountered)")
    real, calls, raised = eng._decode_with_failover, [], []

    def lost(*args, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise tres.DecodeStateLostError("decode state lost")
        return real(*args, **kw)

    settle = tengine._AsyncServeLoop._settle_pending

    def settle_after_loss(loop):
        if len(calls) == 3 and not raised:
            raised.append(1)  # once: a dropped settle would serve on
            raise fault
        return settle(loop)

    eng._decode_with_failover = lost
    monkeypatch.setattr(tengine._AsyncServeLoop, "_settle_pending",
                        settle_after_loss)
    with pytest.raises(KernelFault) as ei:
        eng.generate(prompts(2, seed=3), max_new_tokens=5)
    assert ei.value is fault and len(calls) == 3
