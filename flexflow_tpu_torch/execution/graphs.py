"""Step programs: a step's body captured once per input shape as a CUDA
graph and replayed — the port's counterpart of the JAX package's jitted,
donated, static-shape steps (``Executor.make_train_step``,
``make_decode_step``).

A :class:`StepProgram` wraps a body ``body(inputs, seeds, *args) -> [tensor,
...]``:

* **Static inputs.** Each call copies ``inputs`` into buffers the program
  owns, one set per shape key (the inputs' shapes and dtypes, and whether
  the step has a generator, as ``jax.jit`` keys its cache on avals), with
  ``non_blocking`` copies: a pinned host input must be left alone until
  its copy ran (the serving engine's staging buffers see to it). The
  ``args`` (params, optimizer state, KV pools) are not copied: they are
  updated in place and must be the same tensors on every replay. The
  program holds the tensors it captured against and, when a call passes
  others (a replaced param, another engine's pools), drops that graph and
  starts the shape over, so a graph never reads a freed or stale tensor.
* **Capture.** The first call of a shape key runs the body eagerly on the
  program's side stream (a real step; it also makes what is made once —
  cuBLAS workspaces, constants on the device, the kernels' ticket
  counters). The second captures the body with ``torch.cuda.graph`` on the
  graph's own memory pool and replays it once for that step: capture
  records without executing, so every step runs once, as eagerly. Every
  later call is copy-in, then replay. :attr:`StepProgram.captures` counts
  the captures.
* **Static outputs.** A replay rewrites the same output tensors; a call
  returns device copies of them, so a caller may keep several steps'
  outputs (``fit`` stacks the losses at the end) without a sync.
* **Dropout seeds.** The flash kernels read their seed from device memory.
  The first call draws the seeds from the step's generator as the ops ask
  (:class:`DropoutSeeds`) and counts them; before every later call the
  host draws the same number from that call's generator, in the same
  order, into the program's seed buffer with one copy, and the ops read
  its elements. A replay therefore masks with the seeds an eager step
  would have drawn from the same generator.
* **Launch counts.** A replay calls no kernel wrapper, so the program
  records each kernel's launch count increase during capture and adds it
  on every later replay: ``launch_count`` still counts the launches the
  card ran.

On the CPU nothing is captured: each call runs the body through the same
static input and seed buffers and copies its outputs into static outputs,
so the CPU tests exercise the plumbing. A capture or replay error raises;
nothing falls back to the eager body.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

# kernel modules whose ``_launches`` dicts a replay advances
_COUNTED = ("flash_attention", "flash_decode", "softmax", "topk")


def draw_seed(rng) -> int:
    """One uint32 from the step's generator: a flash kernel's dropout seed
    (JAX folds its step key into ``jax.random.bits``)."""
    import torch

    return int(torch.randint(0, 2 ** 32, (1,), generator=rng,
                             dtype=torch.int64))


class DropoutSeeds:
    """The dropout seeds of one step, handed out in op order by
    :meth:`next`. Without ``fed`` each is drawn from ``rng`` as asked (and
    kept in :attr:`drawn`); with ``fed`` (the program's int32 seed buffer,
    filled from ``rng`` before the step) each is the next element of it, a
    0-d tensor the kernels read on the device."""

    def __init__(self, rng, fed=None):
        self.rng = rng
        self.fed = fed
        self.count = 0
        self.drawn: List[int] = []

    def next(self):
        i = self.count
        self.count += 1
        if self.fed is None:
            self.drawn.append(draw_seed(self.rng))
            return self.drawn[-1]
        if i >= self.fed.numel():
            raise RuntimeError(
                f"step program: the step asked for dropout seed {i + 1} but "
                f"its first run drew {self.fed.numel()}")
        return self.fed[i]


class SegmentSeeds:
    """The dropout seeds of one remat block (``Executor._forward_remat``):
    on the block's first run each seed comes from the step's stream
    ``source`` (its generator or :class:`DropoutSeeds`) as an op asks and
    is kept; the recompute in the backward (:meth:`replay`) hands the kept
    seeds out again in the same order. The stream is therefore drawn once
    per seed, in op order, as without remat, and a captured step draws no
    seed the first run did not."""

    def __init__(self, source):
        self.source = source
        self.drawn: List[Any] = []
        self.sealed = False  # a run of the block has ended
        self._started = False
        self._i = 0

    def replay(self) -> "SegmentSeeds":
        """Start a run of the block: the first draws, later ones replay."""
        self.sealed, self._started = self._started, True
        self._i = 0
        return self

    def next(self):
        i = self._i
        self._i += 1
        if i < len(self.drawn):
            return self.drawn[i]
        if self.sealed:
            raise RuntimeError(
                f"remat block: the recompute asked for dropout seed {i + 1} "
                f"but the block's first run drew {len(self.drawn)}")
        self.drawn.append(next_seed(self.source))
        return self.drawn[-1]


def next_seed(rng):
    """The next dropout seed of the step: one uint32 drawn from ``rng`` when
    it is the step's ``torch.Generator`` (JAX folds its step key into
    ``jax.random.bits``), else the next of a step program's
    :class:`DropoutSeeds` or a remat block's :class:`SegmentSeeds` (the
    same values, drawn from the same generator in the same order)."""
    if isinstance(rng, (DropoutSeeds, SegmentSeeds)):
        return rng.next()
    return draw_seed(rng)


def _launch_counts() -> Dict[Tuple[str, str], int]:
    import importlib

    counts = {}
    for mod in _COUNTED:
        launches = importlib.import_module(f"..kernels.{mod}",
                                           __package__)._launches
        counts.update(((mod, k), v) for k, v in launches.items())
    return counts


def _add_launches(delta: Dict[Tuple[str, str], int]) -> None:
    import importlib

    for (mod, k), n in delta.items():
        importlib.import_module(f"..kernels.{mod}",
                                __package__)._launches[k] += n


_streams: Dict[Any, Any] = {}


def capture_stream(device):
    """The side stream every program of ``device`` runs its first call and
    its captures on (one per device: cuBLAS keeps a workspace per
    stream)."""
    import torch

    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def _tensors_of(tree) -> List[Any]:
    """The tensors of a tree of dicts, lists, tuples and dataclasses, in
    order."""
    import torch

    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors_of(x)]
    return []


@dataclasses.dataclass
class _Entry:
    """One shape key's buffers, seed count and (on CUDA) graph."""

    inputs: List[Any]
    stamp: List[Any]
    n_seeds: int
    seeds: Any                      # int32 seed buffer (>= 1 element)
    outputs: Optional[List[Any]] = None
    graph: Any = None
    launches: Dict[Tuple[str, str], int] = dataclasses.field(
        default_factory=dict)

    def matches(self, stamp) -> bool:
        return len(stamp) == len(self.stamp) and all(
            a is b for a, b in zip(stamp, self.stamp))


class StepProgram:
    """A step body captured per input shape and replayed (module doc)."""

    def __init__(self, body: Callable, device, name: str):
        self.body = body
        self.device = device
        self.name = name
        #: graphs captured since this program was made
        self.captures = 0
        #: the seeds fed to the last call that read the seed buffer
        self.last_seeds: List[int] = []
        self._entries: Dict[Tuple, _Entry] = {}

    def reset(self) -> None:
        """Drop every graph and buffer (their memory pools with them)."""
        self._entries.clear()

    def __call__(self, inputs, *args, rng=None):
        import torch

        key = (tuple((tuple(t.shape), t.dtype) for t in inputs),
               rng is None)
        stamp = _tensors_of(args)
        entry = self._entries.get(key)
        if entry is not None and not entry.matches(stamp):
            del self._entries[key]
            entry = None
        if entry is None:
            return self._first_call(key, inputs, args, stamp, rng)
        for buf, x in zip(entry.inputs, inputs):
            buf.copy_(x, non_blocking=True)
        seeds = self._feed_seeds(entry, rng)
        if self.device.type != "cuda":
            outs = self.body(entry.inputs, seeds, *args)
            self._check_seeds(entry, seeds)
            for buf, o in zip(entry.outputs, outs):
                buf.copy_(o)
        elif entry.graph is None:
            self._capture(entry, args, seeds)
        else:
            entry.graph.replay()
            _add_launches(entry.launches)
        with torch.no_grad():
            return [o.clone() for o in entry.outputs]

    # -------------------------------------------------------------- phases
    def _first_call(self, key, inputs, args, stamp, rng):
        """The shape's first call: the body eagerly, a real step, through
        freshly made static buffers."""
        import torch

        bufs = [torch.empty(x.shape, dtype=x.dtype, device=self.device)
                for x in inputs]
        for buf, x in zip(bufs, inputs):
            buf.copy_(x, non_blocking=True)
        seeds = DropoutSeeds(rng) if rng is not None else None
        if self.device.type == "cuda":
            side = capture_stream(self.device)
            cur = torch.cuda.current_stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                outs = self.body(bufs, seeds, *args)
            cur.wait_stream(side)
            for o in outs:
                o.record_stream(cur)
        else:
            outs = self.body(bufs, seeds, *args)
        n = seeds.count if seeds is not None else 0
        entry = _Entry(inputs=bufs, stamp=stamp, n_seeds=n,
                       seeds=torch.zeros((max(n, 1),), dtype=torch.int32,
                                         device=self.device))
        if self.device.type != "cuda":
            entry.outputs = [o.detach().clone() for o in outs]
        self._entries[key] = entry
        self.last_seeds = list(seeds.drawn) if seeds is not None else []
        return outs

    def _feed_seeds(self, entry: _Entry, rng) -> Optional[DropoutSeeds]:
        """Draw the step's seeds from ``rng`` on the host, in the order the
        first call drew them, and copy them into the seed buffer (one
        copy; a pinned source on CUDA, which the caching host allocator
        keeps until the copy has read it)."""
        import torch

        if rng is None:
            return None
        seeds = [draw_seed(rng) for _ in range(entry.n_seeds)]
        self.last_seeds = seeds
        if seeds:
            host = torch.from_numpy(
                np.asarray(seeds, np.int64).astype(np.uint32).view(np.int32))
            if self.device.type == "cuda":
                entry.seeds[:len(seeds)].copy_(host.pin_memory(),
                                               non_blocking=True)
            else:
                entry.seeds[:len(seeds)].copy_(host)
        return DropoutSeeds(rng, fed=entry.seeds[:entry.n_seeds])

    def _check_seeds(self, entry: _Entry, seeds) -> None:
        used = seeds.count if seeds is not None else 0
        if used != entry.n_seeds:
            raise RuntimeError(
                f"step program {self.name}: the step drew {used} dropout "
                f"seeds, its first run {entry.n_seeds}")

    def _capture(self, entry: _Entry, args, seeds) -> None:
        """Capture the body on the graph's own pool, then replay it once
        for this call's step.

        Garbage in reference cycles may hold CUDA graphs (a dropped
        model's programs): destroying one while this capture runs would
        invalidate it, so the collector runs first and stays off until the
        capture ends. The capture checks only this thread's CUDA calls
        (``thread_local``): ``fit``'s prefetch thread keeps staging batches
        into pinned memory on its own stream meanwhile."""
        import gc

        import torch

        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=capture_stream(self.device),
                                  capture_error_mode="thread_local"):
                outs = self.body(entry.inputs, seeds, *args)
        finally:
            if collecting:
                gc.enable()
        self._check_seeds(entry, seeds)
        after = _launch_counts()
        entry.launches = {k: after[k] - before.get(k, 0) for k in after
                          if after[k] != before.get(k, 0)}
        entry.graph, entry.outputs = graph, list(outs)
        self.captures += 1
        graph.replay()


class HostTransfer:
    """A device->host copy of a step's outputs (sampled tokens, the guarded
    step's ``ok``): on CUDA ``non_blocking`` into pinned memory with an
    event recorded behind it, so the host goes on until :meth:`wait`
    blocks on the event."""

    def __init__(self, t):
        import torch

        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().copy()


class EagerBody:
    """A step body called directly, with :class:`StepProgram`'s call
    interface and nothing captured: what ``capture=False`` gives (the
    eager steps the tests and ``chip_smoke.py`` compare against)."""

    captures = 0

    def __init__(self, body: Callable):
        self.body = body

    def reset(self) -> None:
        pass

    def __call__(self, inputs, *args, rng=None):
        return self.body(list(inputs), None, *args)


def step_program(body: Callable, device, name: str, capture: bool = True):
    """``body`` as a :class:`StepProgram`, or with ``capture=False`` as an
    :class:`EagerBody`."""
    if capture:
        return StepProgram(body, device, name)
    return EagerBody(body)
