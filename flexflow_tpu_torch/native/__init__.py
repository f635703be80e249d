"""The host C++ helper of the search, loaded with ctypes.

Port of ``flexflow_tpu.native`` (flexflow_tpu/native/__init__.py): the
event-driven task-graph makespan (``simulate_taskgraph``) that
``search.simulator.Simulator.simulate_event_driven`` and the pipeline
makespans of ``search.unity`` run on, and the immediate dominators of an
int-id DAG (``imm_dominators_edges``). The source is this package's own
``ffnative.cpp``; ``g++`` builds it at first use into the git-ignored
``native/_build/``, named by a hash of the source and flags, so an edited
source rebuilds. A failed build raises with the compiler's output: there
is no quiet fallback. The Python versions (``simulate_taskgraph_py``)
stay beside it as the plain reference the tests hold the native one
against.
"""
from __future__ import annotations

import ctypes
import hashlib
import heapq
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "ffnative.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libffnative-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(
            f"native: g++ could not build {SOURCE}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"native: g++ failed to build {SOURCE} (exit "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built from ``ffnative.cpp`` on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not os.path.exists(out):
            _build(out)
        lib = ctypes.CDLL(out)
        lib.simulate_taskgraph.restype = ctypes.c_double
        lib.simulate_taskgraph.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.imm_dominators_native.restype = ctypes.c_int
        lib.imm_dominators_native.argtypes = [
            ctypes.c_int32, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def simulate_taskgraph(costs: np.ndarray, device: np.ndarray,
                       n_devices: int, edges_src: np.ndarray,
                       edges_dst: np.ndarray) -> float:
    """Event-driven task-graph makespan: each task starts when its
    predecessors have finished and its device is free (reference:
    Simulator::simulate_runtime, simulator.cc:815)."""
    costs = np.ascontiguousarray(costs, dtype=np.float64)
    device = np.ascontiguousarray(device, dtype=np.int32)
    esrc = np.ascontiguousarray(edges_src, dtype=np.int32)
    edst = np.ascontiguousarray(edges_dst, dtype=np.int32)
    r = get_lib().simulate_taskgraph(
        len(costs), costs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        device.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_devices, len(esrc),
        esrc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        edst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if r < 0:
        raise ValueError(
            "simulate_taskgraph: invalid task graph "
            "(cycle, bad edge, or device id out of range)")
    return float(r)


def imm_dominators_edges(n: int, edges) -> np.ndarray:
    """Immediate dominators of an int-id DAG. edges: iterable of (src, dst).
    Returns an int32 array with -1 for roots. Raises ValueError on cycles."""
    esrc = np.ascontiguousarray([e[0] for e in edges], dtype=np.int32)
    edst = np.ascontiguousarray([e[1] for e in edges], dtype=np.int32)
    out = np.empty(n, dtype=np.int32)
    rc = get_lib().imm_dominators_native(
        n, len(esrc),
        esrc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        edst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc == -2:
        raise ValueError("imm_dominators: graph has a cycle")
    if rc != 0:
        raise ValueError("imm_dominators: invalid edge list")
    return out


def simulate_taskgraph_py(costs, device, n_devices, edges_src,
                          edges_dst) -> float:
    """The plain Python version of :func:`simulate_taskgraph`."""
    esrc, edst = np.asarray(edges_src), np.asarray(edges_dst)
    n = len(costs)
    out = [[] for _ in range(n)]
    indeg = [0] * n
    for s, d in zip(esrc, edst):
        out[s].append(int(d))
        indeg[d] += 1
    if any(int(d) < 0 or int(d) >= n_devices for d in device):
        raise ValueError("simulate_taskgraph: device id out of range")
    ready = [0.0] * n
    dev_free = [0.0] * max(n_devices, 1)
    q = [(0.0, i) for i in range(n) if indeg[i] == 0]
    heapq.heapify(q)
    makespan = 0.0
    done = 0
    while q:
        rt, t = heapq.heappop(q)
        dev = int(device[t])
        start = max(rt, dev_free[dev])
        finish = start + float(costs[t])
        dev_free[dev] = finish
        makespan = max(makespan, finish)
        done += 1
        for c in out[t]:
            ready[c] = max(ready[c], finish)
            indeg[c] -= 1
            if indeg[c] == 0:
                heapq.heappush(q, (ready[c], c))
    if done != n:
        raise ValueError("simulate_taskgraph: task graph has a cycle")
    return makespan
