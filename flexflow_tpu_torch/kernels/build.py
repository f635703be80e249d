"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``; the
wrappers pass tensor pointers and PyTorch's current stream. Nothing builds
at import: a kernel's library is built the first time its wrapper launches
it (or by :func:`build_all`, which starts one ``nvcc`` per source, all at
once). Libraries land in ``kernels/_build/`` (git-ignored), named by a hash
of their source and flags, so an edited source rebuilds and an unchanged
one is reused. A kernel that cannot be built, loaded or launched raises
:class:`KernelFault`, with the compiler's output for a failed build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

#: kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "flash_decode": "flash_decode.cu",
    "flash_attention": "flash_attention.cu",
    "softmax": "softmax.cu",
    "topk": "topk.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# loaded libraries of this process, by kernel name
_LOADED: Dict[str, ctypes.CDLL] = {}


class KernelFault(RuntimeError):
    """A kernel of the port could not be built, loaded or launched: a fault
    of the program, never device loss, so no caller may route around it
    (``serving.resilience.looks_like_program_fault``)."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelFault(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the port's "
        "CUDA kernels are compiled from source at first use")


def library_path(name: str) -> str:
    src = os.path.join(CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, SOURCES[name])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    """Wait for one nvcc, publish its library atomically, and keep the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    beside it as ``<library>.log``."""
    log, _ = proc.communicate()
    out = library_path(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise KernelFault(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    with open(out + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return log


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every kernel (or ``names``) that has no library yet, one nvcc
    process per source, all started together. Returns {name: compiler
    report} for the kernels built by this call."""
    procs: Dict[str, Optional[subprocess.Popen]] = {}
    reports = {}
    try:
        for n in names or list(SOURCES):
            procs[n] = _start(n)
        for n, p in procs.items():
            if p is not None:
                reports[n] = _finish(n, p)
    except OSError as e:  # the build directory, nvcc's start, the publish
        raise KernelFault(
            f"building kernels {names or list(SOURCES)}: {e}") from e
    finally:
        for p in procs.values():
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        try:
            lib = ctypes.CDLL(library_path(name))
        except OSError as e:
            raise KernelFault(f"loading kernel {name}: {e}") from e
        lib.ff_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ff_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.ff_cuda_error_string(code).decode()
        raise KernelFault(f"{what}: CUDA error {code} ({msg})")
