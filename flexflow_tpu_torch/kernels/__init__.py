"""Hand-written CUDA kernels of the port (sources under ``csrc/``). Each
kernel module holds the wrapper, its plain-PyTorch version and a launch
counter (e.g. ``kernels.flash_decode``)."""
from .build import build_all  # noqa: F401
