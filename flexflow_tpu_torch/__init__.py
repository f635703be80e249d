"""flexflow_tpu_torch: the PyTorch / CUDA port of flexflow_tpu for NVIDIA
Hopper GPUs.

The same FFModel builder API, config flags, layer names and parameter
layouts as ``flexflow_tpu``; plain tensor code is PyTorch, and every Pallas
kernel of the JAX package on a ported path is a hand-written CUDA kernel
(``kernels/csrc``). This package never imports ``jax`` or ``flexflow_tpu``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.

Ported so far: serving — the GPT-2 family through ``FFModel.generate`` /
``ServingEngine`` over the paged KV pool or the ring, with the flash-decode
and top-k kernels, the serving programs, the async loop, serving under
failure, speculative decoding (``serving.SpeculativeDecoder``) and LSTM
language models with their carry as decode state — and training on one
device — ``compile(optimizer, loss_type, metrics)``, ``fit`` / ``eval`` /
``predict`` for the BERT proxy and GPT-2, with the flash-attention forward
and backward kernels, the steps as CUDA graphs, checkpoints and
``--resume`` (``save_checkpoint`` / ``restore_checkpoint`` /
``latest_checkpoint``), the divergence sentinel, fault injection
(``ChaosPlan``), ``--remat``, telemetry and tracing — and the conv,
batch-norm, elementwise and tensor ops with the vision and recommendation
models (AlexNet, ResNet-50, InceptionV3, ResNeXt-50, DLRM, XDL, MLP_Unify,
CANDLE-Uno) — and the LSTM and MoE ops with NMT, the Transformer proxy,
its causal decoder (served) and the MoE MLP — and strategies on a
``torch.distributed`` device mesh (``parallel/``: data, tensor, hybrid
and expert parallelism, strategy import and export).
"""
from .config import FFConfig, FFIterationConfig  # noqa: F401
from .ffconst import (ActiMode, AggrMode, CompMode, DataType,  # noqa: F401
                      LossType, MetricsType, OperatorType, PoolType)
from .tensor import Tensor  # noqa: F401
from .layer import Layer  # noqa: F401
from .model import FFModel  # noqa: F401
from .execution.initializers import (ConstantInitializer,  # noqa: F401
                                     GlorotUniformInitializer,
                                     NormInitializer, UniformInitializer,
                                     ZeroInitializer)
from .execution.metrics import PerfMetrics  # noqa: F401
from .execution.optimizers import AdamOptimizer, SGDOptimizer  # noqa: F401
from .execution.checkpoint import (latest_checkpoint,  # noqa: F401
                                   restore_checkpoint, save_checkpoint)
from .resilience import ChaosPlan  # noqa: F401
from .serving import ServingEngine  # noqa: F401

__version__ = "0.1.0"
