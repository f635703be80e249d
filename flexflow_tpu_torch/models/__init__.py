"""Model builders."""
from ..model import train_flops_per_step  # noqa: F401
from .dlrm import build_dlrm  # noqa: F401
from .gpt2 import GPT2Config, build_gpt2  # noqa: F401
from .misc import build_candle_uno, build_mlp_unify, build_xdl  # noqa: F401
from .nmt import NMTConfig, build_nmt  # noqa: F401
from .transformer import (TransformerConfig, build_moe_mlp,  # noqa: F401
                          build_transformer, build_transformer_decoder)
from .vision import (build_alexnet, build_alexnet_cifar10,  # noqa: F401
                     build_inception_v3, build_resnet50, build_resnext50)
