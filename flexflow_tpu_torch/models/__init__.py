"""Model builders."""
from .dlrm import build_dlrm  # noqa: F401
from .gpt2 import GPT2Config, build_gpt2  # noqa: F401
from .misc import build_candle_uno, build_mlp_unify, build_xdl  # noqa: F401
from .vision import (build_alexnet, build_alexnet_cifar10,  # noqa: F401
                     build_inception_v3, build_resnet50, build_resnext50,
                     vision_train_flops_per_step)
