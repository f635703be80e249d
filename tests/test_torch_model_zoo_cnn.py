"""InceptionV3 and ResNeXt-50 of the port against the JAX package, on the
CPU, at reduced size (the rest of the zoo is in test_torch_model_zoo.py;
the two files split the time of the JAX side's builds).

Both keep their published widths; only the input and the batch are cut:

* InceptionV3 at image 75 (published 299), the smallest input whose stem
  and reduction blocks leave every feature map at 1x1 or larger, batch 2;
* ResNeXt-50 32x4d at image 32 (published 224), batch 2: its last stage
  runs at 1x1.

Checked (``torch_zoo_pairs``): the inference output within 1e-5, one
training step's loss within 1e-5 relative and its grads within 1e-4
relative norm, or, where a ReLU output lies on opposite sides of 0 in the
two packages, each conv and dense node alone within 1e-4.
"""
import pytest

from flexflow_tpu.models import vision as jv
from flexflow_tpu_torch.models import vision as tv
from torch_zoo_pairs import build_pair, check_forward, check_step, data

CASES = {
    "inception_v3": (lambda ff, pkg: (jv if pkg == "jax" else tv)
                     .build_inception_v3(ff, 2, 75), 2),
    "resnext50": (lambda ff, pkg: (jv if pkg == "jax" else tv)
                  .build_resnext50(ff, 2, 32), 2),
}


@pytest.mark.parametrize("model", sorted(CASES))
def test_forward_and_one_step_match_jax(model):
    build, batch = CASES[model]
    jff, tff = build_pair(build, batch)
    xs, y = data(tff, batch)
    check_forward(jff, tff, xs)
    print(model, check_step(jff, tff, xs, y))
