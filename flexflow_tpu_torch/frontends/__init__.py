"""ML frontends (SURVEY §2.4): torch-fx importer, Keras clone, ONNX importer
(a port of ``flexflow_tpu.frontends``). The HF, tf.keras and ONNX paths
import transformers, tensorflow or onnx only when they are used, so this
package imports on a host that has none of them."""
from .torch_fx import PyTorchModel, copy_torch_weights  # noqa: F401
from . import keras  # noqa: F401
