"""ML frontends: torch.fx, ONNX, Keras-style (reference §2.7).

The port of ``flexflow_tpu/frontends/``. None of it needs ``transformers``
or ``onnx`` to import: the HF paths import ``transformers`` when they
run, and the ONNX frontend decodes the wire format itself when ``onnx``
is missing.
"""
from .torch_fx import PyTorchModel, torch_to_flexflow_graph  # noqa: F401
# onnx_frontend and keras are imported lazily by users:
#   from flexflow_tpu_torch.frontends.onnx_frontend import ONNXModel
#   from flexflow_tpu_torch.frontends import keras
