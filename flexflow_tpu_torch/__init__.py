"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu.

The same model-building API (``FFModel``, ``FFConfig``, the enums), run
by PyTorch on an NVIDIA GPU, with the JAX package's Pallas TPU kernels
rewritten by hand in CUDA C++ for Hopper (``kernels/``, ``csrc/``). The
package imports torch and numpy only, never JAX or ``flexflow_tpu``.

Quick start (the serving slice)::

    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import BertConfig, build_bert
    from flexflow_tpu_torch.serving import InferenceSession
    cfg = FFConfig(); cfg.kernel_impls = "attention:flash"
    ff = FFModel(cfg)                      # device="cpu" for the CPU
    out = build_bert(ff, 8, 128, BertConfig.base())
    ff.compile(SGDOptimizer(0.01), "sparse_categorical_crossentropy", [],
               output_tensor=out)
    probs = InferenceSession(ff, batch_buckets=(8,)).infer(
        {"input_ids": ids, "position_ids": pos})
"""
from .ffconst import (ActiMode, AggrMode, CompMode, DataType, InitializerType,
                      LossType, MetricsType, OperatorType, ParameterSyncType,
                      PoolType, RegularizerMode)
from .config import FFConfig
from .core.tensor import Tensor, WeightSpec
from .core.layer import Layer
from .model import FFModel
from .runtime.optimizers import AdamOptimizer, Optimizer, SGDOptimizer

__version__ = "0.1.0"
