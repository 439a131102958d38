"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu.

The same model-building API (``FFModel``, ``FFConfig``, the enums), run
by PyTorch on an NVIDIA GPU, with the JAX package's Pallas TPU kernels
rewritten by hand in CUDA C++ for Hopper (``kernels/``, ``csrc/``). The
package imports torch and numpy only, never JAX or ``flexflow_tpu``.

Quick start::

    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models import BertConfig, build_bert
    from flexflow_tpu_torch.serving import InferenceSession
    cfg = FFConfig(); cfg.batch_size = 8
    cfg.kernel_impls = "attention:flash,opt_update:fused"
    ff = FFModel(cfg)                      # device="cpu" for the CPU
    out = build_bert(ff, 8, 128, BertConfig.base())
    ff.compile(AdamOptimizer(1e-4), "sparse_categorical_crossentropy",
               ["accuracy"], output_tensor=out)
    history = ff.fit([ids, pos], labels, epochs=2)     # training
    metrics = ff.eval([ids, pos], labels)
    probs = InferenceSession(ff, batch_buckets=(8,)).infer(
        {"input_ids": ids[:8], "position_ids": pos[:8]})  # serving
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
