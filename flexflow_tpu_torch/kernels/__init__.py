"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

  - ``flash_attention``: tiled online-softmax attention forward
    (``csrc/flash_attention_fwd.cu``), the port of the JAX package's
    Pallas ``_fwd_kernel``.

``registry`` holds the per-op implementation variants (attention
xla/flash/ring, the optimizer update) and the forcing rules. ``build``
compiles ``csrc/*.cu`` with nvcc on first use; nothing is built when this
package is imported.
"""
from .flash_attention import (dropout_keep_mask, flash_attention,
                              flash_attention_plain, mha_reference)
from .registry import (DEFAULT_IMPLS, KernelImpl, REGISTRY, attention_ctx,
                       get_impl, parse_forced, resolve_forced)

__all__ = [
    "DEFAULT_IMPLS",
    "KernelImpl",
    "REGISTRY",
    "attention_ctx",
    "dropout_keep_mask",
    "flash_attention",
    "flash_attention_plain",
    "get_impl",
    "mha_reference",
    "parse_forced",
    "resolve_forced",
]
