"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

  - ``flash_attention``: tiled online-softmax attention, differentiable:
    the forward (``csrc/flash_attention_fwd.cu``) and the dq and dk/dv
    backward kernels (``csrc/flash_attention_bwd.cu``), the ports of the
    JAX package's Pallas ``_fwd_kernel``, ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``;
  - ``opt_update``: the fused multi-tensor Adam update
    (``csrc/adam_update.cu``), the port of the Pallas ``_adam_kernel``.

``registry`` holds the per-op implementation variants (attention
xla/flash/ring, the optimizer update) and the forcing rules. ``build``
compiles ``csrc/*.cu`` with nvcc on first use; nothing is built when this
package is imported.
"""
from .flash_attention import (dropout_keep_mask, flash_attention,
                              flash_attention_bwd_dkv,
                              flash_attention_bwd_dq,
                              flash_attention_bwd_plain,
                              flash_attention_plain, mha_reference)
from .opt_update import fused_adam_update, fused_adam_update_plain
from .registry import (DEFAULT_IMPLS, KernelImpl, REGISTRY, attention_ctx,
                       get_impl, parse_forced, resolve_forced)

__all__ = [
    "DEFAULT_IMPLS",
    "KernelImpl",
    "REGISTRY",
    "attention_ctx",
    "dropout_keep_mask",
    "flash_attention",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_plain",
    "flash_attention_plain",
    "fused_adam_update",
    "fused_adam_update_plain",
    "get_impl",
    "mha_reference",
    "parse_forced",
    "resolve_forced",
]
