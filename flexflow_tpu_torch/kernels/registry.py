"""Kernel tier — per-op implementation variants.

The port's copy of ``flexflow_tpu/kernels/registry.py``: the same op
kinds, impl names, predicates and forcing rules, so a strategy's
``kernel_impls`` block means the same in both packages. One difference:
the fused optimizer update requires the ``cuda`` backend where the JAX
package requires ``tpu``. ``FFModel._plan_kernels`` adopts forced
choices as they are and otherwise, with measured calibration rows
(``search/calibration.py``), the cheapest available impl per op.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Callable, Dict, List, Optional

ATTENTION = "attention"
OPT_UPDATE = "opt_update"

DEFAULT_IMPLS: Dict[str, str] = {ATTENTION: "xla", OPT_UPDATE: "unfused"}


def _attn_xla(ctx: Dict[str, Any]) -> Optional[str]:
    return None  # the plain path is always legal


def _attn_flash(ctx: Dict[str, Any]) -> Optional[str]:
    """Flash kernel: tiled online-softmax attention (structural legality
    only; on the CPU it runs as its plain twin)."""
    if ctx.get("sliding_window", 0):
        return "flash kernel has no sliding-window mask support"
    if ctx.get("causal", False) and \
            ctx.get("q_len", 0) != ctx.get("kv_len", 0):
        return "flash kernel does not mask causal cross-attention " \
               "(q_len != kv_len)"
    return None


def _attn_ring(ctx: Dict[str, Any]) -> Optional[str]:
    """Ring attention over the mesh's sequence axis (``seq``)."""
    deg = int(ctx.get("seq_degree", 0) or 0)
    if deg < 2:
        return "ring attention requires a mesh sequence axis " \
               "(seq degree >= 2); this mesh has none"
    q_len = int(ctx.get("q_len", 0) or 0)
    kv_len = int(ctx.get("kv_len", 0) or 0)
    if q_len != kv_len:
        return "ring attention requires self-attention (q_len == kv_len)"
    if q_len % deg != 0:
        return f"sequence length {q_len} is not divisible by the " \
               f"seq-axis degree {deg}"
    if ctx.get("sliding_window", 0):
        return "ring attention has no sliding-window mask support"
    if ctx.get("dropout", 0.0):
        return "ring attention has no in-kernel dropout"
    if ctx.get("kv_mode"):
        return "ring attention does not run under the KV-cache " \
               "prefill/decode paths"
    return None


def _opt_unfused(ctx: Dict[str, Any]) -> Optional[str]:
    return None


def _opt_fused(ctx: Dict[str, Any]) -> Optional[str]:
    """Fused optimizer update: one pass over (w, g, m, v)."""
    if ctx.get("backend") != "cuda":
        return "fused optimizer update runs on the cuda backend only"
    if ctx.get("optimizer", "adam") != "adam":
        return "fused update kernel covers Adam only"
    return None


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One implementation variant of a multi-impl op kind."""
    op: str
    name: str
    predicate: Callable[[Dict[str, Any]], Optional[str]]
    # calibration kind whose measured rows price this impl
    # (``op_attention@flash``); the analytic curve stands in without one
    calib_kind: str = ""

    def available(self, ctx: Dict[str, Any]) -> Optional[str]:
        """None when legal on ``ctx``, else a human-readable reason."""
        return self.predicate(ctx)

    def cost(self, cost_model, layer, shard_degrees,
             weight_shard_degree, **ctx) -> float:
        """Predicted seconds for this (op, impl) pair: measured rows
        first, the analytic curve otherwise (``OpCostModel.
        kernel_impl_cost``)."""
        return cost_model.kernel_impl_cost(
            layer, self.op, self.name, shard_degrees,
            weight_shard_degree, **ctx)


REGISTRY: Dict[str, Dict[str, KernelImpl]] = {
    ATTENTION: {
        "xla": KernelImpl(ATTENTION, "xla", _attn_xla,
                          "op_attention@xla"),
        "flash": KernelImpl(ATTENTION, "flash", _attn_flash,
                            "op_attention@flash"),
        "ring": KernelImpl(ATTENTION, "ring", _attn_ring,
                           "op_attention@ring"),
    },
    OPT_UPDATE: {
        "unfused": KernelImpl(OPT_UPDATE, "unfused", _opt_unfused,
                              "op_opt_update@unfused"),
        "fused": KernelImpl(OPT_UPDATE, "fused", _opt_fused,
                            "op_opt_update@fused"),
    },
}


def impl_names(op: str) -> List[str]:
    return list(REGISTRY[op])


def get_impl(op: str, name: str) -> KernelImpl:
    try:
        return REGISTRY[op][name]
    except KeyError:
        known = {k: sorted(v) for k, v in REGISTRY.items()}
        raise KeyError(
            f"unknown kernel impl {op}:{name} (known: {known})") from None


def available_impls(op: str, ctx: Dict[str, Any]) -> List[str]:
    """Impl names whose predicate holds on ``ctx`` (default first)."""
    out = [n for n, im in REGISTRY[op].items() if im.available(ctx) is None]
    d = DEFAULT_IMPLS[op]
    if d in out:
        out.remove(d)
        out.insert(0, d)
    return out


def attention_ctx(params: Dict[str, Any], q_len: int, kv_len: int,
                  *, backend: str = "", seq_degree: int = 0,
                  dropout: float = None, kv_mode: Optional[str] = None
                  ) -> Dict[str, Any]:
    """Predicate context for an attention layer's params + shapes."""
    h = int(params.get("num_heads", 1) or 1)
    e = int(params.get("embed_dim", 0) or 0)
    kdim = int(params.get("kdim", 0) or e)
    return {
        "backend": backend,
        "q_len": int(q_len),
        "kv_len": int(kv_len),
        "head_dim": kdim // max(h, 1),
        "num_heads": h,
        "num_kv_heads": int(params.get("num_kv_heads", 0) or h),
        "causal": bool(params.get("causal", False)),
        "sliding_window": int(params.get("sliding_window", 0) or 0),
        "dropout": float(params.get("dropout", 0.0) or 0.0)
        if dropout is None else float(dropout),
        "seq_degree": int(seq_degree),
        "kv_mode": kv_mode,
    }


def parse_forced(spec: str) -> Dict[str, str]:
    """Parse ``"attention:flash,opt_update:fused"`` into an op->impl map.
    Unknown ops/impls raise ValueError: a typo'd force fails loudly."""
    out: Dict[str, str] = {}
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part or part == "auto":
            continue
        if ":" not in part:
            raise ValueError(
                f"--kernel-impl takes <op>:<impl> pairs, got {part!r}")
        op, impl = (p.strip() for p in part.split(":", 1))
        if op not in REGISTRY:
            raise ValueError(
                f"unknown kernel op {op!r} (known: {sorted(REGISTRY)})")
        if impl not in REGISTRY[op]:
            raise ValueError(
                f"unknown impl {impl!r} for op {op!r} "
                f"(known: {sorted(REGISTRY[op])})")
        out[op] = impl
    return out


def resolve_forced(cfg) -> Dict[str, str]:
    """Forced op->impl choices. Precedence (later wins): the deprecated
    ``use_flash_attention`` shim < ``cfg.kernel_impls`` <
    ``FF_KERNEL_IMPL``. The shim maps "true"/"false" to a forced
    attention impl and warns; "auto" forces nothing."""
    forced: Dict[str, str] = {}
    legacy = getattr(cfg, "use_flash_attention", "auto") \
        if cfg is not None else "auto"
    if legacy in ("true", "false"):
        warnings.warn(
            "FFConfig.use_flash_attention is deprecated; use "
            "kernel_impls / --kernel-impl attention:<xla|flash|ring> "
            "(FF_KERNEL_IMPL works too)", DeprecationWarning,
            stacklevel=2)
        forced[ATTENTION] = "flash" if legacy == "true" else "xla"
    forced.update(parse_forced(getattr(cfg, "kernel_impls", "auto")
                               if cfg is not None else "auto"))
    forced.update(parse_forced(os.environ.get("FF_KERNEL_IMPL", "")))
    return forced
