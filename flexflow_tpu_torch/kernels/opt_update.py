"""Fused Adam update: a hand-written multi-tensor Hopper kernel and its
plain twin, the ``opt_update:fused`` kernel tier.

Port of ``flexflow_tpu/kernels/opt_update.py``. The CUDA kernel is
``csrc/adam_update.cu``, which replaces the Pallas ``_adam_kernel``; its
header says how it is laid out and what bounds it. Where the TPU kernel
runs once per parameter leaf, :func:`fused_adam_update` updates every
leaf it is given in one launch (up to the kernel's leaf limit, 384, per
launch), in place: w, m and v are overwritten, as the JAX package donates
their buffers. A device table of the leaves' pointers and sizes is built
once per parameter set and cached; the gradients' pointers, new every
step, ride in the kernel's arguments.

CUDA tensors launch the kernel (or raise) and count one in
``fused_adam_update.launches`` per launch; CPU tensors run
:func:`fused_adam_update_plain` on each leaf and count one in
``fused_adam_update.plain_calls`` per call. The two agree bit for bit on
the card (``chip_smoke.py``): both round every f32 operation once.
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Sequence

import torch

_W_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TABLES: "OrderedDict[tuple, tuple]" = OrderedDict()
_TABLE_CACHE = 4


def fused_adam_update_plain(w, g, m, v, alpha_t, *, beta1: float = 0.9,
                            beta2: float = 0.999, eps: float = 1e-8,
                            wd: float = 0.0):
    """One leaf's Adam step as the kernel computes it, in plain PyTorch:
    ``g += wd*w``; ``m' = beta1*m + (1-beta1)*g``; ``v' = beta2*v +
    (1-beta2)*g*g`` in f32; ``w' = w - cast_w(alpha_t*m'/(sqrt(v')+eps))``.
    ``alpha_t`` is an f32 scalar tensor. Returns new ``(w', m', v')``;
    m' and v' are f32, w' has w's dtype."""
    w32 = w.float()
    g32 = g.float() + wd * w32
    m2 = beta1 * m.float() + (1.0 - beta1) * g32
    v2 = beta2 * v.float() + (1.0 - beta2) * g32 * g32
    step = alpha_t * m2 / (torch.sqrt(v2) + eps)
    w2 = (w32 - step.to(w.dtype).float()).to(w.dtype)
    return w2, m2, v2


def _c_fn(sym: str):
    from .build import load
    fn = getattr(load("adam_update"), sym)
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if sym == "ff_adam_update":
            fn.argtypes = [P, P, P, I, P, I, P, F, F, F, F, F, F, P]
        else:
            fn.argtypes = []
        fn.restype = I
    return fn


def _table(ws, ms, vs, device):
    """The device table of one launch's leaves: per leaf (w, m, v, numel,
    dtype) as int64, and per block of the kernel its leaf and first
    element. Cached by the leaves' addresses and sizes, so a training
    loop that updates in place builds it once."""
    key = tuple((w.data_ptr(), m.data_ptr(), v.data_ptr(), w.numel(),
                 _W_DTYPES[w.dtype]) for w, m, v in zip(ws, ms, vs))
    hit = _TABLES.get(key)
    if hit is not None:
        _TABLES.move_to_end(key)
        return hit
    chunk = _c_fn("ff_adam_chunk")()
    leaves, block_leaf, block_start = [], [], []
    for i, (wp, mp, vp, n, dt) in enumerate(key):
        leaves.append([wp, mp, vp, n, dt])
        starts = range(0, n, chunk)
        block_leaf += [i] * len(starts)
        block_start += list(starts)
    table = (torch.tensor(leaves, dtype=torch.int64).to(device),
             torch.tensor(block_leaf, dtype=torch.int32).to(device),
             torch.tensor(block_start, dtype=torch.int64).to(device))
    _TABLES[key] = table
    while len(_TABLES) > _TABLE_CACHE:
        _TABLES.popitem(last=False)
    return table


def _check_leaves(ws, gs, ms, vs, alpha_t) -> None:
    if not (len(ws) == len(gs) == len(ms) == len(vs)):
        raise ValueError("w, g, m and v lists must have one entry per leaf")
    dev = alpha_t.device
    if alpha_t.dtype != torch.float32 or alpha_t.numel() != 1:
        raise TypeError("alpha_t must be a float32 scalar tensor")
    for w, g, m, v in zip(ws, gs, ms, vs):
        if w.dtype not in _W_DTYPES or g.dtype != w.dtype:
            raise TypeError(f"w and g must share a dtype of float32/"
                            f"bfloat16; got {w.dtype}, {g.dtype}")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError("m and v must be float32")
        if not (w.shape == g.shape and w.numel() == m.numel()
                == v.numel()):
            raise ValueError(f"leaf shapes differ: w {tuple(w.shape)}, g "
                             f"{tuple(g.shape)}, m {tuple(m.shape)}, v "
                             f"{tuple(v.shape)}")
        if any(t.device != dev for t in (w, g, m, v)):
            raise ValueError("every leaf must lie on alpha_t's device")
        if not all(t.is_contiguous() for t in (w, g, m, v)):
            raise ValueError("every leaf must be contiguous")


def fused_adam_update(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                      ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                      alpha_t: torch.Tensor, *, beta1: float = 0.9,
                      beta2: float = 0.999, eps: float = 1e-8,
                      wd: float = 0.0) -> None:
    """Adam step of every leaf, in place: ``ws[i]``, ``ms[i]`` and
    ``vs[i]`` are overwritten with w', m', v'. w and g are float32 or
    bfloat16 (one dtype per leaf), m and v float32, all contiguous and on
    ``alpha_t``'s device; ``alpha_t`` is the f32 bias-corrected step size
    as a device scalar."""
    _check_leaves(ws, gs, ms, vs, alpha_t)
    if not ws:
        return
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, wd=wd)
    if alpha_t.device.type == "cpu":
        with torch.no_grad():
            for w, g, m, v in zip(ws, gs, ms, vs):
                w2, m2, v2 = fused_adam_update_plain(w, g, m, v, alpha_t,
                                                     **kw)
                w.copy_(w2)
                m.copy_(m2.view(m.shape))
                v.copy_(v2.view(v.shape))
        fused_adam_update.plain_calls += 1
        return
    if alpha_t.device.type != "cuda":
        raise ValueError(f"fused_adam_update runs on cuda or cpu tensors, "
                         f"not {alpha_t.device}")
    fn = _c_fn("ff_adam_update")
    cap = _c_fn("ff_adam_max_leaves")()
    alpha = alpha_t.reshape(()).contiguous()
    stream = torch.cuda.current_stream(alpha.device).cuda_stream
    for lo in range(0, len(ws), cap):
        sl = slice(lo, lo + cap)
        leaves, block_leaf, block_start = _table(ws[sl], ms[sl], vs[sl],
                                                 alpha.device)
        gptr = [g.data_ptr() for g in gs[sl]]
        err = fn(leaves.data_ptr(), block_leaf.data_ptr(),
                 block_start.data_ptr(), block_leaf.numel(),
                 (ctypes.c_uint64 * len(gptr))(*gptr), len(gptr),
                 alpha.data_ptr(), float(beta1), float(1.0 - beta1),
                 float(beta2), float(1.0 - beta2), float(eps), float(wd),
                 stream)
        if err != 0:
            raise RuntimeError(f"adam_update launch failed: CUDA error "
                               f"{err}")
        fused_adam_update.launches += 1


fused_adam_update.launches = 0
fused_adam_update.plain_calls = 0
