"""Optimizers: SGD (+momentum/nesterov) and Adam.

The port of ``flexflow_tpu/runtime/optimizers.py``: the same
hyper-parameters under the same names and the same update math, over the
port's parameter trees (layer name -> weight name -> tensor). ``update``
works in place under ``torch.no_grad()`` where the JAX package donates its
buffers: each weight and moment is overwritten leaf by leaf, so a step
holds one leaf's temporaries at a time. It returns the (same) trees, as
the JAX ``update`` returns new ones. A moment whose dtype the math
promotes (the bf16 zeros ``init_state`` gives a bf16 weight) is replaced
by the promoted tensor, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


def tree_leaves(tree: Tree) -> Iterator[Tuple[str, str, torch.Tensor]]:
    """(layer, weight, tensor) of every leaf, in insertion order."""
    for lname, ws in tree.items():
        for wname, t in ws.items():
            yield lname, wname, t


def _zeros_like(tree: Tree) -> Tree:
    return {ln: {wn: torch.zeros_like(t) for wn, t in ws.items()}
            for ln, ws in tree.items()}


def _assign(tree: Tree, lname: str, wname: str, value: torch.Tensor):
    """Write ``value`` into the leaf in place when the dtypes agree, else
    replace the leaf."""
    cur = tree[lname][wname]
    if cur.dtype == value.dtype:
        cur.copy_(value)
    else:
        tree[lname][wname] = value


def _step_tensor(step, device) -> torch.Tensor:
    """The 1-based step as an f32 scalar on ``device`` (a fill, not a
    host-to-device copy)."""
    if isinstance(step, torch.Tensor):
        return step.to(device=device, dtype=torch.float32)
    return torch.full((), float(step), dtype=torch.float32, device=device)


def _device_of(params: Tree) -> torch.device:
    for _, _, t in tree_leaves(params):
        return t.device
    return torch.device("cpu")


class Optimizer:
    def init_state(self, params):
        raise NotImplementedError

    def update(self, params, grads, state, step):
        """Returns (new_params, new_state). ``step`` is 1-based."""
        raise NotImplementedError

    def next(self):  # reference Optimizer::next() parity (per-step hook)
        pass


class SGDOptimizer(Optimizer):
    """Reference ``SGDOptimizer`` (``optimizer_kernel.cu:77-100``):
    grad += wd*w;  v = momentum*v + grad;  (nesterov: grad +=
    momentum*v);  w -= lr * (grad or v)."""

    def __init__(self, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def init_state(self, params):
        if self.momentum == 0.0:
            return {}
        return {"v": _zeros_like(params)}

    @torch.no_grad()
    def update(self, params, grads, state, step):
        lr, wd = self.lr, self.weight_decay
        for lname, wname, w in tree_leaves(params):
            g = grads[lname][wname] + wd * w
            if self.momentum == 0.0:
                w.sub_((lr * g).to(w.dtype))
                continue
            v = self.momentum * state["v"][lname][wname] + g
            step_dir = g + self.momentum * v if self.nesterov else v
            w.sub_((lr * step_dir).to(w.dtype))
            _assign(state["v"], lname, wname, v)
        return params, state


class AdamOptimizer(Optimizer):
    """Reference ``AdamOptimizer`` (``optimizer.cc:449``,
    ``optimizer_kernel.cu:196``): bias-corrected alpha_t, weight decay
    folded into the gradient (L2 style, as the reference does)."""

    def __init__(self, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 epsilon: float = 1e-8):
        self.alpha = alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.weight_decay = weight_decay
        self.epsilon = epsilon

    @property
    def lr(self):
        return self.alpha

    def init_state(self, params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    def alpha_t(self, step, device) -> torch.Tensor:
        """The bias-corrected step size ``alpha * sqrt(1 - beta2**t) /
        (1 - beta1**t)`` as an f32 scalar computed on ``device`` from the
        1-based step."""
        t = _step_tensor(step, device)
        return self.alpha * torch.sqrt(1.0 - self.beta2 ** t) \
            / (1.0 - self.beta1 ** t)

    @torch.no_grad()
    def update(self, params, grads, state, step):
        alpha_t = self.alpha_t(step, _device_of(params))
        b1, b2, wd = self.beta1, self.beta2, self.weight_decay
        for lname, wname, w in tree_leaves(params):
            g = (grads[lname][wname] + wd * w).float()
            m = b1 * state["m"][lname][wname] + (1 - b1) * g
            v = b2 * state["v"][lname][wname] + (1 - b2) * g * g
            w.sub_((alpha_t * m / (torch.sqrt(v) + self.epsilon))
                   .to(w.dtype))
            _assign(state["m"], lname, wname, m)
            _assign(state["v"], lname, wname, v)
        return params, state


def fused_adam_leaves(opt: AdamOptimizer, ws, gs, ms, vs, step) -> None:
    """Adam update of any set of leaves through the fused multi-tensor
    kernel (``kernels/opt_update.py``): one launch for up to the kernel's
    384 leaves, in place. The leaves may be whole weights or the blocks
    of ZeRO-sharded state (each rank's block of a weight, gradient and
    moments), each contiguous; m and v are f32."""
    from ..kernels.opt_update import fused_adam_update
    if not ws:
        return
    alpha_t = opt.alpha_t(step, ws[0].device)
    with torch.no_grad():
        fused_adam_update(list(ws), [g.contiguous() for g in gs], list(ms),
                          list(vs), alpha_t, beta1=opt.beta1,
                          beta2=opt.beta2, eps=opt.epsilon,
                          wd=opt.weight_decay)


def fused_adam_tree_update(opt: AdamOptimizer, params, grads, state, step):
    """Adam update of every leaf of a tree through the fused kernel
    (:func:`fused_adam_leaves`), selected by the kernel tier
    (``opt_update: fused``): one launch for the whole tree where the JAX
    package launches its Pallas kernel per leaf. The update math is that
    of ``AdamOptimizer.update`` for f32 weights; the kernel folds weight
    decay after the cast to f32, as the JAX kernel does. In place; the
    moments become f32 first if they are not."""
    ws, gs, ms, vs = [], [], [], []
    for lname, wname, w in tree_leaves(params):
        for slot in ("m", "v"):
            if state[slot][lname][wname].dtype != torch.float32:
                state[slot][lname][wname] = \
                    state[slot][lname][wname].float()
        ws.append(w)
        gs.append(grads[lname][wname])
        ms.append(state["m"][lname][wname])
        vs.append(state["v"][lname][wname])
    fused_adam_leaves(opt, ws, gs, ms, vs, step)
    return params, state
