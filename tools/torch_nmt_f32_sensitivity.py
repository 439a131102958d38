"""Where NMT's f32 training through the flash kernels parts from plain
attention, in the PyTorch port.

    python3 tools/torch_nmt_f32_sensitivity.py [--rows 64] [--seq 128]
        [--steps 3] [--device cuda|cpu] [--parts grads,attention,step,fit]

Builds ``build_nmt`` at NMTConfig's widths (vocab 32,000, embed and LSTM
hidden 512, one attention head of 512) in f32 (``use_bf16_compute =
False``) twice from the same seeded weights, once with ``attention:
flash`` and once with ``attention: xla`` (the op's plain products), and
takes ``chip_smoke.py``'s zoo batch (seed 71). Parts:

- ``grads``: how many tokens' target outputs lie inside the loss's
  clamp; every leaf's gradient of one step's loss, each path twice
  (is a path deterministic?), the two paths against each other, and the
  flash path against itself with noise of 1e-7 of the largest |o| added
  to the attention output, worst leaf first;
- ``attention``: the attention's own inputs and output gradient, caught
  in that step, through the flash wrapper (forward, dq, dk/dv) and
  through f32 autograd of the plain products, each against float64;
- ``step``: one Adam step (alpha 1e-4, epsilon 1e-4, as the zoo) of each
  path's gradients from the same weights, the loss after it, and the
  loss after the flash path's step with one leaf's update taken from the
  plain path instead, for every leaf: which leaf moves the second loss;
- ``fit``: ``--steps`` free-running steps of each path through
  ``FFModel.fit``, and of the flash path with noise of 1e-7 and 1e-5 of
  the largest |o| added to the attention output.

Imports only the port; on the card (the default where there is one) the
flash path runs the kernels.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch import models as zoo  # noqa: E402

fa = importlib.import_module("flexflow_tpu_torch.kernels.flash_attention")


def build(impl: str, rows: int, seq: int, device: str) -> FFModel:
    cfg = FFConfig()
    cfg.batch_size = rows
    cfg.only_data_parallel = True
    cfg.kernel_impls = impl
    cfg.use_bf16_compute = False
    cfg.seed = 0
    ff = FFModel(cfg, device=device)
    out = zoo.build_nmt(ff, rows, seq, seq, zoo.NMTConfig())
    ff.compile(AdamOptimizer(1e-4, epsilon=1e-4),
               "sparse_categorical_crossentropy", [], output_tensor=out)
    return ff


def clone(tree) -> dict:
    return {ln: {n: t.detach().clone() for n, t in d.items()}
            for ln, d in tree.items()}


def leaves(tree):
    return [(f"{ln}.{n}", t) for ln, d in tree.items() for n, t in d.items()]


def rel(a, b) -> tuple:
    """max|a - b| / max|b| and ||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    d = a - b
    return (float(d.abs().max() / b.abs().max().clamp_min(1e-300)),
            float(d.norm() / b.norm().clamp_min(1e-300)))


def part_grads(ffs, batch, cap):
    """Each path's gradients twice and the flash path's once more with
    noise on o; the flash path's first run catches the attention's q, k,
    v and output gradient into ``cap``."""
    grads = {}
    for tag, ff, noise in (("flash", ffs["flash"], 0.0),
                           ("xla", ffs["xla"], 0.0),
                           ("noise", ffs["flash"], 1e-7)):
        runs = []
        for i in range(1 if noise else 2):
            cap["on"] = tag == "flash" and i == 0
            cap["noise"] = noise
            g, _, bm = ff.executor._grads(ff.params, ff.state, batch, 0)
            runs.append(g)
            cap["on"], cap["noise"] = False, 0.0
        grads[tag] = runs
        print(f"[grads] {tag}: loss {float(bm['loss']):.7f}", flush=True)
    # NMT's graph ends in a dense layer, so sparse CE takes log(clamp(out,
    # 1e-10, 1)): a token whose target output lies inside the clamp adds
    # -1 / (N out) to that output's gradient
    out = ffs["flash"].executor.make_eval_step()(
        ffs["flash"].params, ffs["flash"].state, batch)[0]
    tgt = torch.gather(out.float(), -1, batch["label"].reshape(
        out.shape[:-1] + (1,)).long())[..., 0]
    live = tgt[(tgt > 1e-10) & (tgt < 1.0)]
    n = tgt.numel()
    print(f"[grads] target outputs inside the clamp (1e-10, 1): "
          f"{live.numel()} of {n} tokens, smallest {float(live.min()):.3e}"
          f", so gradient terms -1 / (N out) up to "
          f"{1.0 / (n * float(live.min())):.3e}; outputs below 1e-10 "
          f"{int((tgt <= 1e-10).sum())}", flush=True)
    rows = []
    for (name, gf), (_, gf2), (_, gx), (_, gx2), (_, gn) in zip(
            leaves(grads["flash"][0]), leaves(grads["flash"][1]),
            leaves(grads["xla"][0]), leaves(grads["xla"][1]),
            leaves(grads["noise"][0])):
        rows.append((rel(gf, gx)[1], name, float(gx.abs().max()),
                     float(gx.norm()), rel(gf2, gf)[1], rel(gx2, gx)[1],
                     *rel(gf, gx), rel(gn, gf)[1]))
    print("[grads] leaf: max|g|, ||g|| (plain); ||diff|| / ||g|| flash vs "
          "flash, plain vs plain; flash vs plain max-rel, norm-rel; flash "
          "with noise 1e-7 of max|o| vs flash norm-rel (worst first)")
    for r, name, gmax, gnorm, ff_, xx, mrel, nrel, nz in sorted(
            rows, reverse=True):
        print(f"[grads] {name}: {gmax:.3e}, {gnorm:.3e}; {ff_:.3e}, "
              f"{xx:.3e}; {mrel:.3e}, {nrel:.3e}; {nz:.3e}", flush=True)
    return grads


def part_attention(cap):
    """The caught attention through the wrapper and through f32 autograd,
    each against float64."""
    q, k, v, do = (cap[n] for n in ("q", "k", "v", "do"))
    kw = cap["kw"]
    scale = 1.0 / math.sqrt(q.shape[-1])

    def plain(dt):
        qq, kk, vv = (t.to(dt, copy=True).requires_grad_(True)
                      for t in (q, k, v))
        s = qq @ kk.transpose(-1, -2) * scale
        o = torch.softmax(s, -1) @ vv
        grads = torch.autograd.grad(o, (qq, kk, vv), do.to(dt))
        return (o.detach(), torch.logsumexp(s, -1).detach(), *grads)

    ref = plain(torch.float64)
    f32 = plain(torch.float32)
    with torch.no_grad():
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    delta = (do * o).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    print(f"[attention] b{q.shape[0]} h{q.shape[1]} sq{q.shape[2]} "
          f"sk{k.shape[2]} d{q.shape[3]} {q.dtype} {kw}: max|q| "
          f"{float(q.abs().max()):.3e}, max|k| {float(k.abs().max()):.3e}, "
          f"max|v| {float(v.abs().max()):.3e}, max|do| "
          f"{float(do.abs().max()):.3e}")
    print("[attention] tensor: flash wrapper vs float64, f32 autograd vs "
          "float64 (max-rel, norm-rel)")
    for name, a, b, r in zip(("o", "lse", "dq", "dk", "dv"),
                             (o, lse, dq, dk, dv), f32, ref):
        print(f"[attention] {name}: {rel(a, r)[0]:.3e}, {rel(a, r)[1]:.3e}; "
              f"{rel(b, r)[0]:.3e}, {rel(b, r)[1]:.3e}", flush=True)


def part_step(ffs, grads, p0, batch):
    """One Adam step of each path's gradients from p0; the second loss
    through the flash path with each leaf's update swapped in turn."""
    opt = ffs["flash"].optimizer

    def loss(params, ff=ffs["flash"]):
        return float(ff.executor.make_eval_step()(params, ff.state,
                                                  batch)[1]["loss"])

    p1 = {}
    for tag in ffs:
        p = clone(p0)
        opt.update(p, grads[tag][0], opt.init_state(p), 1)
        p1[tag] = p
    base = loss(p1["flash"])
    print(f"[step] second loss: flash step, flash forward {base:.7f}; plain "
          f"step, flash forward {loss(p1['xla']):.7f}; plain step, plain "
          f"forward {loss(p1['xla'], ffs['xla']):.7f}")
    rows = []
    for (name, _), (ln, d) in zip(
            leaves(p0), ((ln, n) for ln, dd in p0.items() for n in dd)):
        p = dict(p1["flash"])
        p[ln] = dict(p[ln])
        p[ln][d] = p1["xla"][ln][d]
        u_f = p1["flash"][ln][d] - p0[ln][d]
        u_x = p1["xla"][ln][d] - p0[ln][d]
        dl = loss(p) - base
        rows.append((abs(dl), name, dl, *rel(u_f, u_x)))
    print("[step] leaf: second loss with this leaf's plain update minus "
          "the flash step's; update flash vs plain (max-rel, norm-rel)")
    for _, name, dl, mrel, nrel in sorted(rows, reverse=True):
        print(f"[step] {name}: {dl:+.3e}; {mrel:.3e}, {nrel:.3e}",
              flush=True)


def part_fit(args, p0, xs, y):
    """Free-running histories: each path, and flash with noise on o."""
    orig = fa.flash_attention
    noise = {"rel": 0.0}

    @functools.wraps(orig)   # the wrapper's counters live on it
    def noisy(q, k, v, **kw):
        o = orig(q, k, v, **kw)
        if noise["rel"]:
            gen = torch.Generator(device=o.device).manual_seed(1)
            o = o + noise["rel"] * o.detach().abs().max() * torch.randn(
                o.shape, generator=gen, device=o.device)
        return o

    fa.flash_attention = noisy
    first = None
    try:
        for impl, r in (("flash", 0.0), ("xla", 0.0), ("flash", 1e-7),
                        ("flash", 1e-5)):
            noise["rel"] = r
            ff = build(f"attention:{impl}", args.rows, args.seq, args.device)
            ff.params = clone(p0)
            losses = [h["loss"] for h in ff.fit(xs, y, epochs=args.steps,
                                                 verbose=False)]
            first = first or losses
            diff = max(abs(a - b) for a, b in zip(losses, first))
            print(f"[fit] {impl}, noise {r:.0e} of max|o|: loss "
                  f"{[round(v, 7) for v in losses]}; max|diff| from flash "
                  f"{diff:.3e}", flush=True)
    finally:
        fa.flash_attention = orig


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available()
                    else "cpu")
    ap.add_argument("--parts", default="grads,attention,step,fit")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    torch.backends.cuda.matmul.allow_tf32 = False
    nc = zoo.NMTConfig()
    rng = np.random.default_rng(71)
    src = rng.integers(0, nc.src_vocab, (args.rows, args.seq)) \
        .astype(np.int32)
    tgt = rng.integers(1, nc.tgt_vocab, (args.rows, args.seq)) \
        .astype(np.int32)
    xs = [src, np.concatenate([np.zeros((args.rows, 1), np.int32),
                               tgt[:, :-1]], axis=1)]
    ffs = {impl: build(f"attention:{impl}", args.rows, args.seq,
                       args.device) for impl in ("flash", "xla")}
    p0 = clone(ffs["flash"].params)
    ffs["xla"].params = clone(p0)
    batch = next(iter(ffs["flash"]._combined_loader(xs, tgt,
                                                     shuffle=False)))
    cap = {"on": False, "noise": 0.0}
    orig = fa.flash_attention

    @functools.wraps(orig)
    def catch(q, k, v, **kw):
        o = orig(q, k, v, **kw)
        if cap["noise"]:
            gen = torch.Generator(device=o.device).manual_seed(1)
            o = o + cap["noise"] * o.detach().abs().max() * torch.randn(
                o.shape, generator=gen, device=o.device)
        if cap["on"] and o.requires_grad:
            cap.update(q=q.detach().clone(), k=k.detach().clone(),
                       v=v.detach().clone(), kw=kw)
            o.register_hook(lambda g: cap.__setitem__(
                "do", g.detach().clone(memory_format=torch.contiguous_format)))
        return o

    fa.flash_attention = catch
    try:
        grads = None
        if parts & {"grads", "attention", "step"}:
            grads = part_grads(ffs, batch, cap)
    finally:
        fa.flash_attention = orig
    if "attention" in parts and "do" in cap:
        part_attention(cap)
    if "step" in parts:
        part_step(ffs, grads, p0, batch)
    if "fit" in parts:
        part_fit(args, p0, xs, tgt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
