"""Time design variants of the f32 tensor-core flash dq and dk/dv against
the tree's own kernels, in turns, on one GPU.

    python3 tools/torch_bwd_variants.py [--variants split_d,two_sweeps]
        [--shapes 1x8x512x64c,8x12x512x64,4x8x512x512]

Each variant is the committed ``csrc/flash_attention_bwd.cu`` with a few
lines replaced (VARIANTS below names them), built with the port's nvcc
flags into build/bwd_variants/<name>/ (git-ignored), all builds at once.
For each b x h x s x d shape (f32, causal where it ends in ``c``, no
dropout; lse and o of plain f32 attention, delta = rowsum(do * o)) it
times dk/dv and then dq of the tree and of every variant by CUDA-graph
replay (chip_smoke.cuda_time_ms) in the order tree, variants, variants
reversed, tree, checks that each variant's outputs agree with the tree's
(1e-4 absolute), and prints the two times of each. It first prints each
variant's f32 tensor-core instantiations with ptxas's registers, spill
stores and stack frame. The last line prints the card's name and power
limit. Imports only the port, never JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from flexflow_tpu_torch.kernels import build  # noqa: E402
from flexflow_tpu_torch.kernels.flash_attention import (_ARGTYPES,
                                                        _map_args)  # noqa: E402

CSRC = os.path.join(ROOT, "flexflow_tpu_torch", "csrc")
# name -> (what it is, [(committed text, its replacement, count)])
VARIANTS = {
    "tiles32": ("streamed tiles of 32 rows above d 320 (m64n32 score "
                "products)",
                [("measured slower: PERF.md sec. 6)\n"
                  "  static constexpr int BN = 64;",
                  "measured slower: PERF.md sec. 6)\n"
                  "  static constexpr int BN = D <= 320 ? 64 : 32;", 1)]),
    "unrolled": ("the score items' chunk loops fully unrolled, as the "
                 "gradient items' are",
                 [("#pragma unroll 1\n", "#pragma unroll\n", 4)]),
    # the d 64 / 128 kernels
    "split_d": ("d <= 128: D split between two warpgroups over 64 rows, "
                "as the wide kernels",
                [("static constexpr bool SPLIT_D = D > 128;",
                  "static constexpr bool SPLIT_D = true;", 1)]),
    "two_sweeps": ("d 64: dk/dv in two sweeps, dV then dK",
                   [("static constexpr bool ONE_SWEEP = D <= 64;",
                     "static constexpr bool ONE_SWEEP = false;", 1)]),
    "one_xbuf": ("one exchange buffer for the split score sums, two CTA "
                 "barriers a sum",
                 [("int X_BUFS = SPLIT_D && !P_STASH ? 2 : 1;",
                   "int X_BUFS = 1;", 1)]),
    "stages4": ("d <= 128: rings of four stages, three copies in flight",
                [("  static constexpr int NS = 3; ",
                  "  static constexpr int NS = D <= 128 ? 4 : 3; ", 1)]),
}
SYMS = ("ff_flash_attention_bwd_dkv", "ff_flash_attention_bwd_dq")


def build_variants(names):
    """name -> {symbol: ctypes function} for the tree and each variant."""
    procs = {}
    for name in ["tree", *names]:
        out = os.path.join(ROOT, "build", "bwd_variants", name)
        os.makedirs(out, exist_ok=True)
        for f in os.listdir(CSRC):
            with open(os.path.join(CSRC, f)) as fh:
                text = fh.read()
            if f == "flash_attention_bwd.cu" and name != "tree":
                for old, new, count in VARIANTS[name][1]:
                    assert text.count(old) == count, (name, old)
                    text = text.replace(old, new)
            with open(os.path.join(out, f), "w") as fh:
                fh.write(text)
        so = os.path.join(out, "flash_attention_bwd.so")
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so,
             os.path.join(out, "flash_attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        for kernel, regs, spills, frame in chip_smoke.ptxas_report(log):
            if "_tf32" in kernel:
                print(f"[variant] {name}: {kernel}: {regs} registers, "
                      f"{spills} bytes spill stores, {frame} bytes stack "
                      f"frame")
        lib = ctypes.CDLL(so)
        fns[name] = {}
        for sym in SYMS:
            fn = getattr(lib, sym)
            fn.argtypes = _ARGTYPES[("flash_attention_bwd", sym)]
            fn.restype = ctypes.c_int
            fns[name][sym] = fn
    return fns


def bwd_inputs(shape: str) -> tuple:
    """b, h, s, d, causal and seeded f32 (q, k, v, do, lse, delta) on the
    card for a shape "BxHxSxD", causal where it ends in "c": lse and o of
    plain f32 attention, delta = rowsum(do * o)."""
    causal = shape.endswith("c")
    b, h, s, d = (int(x) for x in shape.rstrip("c").split("x"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                   for _ in range(4))
    scores = torch.matmul(q, k.transpose(2, 3)) * d ** -0.5
    if causal:
        scores = scores.masked_fill(torch.ones(
            s, s, dtype=torch.bool, device="cuda").triu(1), -1e30)
    lse = torch.logsumexp(scores, -1)
    o = torch.matmul(torch.softmax(scores, -1), v)
    return b, h, s, d, causal, (q, k, v, do, lse, (do * o).sum(-1))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shapes", default="1x8x512x64c,1x8x512x128c,"
                    "8x12x512x64,8x12x512x128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    names = args.variants.split(",")
    for name in names:
        print(f"[variant] {name}: {VARIANTS[name][0]}")
    fns = build_variants(names)
    order = ["tree", *names, *names[::-1], "tree"]
    for shape in args.shapes.split(","):
        b, h, s, d, causal, (q, k, v, do, lse, delta) = bwd_inputs(shape)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        tail = [b * h, s, s, d, 0, int(causal), d ** -0.5, 0, 0, 1.0, 0,
                *_map_args(b, h, None)]
        for sym, outs in zip(SYMS, ((dk, dv), (dq,))):
            ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta, *outs)]
            us = {name: [] for name in ["tree", *names]}
            want = None
            for name in order:
                fn = fns[name][sym]

                def run(fn=fn):
                    err = fn(*ptrs, *tail,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: CUDA error {err}")

                run()
                torch.cuda.synchronize()
                got = [t.clone() for t in outs]
                if want is None:
                    want = got
                diff = max((g - w).abs().max().item()
                           for g, w in zip(got, want))
                if diff > 1e-4:
                    raise RuntimeError(f"{name} {sym} differs by {diff}")
                us[name].append(chip_smoke.cuda_time_ms(run) * 1e3)
            print(f"[variant] {sym} b{b} h{h} s{s} d{d} f32"
                  f"{' causal' if causal else ''}: " + ", ".join(
                f"{name} {sum(t) / 2:.2f} us ({t[0]:.2f}, {t[1]:.2f})"
                for name, t in us.items()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
