"""Time design variants of the f32 wide flash dq and dk/dv against the
tree's own kernels, in turns, on one GPU.

    python3 tools/torch_bwd_variants.py [--variants tiles32,unrolled]
        [--shapes 4x8x512x512,64x1x128x512]

Each variant is the committed ``csrc/flash_attention_bwd.cu`` with a few
lines replaced (VARIANTS below names them), built with the port's nvcc
flags into build/bwd_variants/<name>/ (git-ignored), all builds at once.
For each b x h x s x d shape (f32, not causal, no dropout; lse and o of
plain f32 attention, delta = rowsum(do * o)) it times dk/dv and then dq of
the tree and of every variant by CUDA-graph replay (chip_smoke.cuda_time_ms)
in the order tree, variants, variants reversed, tree, checks that each
variant's outputs agree with the tree's (1e-4 absolute), and prints the
two times of each. It first prints each variant's f32 wide instantiations
with ptxas's registers, spill stores and stack frame. The last line
prints the card's name and power limit. Imports only the port, never JAX.
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
from flexflow_tpu_torch.kernels.flash_attention import _ARGTYPES  # noqa: E402

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
    "dk_first": ("dk/dv's dK sweep before its dV sweep",
                 [("    const bool sweep2 = i >= count * ITEMS1;\n"
                   "    const int i2 = sweep2 ? i - count * ITEMS1 : i;",
                   "    const bool sweep2 = i < count * ITEMS2;\n"
                   "    const int i2 = sweep2 ? i : i - count * ITEMS2;", 1),
                  ("      const int it = (DK ? count : 0) + t;",
                   "      const int it = (DK ? 0 : count) + t;", 1),
                  ("  sweep(std::false_type());  // dV\n"
                   "  sweep(std::true_type());   // dK",
                   "  sweep(std::true_type());   // dK\n"
                   "  sweep(std::false_type());  // dV", 1)]),
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
            if "wide_tf32" in kernel:
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shapes", default="4x8x512x256,4x8x512x512,"
                    "64x1x128x512")
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
        b, h, s, d = (int(x) for x in shape.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                       for _ in range(4))
        scores = torch.matmul(q, k.transpose(2, 3)) * d ** -0.5
        lse = torch.logsumexp(scores, -1)
        o = torch.matmul(torch.softmax(scores, -1), v)
        delta = (do * o).sum(-1)
        del scores
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        tail = [b * h, s, s, d, 0, 0, d ** -0.5, 0, 0, 1.0, 0]
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
            print(f"[variant] {sym} b{b} h{h} s{s} d{d} f32: " + ", ".join(
                f"{name} {sum(t) / 2:.2f} us ({t[0]:.2f}, {t[1]:.2f})"
                for name, t in us.items()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
