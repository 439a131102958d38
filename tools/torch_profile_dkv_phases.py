"""Where the time of the wide bf16 dk/dv kernel goes, phase by phase, on
one GPU.

    python3 tools/torch_profile_dkv_phases.py [--shapes 4x8x512x256,...]

There is no ncu on the card's machine, so this builds an instrumented
copy of ``csrc/flash_attention_bwd.cu`` into build/profile_dkv/ (git-
ignored): ``flash_bwd_dkv_wgmma_wide_kernel`` gains clock64() counters
that thread 0 of each warpgroup sums per phase of each query tile and
adds to a device array at the end of the CTA. The committed source is
not changed. For each b x h x s x d shape (bf16, not causal, no dropout)
it prints the eager time per launch and, for each warpgroup, the share
of its clocks in: the wait for its cp.async copies of the tile, the
proxy fence, the CTA barrier, the start of the next tile's copies, the
score products s^T (and dp^T, with the partial-tile exchange where the
warpgroups split d), the softmax / ds arithmetic, and the dV or dK
product. A counter charges a stall to the phase where the warp waits, so
a phase's share is where time passes, not what causes it. The last line
prints the card's name and power limit. Imports only the port, never
JAX.
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

from flexflow_tpu_torch.kernels import build  # noqa: E402
from flexflow_tpu_torch.kernels.flash_attention import (  # noqa: E402
    _ARGTYPES, _map_args, flash_attention)

PHASES = ["cp.async wait", "proxy fence", "barrier", "copy start",
          "scores (+exchange)", "softmax/ds", "dV/dK product"]
KERNEL = "flash_bwd_dkv_wgmma_wide_kernel("

# (anchor in the kernel's body, phase): phase i is timed from the previous
# mark to the one after its anchor; the scores phase ends after the
# if/else that holds both the wait and, where d is split, the exchange
MARKS = [
    ("      cp_async_wait<0>();  // q tile it (and, first, K and V) have "
     "landed\n", 0),
    ("      fence_proxy_async();\n", 1),
    ("                        // other warpgroup's partials\n", 2),
    ("      if (it + 1 < 2 * count) load_q(it + 1);\n"
     "      cp_async_commit();\n", 3),
    ("        if (sweep == 1) exchange_add(xdp, wg, wtid, dp);\n"
     "      }\n", 4),
    ("      uint32_t fa[NB / 2][4];\n", 5),
    ("      for (int h = 0; h < Sp::MAX_BLOCKS; ++h) fence_regs("
     "acc_block(acc, h));\n", 6),
]


def instrument(src: str) -> str:
    """The bwd source with the phase counters in the wide dk/dv kernel."""
    head = ('__device__ unsigned long long g_prof[16];\n'
            'extern "C" int ff_prof_read(unsigned long long* out) {\n'
            '  return (int)cudaMemcpyFromSymbol(out, g_prof, '
            'sizeof(g_prof));\n}\n'
            'extern "C" int ff_prof_zero() {\n'
            '  unsigned long long z[16] = {0};\n'
            '  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n')
    k0 = src.index("template <int D, bool DROPOUT>\n__global__ void "
                   "__launch_bounds__(WideSplit<D>::THREADS, 1)\n    "
                   + KERNEL)
    body = src[k0:]
    # the counters go before the sweep loop's unroll pragma: between the
    # two the pragma would fall on them and leave the loop rolled
    start = ("#pragma unroll\n"
             "  for (int sweep = 0; sweep < 2; ++sweep) {  // 0: dv, 1: dk\n")
    assert body.count(start) == 1, "sweep loop not found"
    body = body.replace(
        start, "  unsigned long long pr[8] = {};\n"
        "  long long tc = clock64();\n  const long long t0 = tc;\n"
        "#define FF_T(i) { const long long n_ = clock64(); pr[i] += n_ - tc;"
        " tc = n_; }\n" + start, 1)
    for anchor, i in MARKS:
        assert body.count(anchor) == 1, f"anchor {i} not found"
        body = body.replace(anchor, anchor + f"      FF_T({i})\n", 1)
    end = body.index("\n}\n", body.index("// this sweep's output"))
    body = (body[:end] + "\n  if (threadIdx.x % WG_THREADS == 0) {\n"
            "    const int o = 8 * (threadIdx.x / WG_THREADS);\n"
            "    for (int i = 0; i < 7; ++i) atomicAdd(&g_prof[o + i], "
            "pr[i]);\n"
            "    atomicAdd(&g_prof[o + 7], "
            "(unsigned long long)(clock64() - t0));\n  }" + body[end:])
    return src[:k0].replace("namespace {", head + "namespace {", 1) + body


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="4x8x512x256,4x8x512x320,"
                    "4x8x512x384,4x8x512x512,64x1x128x512,4x8x512x192")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = os.path.join(ROOT, "build", "profile_dkv")
    os.makedirs(os.path.join(out, "csrc"), exist_ok=True)
    csrc = os.path.join(ROOT, "flexflow_tpu_torch", "csrc")
    for name in os.listdir(csrc):
        with open(os.path.join(csrc, name)) as f:
            text = f.read()
        if name == "flash_attention_bwd.cu":
            text = instrument(text)
        with open(os.path.join(out, "csrc", name), "w") as f:
            f.write(text)
    so = os.path.join(out, "flash_attention_bwd_prof.so")
    nvcc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so,
                           os.path.join(out, "csrc",
                                        "flash_attention_bwd.cu")],
                          capture_output=True, text=True)
    if nvcc.returncode:
        print(nvcc.stdout, nvcc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    fn = lib.ff_flash_attention_bwd_dkv
    fn.argtypes = _ARGTYPES[("flash_attention_bwd",
                             "ff_flash_attention_bwd_dkv")]
    fn.restype = ctypes.c_int
    for shape in args.shapes.split(","):
        b, h, s, d = (int(x) for x in shape.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(b, h, s, d, device="cuda",
                                   dtype=torch.bfloat16, generator=gen)
                       for _ in range(4))
        o, lse = flash_attention(q, k, v, return_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        cargs = [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)] \
            + [b * h, s, s, d, 1, 0, d ** -0.5, 0, 0, 1.0, 0,
               *_map_args(b, h, None)]

        def launch():
            err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        lib.ff_prof_zero()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            launch()
        end.record()
        torch.cuda.synchronize()
        us = start.elapsed_time(end) / args.iters * 1e3
        prof = (ctypes.c_ulonglong * 16)()
        lib.ff_prof_read(prof)
        for wg in range(2):
            tot = prof[8 * wg + 7]
            shares = ", ".join(f"{n} {prof[8 * wg + i] / tot:.3f}"
                               for i, n in enumerate(PHASES))
            print(f"b{b} h{h} s{s} d{d} bf16, warpgroup {wg}: {us:.2f} us "
                  f"per launch (eager); {shares}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
