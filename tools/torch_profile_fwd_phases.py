"""Where the time of the f32 wide flash forward goes, phase by phase, on
one GPU.

    python3 tools/torch_profile_fwd_phases.py [--shapes 4x8x512x256,...]

There is no ncu on the card's machine, so this builds an instrumented
copy of ``csrc/flash_attention_fwd.cu`` into build/profile_fwd/ (git-
ignored): ``flash_fwd_wgmma_wide_tf32_kernel`` gains clock64() counters
that thread 0 of each warpgroup sums per phase of each ring item (a Q/K
chunk of S or a V chunk of P.V) and of each key tile, and adds to a
device array at the end of the CTA. The committed source is not changed.
For each b x h x s x d shape (f32, not causal, no dropout) it prints the
eager time per launch and the share of a warpgroup's clocks (both
warpgroups summed) in: the wait for a chunk's TMA copies, the K split
or V transposition (with Q's A fragments), the proxy fence and the
warpgroup's barrier, the chunk's products issued and waited for, the
exchange of the partial score tiles (two CTA barriers), the softmax and
P's fragments, and the rest (prologue, the loop's own work). A counter
charges a stall to the phase where the warp waits, so a phase's share is
where time passes, not what causes it. The last line prints the card's
name and power limit. Imports only the port, never JAX.
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
from flexflow_tpu_torch.kernels.flash_attention import (_ARGTYPES,
                                                        _map_args)  # noqa: E402

PHASES = ["TMA wait", "split", "fence + barrier", "products", "exchange",
          "softmax", "other"]
KERNEL = "flash_fwd_wgmma_wide_tf32_kernel("

# (anchor in the kernel's body, how often it occurs, the phases whose
# counters are read before it, and after it): "other" (6) is read as an
# item starts, so it holds the loop's own work between items
MARKS = [
    ("      mbar_wait(bar(i), (i / NS) & 1);\n", 2, [6], [0]),
    ("      q_frags_tf32(sQ, warp, g, tig, qh, ql);\n", 1, [], [1]),
    ("      split_transpose_v<CW, BN>(sV, vt_hi, vt_lo, wtid);\n", 1, [],
     [1]),
    ("      named_barrier(1 + wg, WG_THREADS);\n", 2, [], [2]),
    ("      fence_acc(s);\n", 1, [], [3]),
    ("      fence_acc(oc);\n", 1, [], [3]),
    ("    exchange_add(xbuf, wg, wtid, s);\n    __syncthreads();\n", 1, [],
     [4]),
    ("    tf32_a_frags(s, ph, pl);\n", 1, [], [5]),
]


def instrument(src: str) -> str:
    """The forward source with the phase counters in the wide f32
    kernel."""
    head = ('__device__ unsigned long long g_prof[8];\n'
            'extern "C" int ff_prof_read(unsigned long long* out) {\n'
            '  return (int)cudaMemcpyFromSymbol(out, g_prof, '
            'sizeof(g_prof));\n}\n'
            'extern "C" int ff_prof_zero() {\n'
            '  unsigned long long z[8] = {0};\n'
            '  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n')
    k0 = src.index("template <int D, bool DROPOUT>\n__global__ void "
                   "__launch_bounds__(Tf32WideTiles<D>::THREADS, 1)\n    "
                   + KERNEL)
    k1 = src.index("\n}\n", k0)
    body = src[k0:k1]
    start = "  int i = 0;\n"
    assert body.count(start) == 1, "item counter not found"
    body = body.replace(
        start, "  unsigned long long pr[7] = {};\n"
        "  long long tc = clock64();\n  const long long t0 = tc;\n"
        "#define FF_T(i) { const long long n_ = clock64(); pr[i] += n_ - tc;"
        " tc = n_; }\n" + start, 1)
    for anchor, count, before, after in MARKS:
        assert body.count(anchor) == count, f"anchor {anchor!r} not found"
        body = body.replace(anchor, "".join(
            f"      FF_T({i})\n" for i in before) + anchor + "".join(
            f"      FF_T({i})\n" for i in after))
    end = body.index("  // o = acc / l")
    body = (body[:end] + "  FF_T(6)\n  if (wtid == 0) {\n"
            "    for (int n = 0; n < 7; ++n) atomicAdd(&g_prof[n], pr[n]);\n"
            "    atomicAdd(&g_prof[7], "
            "(unsigned long long)(clock64() - t0));\n  }\n" + body[end:])
    return (src[:k0].replace("namespace {", head + "namespace {", 1) + body
            + src[k1:])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="4x8x512x192,4x8x512x256,"
                    "4x8x512x512,64x1x128x512")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = os.path.join(ROOT, "build", "profile_fwd")
    os.makedirs(os.path.join(out, "csrc"), exist_ok=True)
    csrc = os.path.join(ROOT, "flexflow_tpu_torch", "csrc")
    for name in os.listdir(csrc):
        with open(os.path.join(csrc, name)) as f:
            text = f.read()
        if name == "flash_attention_fwd.cu":
            text = instrument(text)
        with open(os.path.join(out, "csrc", name), "w") as f:
            f.write(text)
    so = os.path.join(out, "flash_attention_fwd_prof.so")
    nvcc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so,
                           os.path.join(out, "csrc",
                                        "flash_attention_fwd.cu")],
                          capture_output=True, text=True)
    if nvcc.returncode:
        print(nvcc.stdout, nvcc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    fn = lib.ff_flash_attention_fwd
    fn.argtypes = _ARGTYPES[("flash_attention_fwd", "ff_flash_attention_fwd")]
    fn.restype = ctypes.c_int
    for shape in args.shapes.split(","):
        b, h, s, d = (int(x) for x in shape.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                   for _ in range(3))
        o = torch.empty_like(q)
        lse = torch.empty(b, h, s, device="cuda")
        cargs = [t.data_ptr() for t in (q, k, v, o, lse)] \
            + [b * h, s, s, d, 0, 0, d ** -0.5, 0, 0, 1.0, 0,
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
        prof = (ctypes.c_ulonglong * 8)()
        lib.ff_prof_read(prof)
        shares = ", ".join(f"{n} {prof[i] / prof[7]:.3f}"
                           for i, n in enumerate(PHASES))
        print(f"b{b} h{h} s{s} d{d} f32: {us:.2f} us per launch (eager, "
              f"instrumented); {shares}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
