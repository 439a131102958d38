"""Where the time of the f32 wide flash dq and dk/dv goes, phase by phase,
on one GPU.

    python3 tools/torch_profile_bwd_phases.py [--shapes 4x8x512x256,...]

There is no ncu on the card's machine, so this builds an instrumented
copy of ``csrc/flash_attention_bwd.cu`` into build/profile_bwd/ (git-
ignored): ``flash_bwd_dq_wgmma_wide_tf32_kernel`` and
``flash_bwd_dkv_wgmma_wide_tf32_kernel`` gain clock64() counters that
thread 0 of each warpgroup sums per phase of each ring item (a score
chunk or a gradient chunk) and of each streamed tile, and adds to a
device array at the end of the CTA. The committed source is not changed.
For each b x h x s x d shape (f32, not causal, no dropout) it prints each
kernel's eager time per launch and the share of a warpgroup's clocks
(both warpgroups summed) in: the wait for an item's TMA copies, the split
(the streamed chunk split in place and the owned chunk's fragments, or
the transposition), the proxy fence, the warpgroup's barrier and the next
copy's issue, the products issued and waited for, the f32 sum of a
chunk's partial (scores into shared memory, gradients into registers),
the exchange of the partial score tiles (two CTA barriers), the softmax,
ds and the fragments, and the rest (prologue, lse and delta, the loops'
own work, the output). A counter charges a stall to the phase where the
warp waits, so a phase's share is where time passes, not what causes it.
Beside the shares: the mean clocks of a CTA, the SM clock they imply
over the launch (the CTAs' clocks over the launch time and the SMs they
occupy: a low one means throttled or idle SMs), and dk/dv's share in its
second sweep (dK), whose phase shares follow on a line of their own. The last line prints the card's name and power limit.
Imports only the port, never JAX.
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
from flexflow_tpu_torch.kernels.flash_attention import _ARGTYPES  # noqa: E402

PHASES = ["TMA wait", "split", "fence + barrier", "products", "f32 sum",
          "exchange", "softmax + ds", "other"]
KERNELS = ("flash_bwd_dq_wgmma_wide_tf32_kernel(",
           "flash_bwd_dkv_wgmma_wide_tf32_kernel(")
# (a line of the helpers' bodies, by a piece of it, how often it occurs
# there, the phases whose counters are read before the line, and after it)
HELPER_MARKS = [
    ("mbar_wait(bar, parity);", 2, [7], [0]),
    ("q_frags_tf32(st, warp, g, tig, ah, al);", 1, [], [1]),
    ("split_transpose_v<CW, Tl::BN>(sB, t_hi, t_lo, wtid);", 1, [], [1]),
    ("  next();", 2, [], [2]),
    ("fence_acc(t);", 2, [], [3]),
    ("partial_add(part, wg, wtid, t, first);", 1, [], [4]),
    ("oc[dt][c] += t[dt][c];", 1, [], [4]),
]
# the same in the kernels' bodies (both kernels): each exchange of partial
# score tiles, the softmax up to the next product, ds up to the gradient
# fragments
KERNEL_MARKS = [
    ("exchange_sum(xbuf, wg, wtid, ", [7], [5]),
    ("// dP = dO . V^T, the same way", [6], []),
    ("if constexpr (DK) {", [6], []),
    ("tf32_a_frags(", [], [6]),
]


def mark(body: str, marks, where: str) -> str:
    """body with a counter read (FF_T) on its own line before and after
    each marked line."""
    lines = body.split("\n")
    out = []
    for ln in lines:
        hit = [m for m in marks if m[0] in ln]
        out += [f"FF_T({i})" for m in hit for i in m[-2]] + [ln] \
            + [f"FF_T({i})" for m in hit for i in m[-1]]
    for m in marks:
        n = sum(m[0] in ln for ln in lines)
        assert n >= 1 and (len(m) < 4 or n == m[1]), (where, m[0], n)
    return "\n".join(out)


def instrument(src: str) -> str:
    """The backward source with the phase counters in both f32 wide
    kernels."""
    head = ('__device__ unsigned long long g_prof[3][10];\n'
            'extern "C" int ff_prof_read(unsigned long long* out) {\n'
            '  return (int)cudaMemcpyFromSymbol(out, g_prof, '
            'sizeof(g_prof));\n}\n'
            'extern "C" int ff_prof_zero() {\n'
            '  unsigned long long z[30] = {0};\n'
            '  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n'
            '#define FF_T(i) { const long long n_ = clock64(); '
            'pr[i] += n_ - tc; tc = n_; }\n')
    src = src.replace("namespace {", head + "namespace {", 1)
    # the helpers take the counters from their kernel
    k0 = src.index("__device__ __forceinline__ void tf32_score_item(")
    k1 = src.index("\n}\n", src.index(
        "__device__ __forceinline__ void tf32_grad_item(")) + 1
    helpers = src[k0:k1].replace(
        "Next&& next) {", "Next&& next, unsigned long long* pr, "
        "long long& tc) {")
    assert helpers.count("long long& tc) {") == 2, "helper signatures"
    src = src[:k0] + mark(helpers, HELPER_MARKS, "helpers") + src[k1:]
    for kind, kernel in enumerate(KERNELS):
        k0 = src.index(kernel)
        k1 = src.index("\n}\n", k0)
        body = src[k0:k1]
        start = "  int i = 0;\n"
        assert body.count(start) == 1, "item counter not found"
        # the counters, and for dk/dv's second sweep a second set
        body = body.replace(start, start + "  unsigned long long pr_all[16]"
                            " = {};\n  unsigned long long* pr = pr_all;\n"
                            "  long long tc = clock64();\n"
                            "  const long long t0 = tc;\n", 1)
        lam = "    constexpr bool DK = decltype(dk_sweep)::value;\n"
        body = body.replace(lam, lam + "    unsigned long long* pr = pr_all"
                            " + (DK ? 8 : 0);\n", 1)
        body = body.replace(", next);", ", next, pr, tc);")
        body = mark(body, [m for m in KERNEL_MARKS if m[0] in body],
                    kernel)
        dk = "  sweep(std::true_type());   // dK"
        if dk in body:   # the clocks of dk/dv's second sweep
            body = body.replace(dk, "  const long long t2 = clock64();\n"
                                + dk + "\n  if (wtid == 0) atomicAdd("
                                "&g_prof[1][9], (unsigned long long)"
                                "(clock64() - t2));", 1)
        body += ("\n  FF_T(7)\n  if (wtid == 0) {\n"
                 "    for (int n = 0; n < 8; ++n) "
                 f"atomicAdd(&g_prof[{kind}][n], pr_all[n] + pr_all[8 + n])"
                 ";\n    for (int n = 0; n < 8; ++n) "
                 "atomicAdd(&g_prof[2][n], pr_all[8 + n]);\n"
                 f"    atomicAdd(&g_prof[{kind}][8], "
                 "(unsigned long long)(clock64() - t0));\n  }")
        src = src[:k0] + body + src[k1:]
    return src


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="4x8x512x256,4x8x512x512,"
                    "64x1x128x512")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = os.path.join(ROOT, "build", "profile_bwd")
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
    fns = []
    for sym in ("ff_flash_attention_bwd_dq", "ff_flash_attention_bwd_dkv"):
        fn = getattr(lib, sym)
        fn.argtypes = _ARGTYPES[("flash_attention_bwd", sym)]
        fn.restype = ctypes.c_int
        fns.append(fn)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in args.shapes.split(","):
        b, h, s, d = (int(x) for x in shape.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                       for _ in range(4))
        # the forward's lse and o in plain f32, delta = rowsum(do * o)
        scores = torch.matmul(q, k.transpose(2, 3)) * d ** -0.5
        lse = torch.logsumexp(scores, -1)
        o = torch.matmul(torch.softmax(scores, -1), v)
        delta = (do * o).sum(-1)
        del scores
        outs = [torch.empty_like(q) for _ in range(3)]
        tail = [b * h, s, s, d, 0, 0, d ** -0.5, 0, 0, 1.0, 0]
        cargs = ([t.data_ptr() for t in (q, k, v, do, lse, delta, outs[0])]
                 + tail,
                 [t.data_ptr() for t in (q, k, v, do, lse, delta, outs[1],
                                         outs[2])] + tail)
        for kind, name in enumerate(("dq", "dk/dv")):
            def launch():
                err = fns[kind](*cargs[kind],
                                torch.cuda.current_stream().cuda_stream)
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
            prof = (ctypes.c_ulonglong * 30)()
            lib.ff_prof_read(prof)
            row = prof[10 * kind:10 * kind + 10]
            shares = ", ".join(f"{n} {row[i] / row[8]:.3f}"
                               for i, n in enumerate(PHASES))
            ctas = b * h * -(-s // 64)
            cta_clocks = row[8] / 2 / ctas / args.iters
            mhz = row[8] / 2 / args.iters / (us * min(ctas, sms))
            extra = (f", second sweep {row[9] / row[8]:.3f}"
                     if kind else "")
            print(f"{name} b{b} h{h} s{s} d{d} f32: {us:.2f} us per launch "
                  f"(eager, instrumented); {shares}; {cta_clocks:.0f} "
                  f"clocks a CTA, implied SM clock {mhz:.0f} MHz{extra}")
            if kind:
                two = prof[20:28]
                print(f"  its second sweep (dK): " + ", ".join(
                    f"{n} {two[i] / row[9]:.3f}"
                    for i, n in enumerate(PHASES)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
