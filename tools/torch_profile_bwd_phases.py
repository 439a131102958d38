"""Where the time of the f32 tensor-core flash dq and dk/dv goes, phase by
phase, on one GPU.

    python3 tools/torch_profile_bwd_phases.py [--shapes 1x8x512x64c,...]

There is no ncu on the card's machine, so this builds an instrumented
copy of ``csrc/flash_attention_bwd.cu`` into build/profile_bwd/ (git-
ignored): the bodies of the f32 dq and dk/dv (``tf32_dq`` and
``tf32_dkv``, which every f32 tensor-core kernel of the backward runs, at
d 64 and 128 and at 192 ... 512) gain clock64() counters that thread 0 of
each warpgroup sums per phase of each ring item (a score chunk or a
gradient chunk) and of each streamed tile, and adds to a device array at
the end of the CTA. The committed source is not changed. For each b x h x
s x d shape (f32, causal where it ends in ``c``, no dropout) it prints
each kernel's eager time per launch and the share of a warpgroup's clocks
(every warpgroup summed) in: the wait for an item's TMA copies, the split
(the streamed chunk split in place and the owned chunk's fragments, or
the transposition), the proxy fence, the ring's barrier and the next
copy's issue, the products issued and waited for, the f32 sum of a
chunk's partial (scores into shared memory, gradients into registers),
the score sums (with d split, the exchange of the partial tiles and its
two CTA barriers), the softmax, ds and the fragments, and the rest
(prologue, lse and delta, the loops' own work, the output). A counter
charges a stall to the phase where the warp waits, so a phase's share is
where time passes, not what causes it. Beside the shares: the mean clocks
of a warpgroup, the SM clock they imply over the launch (the warpgroups'
clocks over the launch time and the two warpgroups an SM holds: a low one
means throttled or idle SMs), and, where dk/dv sweeps twice, its share in
its second sweep (dK), whose phase shares follow on a line of their own.
The last line prints the card's name and power limit. Imports only the
port, never JAX.
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

sys.path.insert(0, os.path.join(ROOT, "tools"))

from flexflow_tpu_torch.kernels import build  # noqa: E402
from flexflow_tpu_torch.kernels.flash_attention import (_ARGTYPES,
                                                        _map_args)  # noqa: E402
from torch_bwd_variants import bwd_inputs  # noqa: E402

PHASES = ["TMA wait", "split", "fence + barrier", "products", "f32 sum",
          "exchange", "softmax + ds", "other"]
BODIES = ("__device__ __forceinline__ void tf32_dq(",
          "__device__ __forceinline__ void tf32_dkv(")
# (a line of the helpers' bodies, by a piece of it, how often it occurs
# there, the phases whose counters are read before the line, and after it)
HELPER_MARKS = [
    ("mbar_wait(bar, parity);", 2, [7], [0]),
    ("q_frags_tf32(sA, warp, g, tig, ah, al);", 1, [], [1]),
    ("split_transpose_v<CW, Tl::BN>(sB, t_hi, t_lo, wtid);", 1, [], [1]),
    ("  next();", 2, [], [2]),
    ("fence_acc(t);", 2, [], [3]),
    ("partial_add(part, wg, wtid, t, first);", 1, [], [4]),
    ("oc[dt][c] += t[dt][c];", 1, [], [4]),
]
# the same in the two bodies: each score sum, the softmax up to the next
# product, ds up to the gradient fragments (dk/dv's one sweep: p_eff's
# fragments too)
KERNEL_MARKS = [
    ("score_sum<Tl>(x", [7], [5]),
    ("// dP = dO . V^T, the same way", [6], []),
    ("if constexpr (DK) {", [6], []),
    ("tf32_a_frags(", [], [6]),
    ("tf32_a_frags_kept<NB, DROPOUT>(", [], [6]),
    ("// dV[:, own columns] += P_eff^T . dO, chunk by chunk", [6], []),
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
    """The backward source with the phase counters in both f32 bodies."""
    head = ('__device__ unsigned long long g_prof[3][12];\n'
            'extern "C" int ff_prof_read(unsigned long long* out) {\n'
            '  return (int)cudaMemcpyFromSymbol(out, g_prof, '
            'sizeof(g_prof));\n}\n'
            'extern "C" int ff_prof_zero() {\n'
            '  unsigned long long z[36] = {0};\n'
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
    for kind, kernel in enumerate(BODIES):
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
        lam = "    constexpr int M = decltype(mode)::value;\n"
        body = body.replace(lam, lam + "    unsigned long long* pr = pr_all"
                            " + (M == 1 ? 8 : 0);\n", 1)
        body = body.replace(", next);", ", next, pr, tc);")
        body = mark(body, [m for m in KERNEL_MARKS if m[0] in body],
                    kernel)
        dk = "    sweep(std::integral_constant<int, 1>());  // dK"
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
                 "(unsigned long long)(clock64() - t0));\n"
                 f"    atomicAdd(&g_prof[{kind}][10], 1ull);\n  }}")
        src = src[:k0] + body + src[k1:]
    return src


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="1x8x512x64c,1x8x512x128c,"
                    "8x12x512x64,8x12x512x128,4x8x512x256")
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
        b, h, s, d, causal, (q, k, v, do, lse, delta) = bwd_inputs(shape)
        outs = [torch.empty_like(q) for _ in range(3)]
        tail = [b * h, s, s, d, 0, int(causal), d ** -0.5, 0, 0, 1.0, 0,
                *_map_args(b, h, None)]
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
            prof = (ctypes.c_ulonglong * 36)()
            lib.ff_prof_read(prof)
            row = prof[12 * kind:12 * kind + 12]
            shares = ", ".join(f"{n} {row[i] / row[8]:.3f}"
                               for i, n in enumerate(PHASES))
            # the warpgroups of a launch, as they counted themselves; two
            # an SM in every layout
            wgs = row[10] / args.iters
            wg_clocks = row[8] / row[10]
            mhz = row[8] / args.iters / (us * min(wgs, 2 * sms))
            extra = (f", second sweep {row[9] / row[8]:.3f}"
                     if kind and row[9] else "")
            print(f"{name} b{b} h{h} s{s} d{d} f32"
                  f"{' causal' if causal else ''}: {us:.2f} us per launch "
                  f"(eager, instrumented); {shares}; {wg_clocks:.0f} "
                  f"clocks a warpgroup, implied SM clock {mhz:.0f} MHz"
                  f"{extra}")
            if kind and row[9]:
                two = prof[24:32]
                print(f"  its second sweep (dK): " + ", ".join(
                    f"{n} {two[i] / row[9]:.3f}"
                    for i, n in enumerate(PHASES)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
