"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (nvcc). It imports only the port (``flexflow_tpu_torch``),
never JAX, and:

  1. device  - names the card and its power limit;
  2. build   - builds every kernel of the serving path from csrc/ with nvcc;
  3. kernel  - holds each kernel against its plain PyTorch version on the
               card at the main path's shapes, within stated tolerances;
  4. slice   - drives the main path: full-width BERT-base (12 layers,
               hidden 768, 12 heads, vocab 30522, seeded random weights)
               built through FFModel at batch 8 x seq 128 and 8 x 512 with
               kernel_impls="attention:flash", answering requests of 1, 3
               and 8 rows through InferenceSession.infer; checks the
               outputs and the kernel launch counts, and holds them
               against the same model's forward through plain attention;
  5. times   - device times (CUDA graph replay between CUDA events) of the
               kernel, its plain version and torch's
               scaled_dot_product_attention, the kernel's bound, and the
               request latency (median, p90) on the host clock;
  6. kernels - one JSON line with each kernel's launches, error and times.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no result; it does the
same where no CUDA device is present.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

# tolerances of kernel vs plain version on the card: f32 differs only by
# summation order and the online softmax; bf16 also rounds p (and o) to
# bf16 at different running maxima, one bf16 ulp of an O(1) output is
# 2**-8
TOL = {torch.float32: {"o": 2e-5, "lse": 2e-5},
       torch.bfloat16: {"o": 1.6e-2, "lse": 1e-4}}
# flash-attention model vs the same weights through plain attention, on
# the output class probabilities (bf16 matmuls in both, 12 layers)
SLICE_TOL = 2e-2
LAYERS = 12
REQUESTS = 100   # timed requests per shape: the p90 has 10 beyond it


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_time_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph and replayed between two CUDA events, so the host's launch
    overhead (larger than a short kernel) does not pace the measurement.
    Inputs stay in the 50 MB L2 between calls, as on the main path, where
    the projections that produce q, k, v run just before."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(bh: int, sq: int, sk: int, d: int,
                       itemsize: int) -> tuple:
    """Least time for one attention forward: q, k, v read once, o and the
    f32 lse written once, against 4*sq*sk*d flops per head on the bf16
    tensor cores."""
    nbytes = (2 * bh * sq * d + 2 * bh * sk * d) * itemsize + bh * sq * 4
    flops = 4.0 * bh * sq * sk * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{dev['kind']} x{dev['count']}")
    print(smi)
    return dev


def phase_build() -> None:
    from flexflow_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all(["flash_attention_fwd"])
    regs = []
    for name, (_, log) in build.build_log.items():
        regs += [ln.split("Used")[1].split(",")[0].strip()
                 for ln in log.splitlines() if "Used" in ln]
    print(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.2f} s; "
          f"registers per thread of each instantiation: {regs}")


def phase_kernel() -> float:
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (b, h, s_q, s_k, d, dtype, causal, dropout)
        (8, 12, 128, 128, 64, torch.bfloat16, False, 0.0),
        (8, 12, 512, 512, 64, torch.bfloat16, False, 0.0),
        (8, 12, 128, 128, 64, torch.float32, False, 0.0),
        (8, 12, 512, 512, 64, torch.float32, False, 0.0),
        (8, 12, 512, 512, 64, torch.bfloat16, True, 0.0),
        (8, 12, 200, 200, 64, torch.bfloat16, False, 0.0),
        (8, 12, 200, 200, 64, torch.float32, True, 0.0),
        (8, 12, 128, 128, 64, torch.bfloat16, False, 0.1),
        (8, 12, 512, 512, 64, torch.float32, False, 0.1),
        # off the BERT path: head dims 128 and 48 (padded to 64), sq != sk
        (2, 4, 128, 128, 128, torch.bfloat16, True, 0.1),
        (2, 4, 96, 200, 48, torch.float32, False, 0.0),
    ]
    worst = 0.0
    for b, h, sq, sk, d, dt, causal, rate in cases:
        q, k, v = (torch.randn(b, h, s, d, device="cuda", dtype=dt,
                               generator=gen) for s in (sq, sk, sk))
        kw = dict(causal=causal, dropout_rate=rate,
                  dropout_seed=1234 if rate else None)
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        po, plse = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        do = (o.float() - po.float()).abs().max().item()
        dl = (lse - plse).abs().max().item()
        tol = TOL[dt]
        ok = do <= tol["o"] and dl <= tol["lse"] \
            and bool(torch.isfinite(o.float()).all())
        print(f"[kernel] flash_attention_fwd b{b} h{h} sq{sq} sk{sk} d{d} "
              f"{str(dt)[6:]} causal={causal} dropout={rate}: "
              f"max|do|={do:.3e} (tol {tol['o']:.0e}) "
              f"max|dlse|={dl:.3e} (tol {tol['lse']:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"flash kernel disagrees with its plain version at "
                  f"{(b, h, sq, sk, d, dt, causal, rate)}")
        worst = max(worst, do)
    return worst


def build_model(seq: int, impl: str):
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import BertConfig, build_bert
    cfg = FFConfig()
    cfg.batch_size = 8
    cfg.only_data_parallel = True
    cfg.kernel_impls = impl
    cfg.seed = 0
    ff = FFModel(cfg)
    bcfg = BertConfig.base()
    bcfg.max_position = seq
    out = build_bert(ff, 8, seq, bcfg)
    ff.compile(SGDOptimizer(0.01), "sparse_categorical_crossentropy", [],
               output_tensor=out)
    return ff, bcfg


def requests(bcfg, seq: int, rows: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, bcfg.vocab_size,
                                      size=(rows, seq)).astype(np.int32),
            "position_ids": np.tile(np.arange(seq, dtype=np.int32),
                                    (rows, 1))}


def phase_slice(seqs) -> dict:
    from flexflow_tpu_torch.kernels.flash_attention import flash_attention
    from flexflow_tpu_torch.serving import InferenceSession
    models = {}
    for seq in seqs:
        ff, bcfg = build_model(seq, "attention:flash")
        models[seq] = (ff, bcfg, InferenceSession(ff, batch_buckets=(8,)))
    torch.cuda.synchronize()
    # the main path: every count starts at 0 here
    flash_attention.launches = 0
    forwards = 0
    outs = {}
    for seq, (ff, bcfg, sess) in models.items():
        for rows in (1, 3, 8):
            outs[(seq, rows)] = sess.infer(requests(bcfg, seq, rows, rows))
            forwards += 1
    launches = flash_attention.launches
    print(f"[slice] main path: {forwards} forwards of BERT-base through "
          f"InferenceSession.infer, flash_attention_fwd launches="
          f"{launches} (want {LAYERS} x {forwards})")
    check(launches == LAYERS * forwards,
          f"flash launches {launches} != {LAYERS} x {forwards}")
    for seq, (ff, bcfg, sess) in models.items():
        # the same weights through the plain attention path
        ref, _ = build_model(seq, "attention:xla")
        ref.params = ff.params
        ref_sess = InferenceSession(ref, batch_buckets=(8,))
        for rows in (1, 3, 8):
            out = outs[(seq, rows)]
            want = ref_sess.infer(requests(bcfg, seq, rows, rows))
            err = float(np.abs(out - want).max())
            sums = np.abs(out.sum(axis=1) - 1.0).max()
            ok = out.shape == (rows, bcfg.num_labels) \
                and np.isfinite(out).all() and sums < 1e-5 \
                and err <= SLICE_TOL
            print(f"[slice] bert-base 8x{seq} request of {rows} rows: "
                  f"shape {out.shape}, finite, |row sum - 1| <= "
                  f"{sums:.1e}, max|flash - plain attention| = {err:.3e} "
                  f"(tol {SLICE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
            check(ok, f"BERT-base 8x{seq} output check, {rows} rows")
        del ref, ref_sess
    return {"models": models, "launches": launches}


def phase_times(models) -> dict:
    import torch.nn.functional as F
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {}
    for seq, (ff, bcfg, sess) in models.items():
        batch = requests(bcfg, seq, 8, 0)
        for _ in range(3):
            sess.infer(batch)
        lat = []
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            sess.infer(batch)
            lat.append((time.perf_counter() - t0) * 1e3)
        fwd_ms, fwd_p90 = np.percentile(lat, 50), np.percentile(lat, 90)
        b, h, d = 8, bcfg.num_heads, bcfg.hidden_size // bcfg.num_heads
        q, k, v = (torch.randn(b, h, seq, d, device="cuda",
                               dtype=torch.bfloat16, generator=gen)
                   for _ in range(3))
        ms = cuda_time_ms(lambda: flash_attention(q, k, v))
        plain_ms = cuda_time_ms(lambda: flash_attention_plain(q, k, v))
        lib_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by = attention_bound_ms(b * h, seq, seq, d, 2)
        res[seq] = dict(fwd_ms=fwd_ms, fwd_p90_ms=fwd_p90, ms=ms,
                        plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
        print(f"[times] bert-base 8x{seq}: 8-row request latency median "
              f"{fwd_ms:.3f} ms, p90 {fwd_p90:.3f} ms over {REQUESTS} "
              f"requests, one client, closed loop (host clock, ends in a "
              f"device sync); "
              f"flash_attention_fwd b8 h{h} s{seq} d{d} bf16: kernel "
              f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
              f"sdpa {lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}); kernel/bound {ms / bound_ms:.2f}")
    return res


def main() -> int:
    dev = phase_device()
    phase_build()
    worst = phase_kernel()
    sl = phase_slice((128, 512))
    times = phase_times(sl["models"])
    t = times[128]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "flexflow_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "flexflow_tpu/kernels/flash_attention.py:110",
        "launches": sl["launches"], "max_abs_err": worst,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": "b8 h12 s128 d64 bf16",
        "at_s512": {key: times[512][key] for key in
                    ("ms", "plain_ms", "bound_ms", "library_ms")}}]}))
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
