"""Where the time of the port's BERT-base serving forward, or train step,
goes, on one GPU.

    python3 tools/torch_profile_bert.py [--seqs 128,512] [--iters 5] [--train]

Builds full-width BERT-base (seeded random weights) through the port's
FFModel, as chip_smoke.py does, and profiles a steady window with
torch.profiler: without ``--train``, 8-row requests answered through
InferenceSession.infer with kernel_impls="attention:flash"; with
``--train``, train steps (dropout 0.1, AdamOptimizer) with
kernel_impls="attention:flash,opt_update:fused", each ending in a device
sync. For each sequence length it prints the host wall time per request
(or step), the device kernel time and the device's busy share (kernel
time / wall time), the time by kernel family (GEMM, each of the port's
kernels, the rest), and the kernels that take the most device time. A
Chrome trace of the window goes to <--out-dir>/profile_bert[_train]_s<seq>
.json (default build/profile, git-ignored). Imports only the port, never
JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,  # noqa
                                SGDOptimizer)
from flexflow_tpu_torch.models import BertConfig, build_bert  # noqa: E402
from flexflow_tpu_torch.serving import InferenceSession  # noqa: E402

BATCH = 8


def family(name: str) -> str:
    low = name.lower()
    for kernel, fam in (("flash_fwd_", "flash_attention_fwd"),
                        ("flash_bwd_dq_", "flash_attention_bwd_dq"),
                        ("flash_bwd_dkv_", "flash_attention_bwd_dkv"),
                        ("adam_kernel", "adam_update")):
        if kernel in low:
            return fam
    if "gemm" in low or "nvjet" in low or "xmma" in low \
            or "cutlass" in low:
        return "gemm"
    return "other"


def _model(seq: int, train: bool):
    cfg = FFConfig()
    cfg.batch_size = BATCH
    cfg.only_data_parallel = True
    cfg.kernel_impls = "attention:flash,opt_update:fused" if train \
        else "attention:flash"
    ff = FFModel(cfg)
    bcfg = BertConfig.base()
    bcfg.max_position = seq
    out = build_bert(ff, BATCH, seq, bcfg)
    if train:
        ff.compile(AdamOptimizer(1e-4), "sparse_categorical_crossentropy",
                   ["accuracy"], output_tensor=out)
    else:
        ff.compile(SGDOptimizer(0.01), "sparse_categorical_crossentropy",
                   [], output_tensor=out)
    return ff, bcfg


def _runner(seq: int, train: bool):
    """One request (or one train step ending in a device sync)."""
    ff, bcfg = _model(seq, train)
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, bcfg.vocab_size, (BATCH, seq))
             .astype(np.int32),
             "position_ids": np.tile(np.arange(seq, dtype=np.int32),
                                     (BATCH, 1))}
    if not train:
        sess = InferenceSession(ff, batch_buckets=(BATCH,))
        return lambda: sess.infer(batch)
    batch["label"] = rng.integers(0, bcfg.num_labels, (BATCH, 1)).astype(
        np.int32)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    step_fn = ff.executor.make_train_step()

    def step():
        ff._run_train_step(step_fn, batch)
        torch.cuda.synchronize()
    return step


def profile(seq: int, iters: int, out_dir: str, train: bool = False) -> dict:
    run = _runner(seq, train)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / iters
    by_family = defaultdict(float)
    for name, ms in by_name.items():
        by_family[family(name)] += ms
    device_ms = sum(by_name.values())
    os.makedirs(out_dir, exist_ok=True)
    what = "train_step" if train else "request"
    prof.export_chrome_trace(os.path.join(
        out_dir, f"profile_bert{'_train' if train else ''}_s{seq}.json"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    res = {"seq": seq, "batch": BATCH, "what": what,
           f"wall_ms_per_{what}": wall_ms,
           f"device_kernel_ms_per_{what}": device_ms,
           "device_busy_share": device_ms / wall_ms if wall_ms else None,
           f"kernels_per_{what}": len(kernels) / iters,
           "by_family_ms": dict(by_family),
           "top_kernels_ms": [[n[:90], ms] for n, ms in top]}
    print(f"[profile] bert-base {BATCH}x{seq} {what}: wall {wall_ms:.3f} "
          f"ms, device kernels {device_ms:.3f} ms "
          f"({len(kernels) / iters:.0f} launches), busy share "
          f"{res['device_busy_share']:.3f}; by family "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(
              by_family.items(), key=lambda kv: -kv[1])))
    for n, ms in top:
        print(f"    {ms:8.4f} ms  {n[:110]}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seqs", default="128,512")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out-dir", default=os.path.join("build", "profile"))
    ap.add_argument("--train", action="store_true",
                    help="profile train steps instead of requests")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_bert: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__}")
    results = [profile(int(s), args.iters, args.out_dir, args.train)
               for s in args.seqs.split(",")]
    print(json.dumps({"profile": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
