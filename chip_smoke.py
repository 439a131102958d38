"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (nvcc). It imports only the port (``flexflow_tpu_torch``),
never JAX, and:

  1. device  - names the card and its power limit;
  2. build   - builds every kernel of both paths from csrc/ with nvcc, one
               nvcc process per source, all at once, and prints ptxas's
               registers and spill stores of each kernel instantiation
               (the wgmma kernels must not spill);
  3. kernel  - holds each kernel against its plain PyTorch version on the
               card at the main paths' shapes and at the edges of the
               kernels' tiling, within stated tolerances: the flash
               forward, dq and dk/dv over one case list (dq also
               bit-identical over two launches), the fused Adam over
               BERT-base's and DLRM's leaves plus ragged and bf16 ones;
  4. ktimes  - device times (CUDA graph replay between CUDA events) of
               each kernel, its plain version and its PyTorch yardstick,
               at b8 h12 d64 bf16, s 128 and 512, without dropout and at
               BERT's training rate of 0.1, causal at GPT-2's prefill
               shape (s 1024), at LLaMA-7B's prefill (b4 h32 s1024 d128
               causal) and training shape (the causal backward at d 128),
               the causal backward at d 64, head dims 256, 320 and 512,
               NMT's attention (b64 h1 s128 d512), the Transformer's
               (b64 h8 s512 d8, padded to 64), SDPA's backend named (its
               efficient backend's backward where its flash backend
               refuses the shape), Adam over BERT-base and over DLRM's
               256.03 M parameters, and each kernel's bound;
  5. slice   - drives the serving path: full-width BERT-base (12 layers,
               hidden 768, 12 heads, vocab 30522, seeded random weights)
               built through FFModel at batch 8 x seq 128 and 8 x 512 with
               kernel_impls="attention:flash", answering requests of 1, 3
               and 8 rows through InferenceSession.infer; checks the
               outputs and the kernel launch counts, and holds them
               against the same model's forward through plain attention;
  6. train   - drives the training path: the same BERT-base at 8 x 128
               with dropout 0.1 through compile(AdamOptimizer, ...,
               kernel_impls="attention:flash,opt_update:fused") -> fit ->
               eval on seeded random ids and labels; checks every kernel's
               launch count per step and a finite loss; then, at dropout
               0, holds the loss history against the same weights trained
               through plain attention and the unfused Adam;
  7. times   - the request latency and the train-step time (median, p90)
               on the host clock, and the step's peak device memory (needs
               slice);
  8. generate - drives the generation path: full-width GPT-2 small (12
               layers, hidden 768, 12 heads, vocab 50257, 1024 positions,
               seeded random weights) built through FFModel at 8 x 1024
               with kernel_impls="attention:flash", through
               InferenceSession.generate: greedy, ragged prompts with eos,
               beam search, sampling, segmented greedy; checks 12 flash
               launches per prefill and none per decode step, no KV
               fallback, the outputs, and the KV decode's score rows
               against the re-forward through flash and through plain
               attention; times the prefill and the decode step (median,
               p90, tokens/s) at 1 and 8 rows, the peak memory of a
               generate call, and profiles the decode step;
  9. llama   - LLaMA-7B (32 layers, hidden 4096, FFN 11008, 32 heads of
               128, vocab 32000, RoPE in the op; seeded random weights)
               built through FFModel at 4 x 1024 with
               kernel_impls="attention:flash", generating through
               InferenceSession.generate (greedy, ragged prompts with
               eos): 32 flash launches per prefill and none per decode
               step, no KV fallback, the KV rows against the re-forward
               through flash and plain attention, the same times as
               generate; then at LLaMA-7B width and 2 layers the
               primitive form (logits against the fused form on the same
               weights, generation by re-forward) at 2 x 256, and
               training through fit at 2 x 1024 (launches per step, the
               loss history against plain attention + unfused Adam);
 10. mixtral - Mixtral-8x7B's width (hidden 4096, FFN 14336, 32 heads / 8
               kv heads of 128, 8 SwiGLU experts top-2, vocab 32000; RoPE
               in the op; seeded random weights) cut to 8 of 32 layers,
               built through FFModel at 4 x 1024 with
               kernel_impls="attention:flash", generating through
               InferenceSession.generate as the llama phase does (8 flash
               launches per prefill, none per decode step), with the
               same checks and times; then 1 layer at full width training
               through fit at 2 x 1024 (flash forward, dq, dk/dv, fused
               Adam at epsilon 1e-4: launches per step, the loss history
               against plain attention + unfused Adam);
 11. moe     - build_moe_mnist at the reference example's defaults (32
               experts, top-2, hidden 64, alpha 2.0, lambda_bal 0.04, in
               784) training through fit at batch 64 with
               kernel_impls="opt_update:fused": one Adam launch per step,
               the loss history against the unfused Adam, and the
               (token, choice) slots the capacity drops;
 12. zoo     - the rest of the model zoo at published widths, each
               trained through fit with kernel_impls="attention:flash,
               opt_update:fused" (bf16 operands, seeded random weights and
               data, cuDNN's deterministic algorithms): the Transformer
               (TransformerConfig(), batch 64: 6 flash forward, dq and
               dk/dv launches a step), NMT (NMTConfig(), batch 64, 128
               tokens each side: 1 wide flash launch of each a step, its
               LSTM step profiled), ResNet-50 (224, batch 64), ResNeXt-50
               32x4d (224, batch 16), Inception-v3 (299, batch 64),
               AlexNet (229, batch 64), all with a 1000-class head, DLRM
               and XDL (their configs, batch 64); exact flash and Adam
               launches (ceil(leaves / 384) a step), finite losses, the
               loss history and BatchNorm running statistics against
               plain attention + unfused Adam from the same weights, step
               time (median, p90), peak memory; the Transformer and
               ResNet-50 also answer requests through
               InferenceSession.infer;
 13. frontends - the frontends' entry points on the card: (a) BERT-base
               written in plain torch.nn (vocab 30522, hidden 768, 12
               heads, FFN 3072, 12 layers, positions from torch.arange,
               which the import folds into a constant) imported through
               PyTorchModel.torch_to_ff at 8 x 512 with
               kernel_impls="attention:flash,opt_update:fused" and
               copy_weights: InferenceSession.infer of 1, 3, 8 rows (12
               flash launches a forward, one host-to-device copy a
               request), against plain attention; fit for 3 steps at
               dropout 0.1 (12 / 12 / 12 flash and ceil(leaves / 384)
               Adam launches a step); the dropout-0 loss history against
               plain attention + unfused Adam; step time and peak memory.
               (b) The Keras layer set at BERT-base width, 8 x 128,
               through Model.compile("adam") and Model.fit with a
               LearningRateScheduler and an EarlyStopping that stops after
               the second epoch (the scheduled alpha checked, as the
               fused Adam's alpha_t), then predict. (c) AlexNet's layers
               (1000 classes, 229 x 229, batch 64) encoded with the ONNX
               wire encoder, imported through ONNXModel.apply, served and
               held against an f32 functional forward of the same
               initializers, then 3 fit steps with the fused Adam;
 14. resilience - checkpointing, fault injection, the Supervisor and
               telemetry on the card: BERT-base 8 x 128 (dropout 0.1, Adam
               1e-4, kernel_impls="attention:flash,opt_update:fused",
               tracing on with a Chrome-trace export) trained by
               resilience.Supervisor over 2 epochs x 4 batches,
               checkpointing every 2 steps (max_to_keep 2), clean and
               under the fault plan "nan@3;corrupt_ckpt@6;crash@6" (a NaN
               rollback, a corrupted newest checkpoint the restore walks
               past, a crash); the faulty run must end bit-identical to
               the clean one (params, Adam m and v, the last epoch's loss),
               every executed step, replays included, through the flash
               forward, dq, dk/dv and the fused Adam (12 / 12 / 12 / 1
               launches a step); the newest step's manifest against the
               JAX package's keystr leaves (tests/data/); the trace's
               spans and restart instants, the Prometheus exposition, the
               NaN rollback's flight record; InferenceSession.infer under
               "infer_fail@1"; the blocking and async save and the restore
               (its CRC share) of the 1.31 GB state, the disabled step
               wrapper's host cost (<= 3% of a step) and the step with
               tracing on and off;
 15. search  - the strategy search on the card: the calibration (the bf16
               matmul chain and mxu_eff, host dispatch, HBM streaming
               read, op_attention@xla / @flash at s 128 and 512, then
               both at 1024, 2048, 4096, b1 h8 d64 f32 causal, and the
               crossover; the flash forward must launch while
               calibrating); BERT-base (BertConfig.base(), uncut) 8 x 512
               compiled with search_budget=8 and calibration on (Unity,
               the floor guard timing searched and data-parallel steps on
               the card, the measured kernel plan) against the same model
               data-parallel on the default plan: the search's time, the
               plan, the predicted step against the median of 6 measured
               after a 3-step fit whose launches are exactly the plan's,
               the dropout-0 histories within 2e-2; remat="blocks"
               against none at 8 x 512, dropout 0.1: bit-identical
               histories, 24 / 12 / 12 / 1 launches a step, peak memory
               and step time of both; recompile_on_condition in a
               2-epoch fit of BERT-base 8 x 128 changing Adam's alpha
               once, against the same change made by hand;
 16. serve   - the serving stack on the card: (a) BERT-base
               (BertConfig.base(), uncut, kernel_impls="attention:flash")
               at s 128 and 512, batch buckets 1, 4 and 8 (one model
               compiled per bucket, as BERT's pooler reshapes to the
               compile batch, over one set of weights, routed by a
               ServingPlanSession) in one ModelRepository behind serve_http and
               serve_async (max_batch 8, max_delay_ms 2): 64 single-row
               requests per model from 16 client threads of another
               process to each front, every response against plain
               attention on the same weights (2e-2), flash launches = 12
               x the device batches the schedulers ran (individual
               retries included), client median / p90 / p99, the server
               sketch's quantiles from /v2/metrics, mean batch rows, and
               the front's overhead read per request from its request
               trace (client latency minus the device batch it rode,
               split into the wait before that batch and the time
               outside the scheduler), under load and for one client on
               an idle server; (b) against a full queue (max_queue 2, the batch in
               the worker's hand held behind the session lock) a 1 ms
               deadline, a malformed request and a request while draining
               answer 503/504, 400 and 503 + Retry-After with no flash
               launch; (c) GPT-2 small (GPTConfig(), 1024 positions)
               behind POST /v2/models/gpt2/generate (8 ragged prompts of
               100-900 tokens, one prefill = 12 launches, equal to
               session.generate), then a ContinuousBatcher of 8 KV slots
               (kv_slot_capacity) over 32 sequences (budgets 8-64 in
               segments of 8, one eos) under continuous and static
               admission: 12 flash launches an iteration, each row
               against session.generate(row[None]) (bit-identical or
               parted only at a near tie, counted), tokens/s, early
               evictions, and a probe of row independence (a row's
               logits alone and inside 8 rows, through the KV step, the
               forward and two GEMMs); (d) optimize_strategy(
               mode="serving") at buckets (1, 4, 8), verify_serving_plan
               (no findings), the plan file loaded by the repository's
               loader (ModelRepository._load_with_builder with
               serving_strategy_file: each bucket's model imports its
               sub-strategy) with its floor guard, outputs and flash
               launches equal to the plain session's, predicted against
               measured prefill and decode step; (e) two replica processes (python -m
               flexflow_tpu_torch.serving.fleet.replica --model
               gpt2-tiny, on the card) behind serve_fleet, one killed by
               FF_FAULT_PLAN=infer_crash@6: 32 requests all answered
               through failover, Autoscaler.tick repairs the fleet, each
               replica's time to ready and the merged fleet metrics;
 17. kernels - one JSON line with each kernel's launches, error and times.

``--phases`` runs a subset while a kernel is brought up: ``--phases
build,kernel`` builds and checks every kernel, ``--phases
build,kernel,ktimes`` also times them, ``--phases build,kernel,generate``
drives generation, ``--phases build,kernel,llama`` the LLaMA family,
``--phases build,kernel,mixtral,moe`` Mixtral and the MoE example,
``--phases build,kernel,zoo`` the rest of the model zoo, ``--phases
build,kernel,frontends`` the frontends, ``--phases
build,kernel,resilience`` checkpointing, faults and telemetry,
``--phases build,kernel,search`` the strategy search, ``--phases
build,kernel,serve`` the serving stack; with
no arguments every phase runs, each phase's wall time printed and each
phase's models freed before the next. ``--ab-base DIR`` does nothing but time the
flash kernels of the checkout at DIR and of this one in turns (base,
change, change, base), the way to compare a kernel change on one card.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no result; it does the
same where no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import importlib
import json
import os
import shutil
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
# backward kernels vs plain, relative to the largest |gradient| of the
# case: f32 differs by summation order and the exp of the kernel vs
# torch's; bf16 writes its outputs in bf16 (one ulp is 2**-8 = 3.9e-3
# relative) and rounds ds and p_eff to bf16 before its products, where a
# last-bit difference in p can move a rounding by one ulp
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# flash-attention model vs the same weights through plain attention, on
# the output class probabilities (bf16 matmuls in both, 12 layers)
SLICE_TOL = 2e-2
# dropout-0 training, flash + fused Adam vs plain attention + unfused
# Adam from the same weights, on each step's loss (~0.7): both run bf16
# matmul operands, whose roundings differ where the two attention paths
# sum in another order; Adam's m/sqrt(v) carries those differences into
# the weights of every later step
TRAIN_TOL = 2e-2
# generate phase: each score row of a KV decode step vs the re-forward's
# row at the same position, relative to that row's logit range (max -
# min): both paths round the same bf16 operands but sum attention in
# another order (flash vs the decode's plain softmax), and the rounding
# differences grow through 12 layers
GEN_TOL = 2e-2
LAYERS = 12
GPT_LAYERS, GPT_SEQ = 12, 1024     # GPT-2 small, full context
GEN_TOKENS = 64                    # tokens of the timed greedy runs
REQUESTS = 100   # timed requests per shape: the p90 has 10 beyond it
STEPS = 20       # timed train steps per shape
KERNELS = ["flash_attention_fwd", "flash_attention_bwd", "adam_update"]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def free_cuda() -> None:
    """Return the memory of the models a phase dropped to the card."""
    gc.collect()
    torch.cuda.empty_cache()


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
                       itemsize: int, causal: bool = False) -> tuple:
    """Least time for one attention forward: q, k, v read once, o and the
    f32 lse written once, against 4*d flops per (query, key) pair the mask
    keeps (sq*sk, or s*(s+1)/2 causal) per head on the bf16 tensor
    cores."""
    nbytes = (2 * bh * sq * d + 2 * bh * sk * d) * itemsize + bh * sq * 4
    pairs = sq * (sq + 1) / 2 if causal else sq * sk
    flops = 4.0 * bh * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> tuple:
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
    return dev, smi


def ptxas_report(log: str) -> list:
    """(kernel instantiation, registers, spill-store bytes) of each entry
    function in ptxas's -v output, the names demangled by c++filt where it
    is installed."""
    rows, name, spills = [], None, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln and name:
            spills = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in ln and "registers" in ln and name:
            regs = int(ln.split("Used")[1].split("registers")[0])
            rows.append([name, regs, spills])
            name = None
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and rows:
        names = subprocess.run([cxxfilt], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        for r, n in zip(rows, names):
            r[0] = n.replace("(anonymous namespace)::", "").split("(")[0] \
                .removeprefix("void ")
    return rows


def phase_build() -> None:
    from flexflow_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all(KERNELS)
    print(f"[build] nvcc sm_90a, {len(KERNELS)} sources at once: "
          f"{time.perf_counter() - t0:.2f} s")
    for lib, (_, log) in build.build_log.items():
        for name, regs, spills in ptxas_report(log):
            print(f"[build] {lib}: {name}: {regs} registers, {spills} bytes "
                  f"spill stores")
            check(spills == 0 or "wgmma" not in name,
                  f"{name} spills {spills} bytes")
        for ln in log.splitlines():
            if "warning" in ln.lower():
                print(f"[build] {lib}: {ln.strip()}")


CASES = [  # (b, h, s_q, s_k, d, dtype, causal, dropout)
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
    # the bf16 forward's and dk/dv's tiling: 64-key tiles in a ring of
    # two stages, 64- or 128-row CTAs (128 at b8 h12 from s = 257 on): one
    # short K tile, fewer tiles than stages, s not a multiple of 64 or 128
    # with and without causal, sq != sk both ways, d = 128 with dropout
    (8, 12, 40, 40, 64, torch.bfloat16, False, 0.0),
    (8, 12, 40, 40, 64, torch.bfloat16, True, 0.1),
    (8, 12, 64, 64, 64, torch.bfloat16, True, 0.0),
    (8, 12, 100, 100, 64, torch.bfloat16, False, 0.1),
    (8, 12, 200, 200, 64, torch.bfloat16, True, 0.1),
    (8, 12, 320, 320, 64, torch.bfloat16, False, 0.0),
    (8, 12, 320, 320, 64, torch.bfloat16, True, 0.1),
    (8, 12, 96, 200, 64, torch.bfloat16, False, 0.0),
    (8, 12, 320, 512, 64, torch.bfloat16, False, 0.1),
    (8, 12, 512, 200, 64, torch.bfloat16, False, 0.0),
    (8, 12, 320, 320, 128, torch.bfloat16, False, 0.1),
    (2, 4, 200, 200, 128, torch.bfloat16, False, 0.1),
    # the bf16 dq kernel's tiling: 64-row CTAs over a ring of 64-key
    # tiles; many query CTAs over one short K tile, few rows over many
    # tiles, causal diagonals at a tile and a tile and a half, d = 128
    # with dropout at a ragged causal s
    (8, 12, 512, 40, 64, torch.bfloat16, False, 0.0),
    (8, 12, 40, 512, 64, torch.bfloat16, False, 0.1),
    (8, 12, 128, 128, 64, torch.bfloat16, True, 0.0),
    (8, 12, 192, 192, 64, torch.bfloat16, True, 0.1),
    (2, 4, 100, 100, 128, torch.bfloat16, True, 0.1),
    # GPT-2 small's prefill (generate phase): causal at s = 1024, and a
    # ragged causal s over 128-row CTAs
    (8, 12, 1024, 1024, 64, torch.bfloat16, True, 0.0),
    (8, 12, 1000, 1000, 64, torch.bfloat16, True, 0.0),
    # LLaMA-7B's prefill (llama phase): causal d = 128 at 4 x 1024
    (4, 32, 1024, 1024, 128, torch.bfloat16, True, 0.0),
    # the wide kernels (d a runtime argument): head dims 192, 256, 320 and
    # 512 (and 160 padded to 192, 300 padded to 320) in both types, causal
    # and not, at a ragged s
    (2, 4, 200, 200, 192, torch.float32, False, 0.0),
    (2, 4, 200, 200, 192, torch.float32, True, 0.1),
    (2, 4, 200, 200, 192, torch.bfloat16, False, 0.1),
    (2, 4, 200, 200, 192, torch.bfloat16, True, 0.0),
    (2, 4, 200, 200, 256, torch.float32, False, 0.1),
    (2, 4, 200, 200, 256, torch.float32, True, 0.0),
    (2, 4, 200, 200, 256, torch.bfloat16, False, 0.0),
    (2, 4, 200, 200, 256, torch.bfloat16, True, 0.1),
    (2, 4, 96, 200, 256, torch.bfloat16, False, 0.0),
    (2, 4, 100, 100, 160, torch.bfloat16, True, 0.0),
    (2, 4, 200, 200, 300, torch.float32, False, 0.0),
    (2, 4, 200, 200, 300, torch.float32, True, 0.1),
    (2, 4, 200, 200, 300, torch.bfloat16, False, 0.1),
    (2, 4, 200, 200, 300, torch.bfloat16, True, 0.0),
    (2, 4, 200, 200, 512, torch.float32, False, 0.1),
    (2, 4, 200, 200, 512, torch.float32, True, 0.0),
    (2, 4, 200, 200, 512, torch.bfloat16, False, 0.0),
    (2, 4, 200, 200, 512, torch.bfloat16, True, 0.1),
    # the wide bf16 wgmma forward and dq (d compiled in at 192, 256, 320,
    # 384, 448 and 512; 128-row CTAs up to d 320, 64 rows with d split
    # between two warpgroups above; forward key tiles of 64 up to d 256,
    # 32 above; dq 64 / 32 / 16 keys at 192 / 256, 384 / 320, 448, 512):
    # 384 and 448 in both types, causal and not, with and without dropout;
    # d 320 unpadded at sq != sk; NMT's attention (NMTConfig: hidden 512,
    # one head) at a 128-token sentence, and ragged cross-attention at d
    # 512 both ways
    (2, 4, 200, 200, 384, torch.float32, False, 0.1),
    (2, 4, 200, 200, 384, torch.float32, True, 0.0),
    (2, 4, 200, 200, 384, torch.bfloat16, False, 0.0),
    (2, 4, 200, 200, 384, torch.bfloat16, True, 0.1),
    (2, 4, 200, 200, 448, torch.float32, False, 0.0),
    (2, 4, 200, 200, 448, torch.float32, True, 0.1),
    (2, 4, 200, 200, 448, torch.bfloat16, False, 0.1),
    (2, 4, 200, 200, 448, torch.bfloat16, True, 0.0),
    (2, 4, 96, 200, 320, torch.bfloat16, False, 0.1),
    (64, 1, 128, 128, 512, torch.bfloat16, False, 0.0),
    # the Transformer's attention (zoo phase): TransformerConfig's kdim =
    # hidden / heads split over 8 heads, d 8, padded to 64
    (64, 8, 512, 512, 8, torch.bfloat16, False, 0.0),
    (16, 1, 100, 37, 512, torch.bfloat16, False, 0.0),
    (16, 1, 37, 100, 512, torch.bfloat16, False, 0.1),
    # the wide bf16 wgmma dk/dv (the same six d; two sweeps over query
    # tiles of 64 / 32 / 16 / 32 / 16 / 16 rows at 192 / 256 / 320 / 384 /
    # 448 / 512, 128-key CTAs up to d 320, 64 keys with d split above):
    # with the cases above, every d causal and not, each with and without
    # dropout, causal at s ending mid-tile and mid-key-block
    (2, 4, 200, 200, 192, torch.bfloat16, False, 0.0),
    (2, 4, 260, 260, 192, torch.bfloat16, True, 0.1),
    (2, 4, 200, 200, 256, torch.bfloat16, False, 0.1),
    (2, 4, 260, 260, 256, torch.bfloat16, True, 0.0),
    (2, 4, 200, 200, 300, torch.bfloat16, False, 0.0),
    (2, 4, 100, 100, 320, torch.bfloat16, True, 0.1),
    (2, 4, 200, 200, 384, torch.bfloat16, False, 0.1),
    (2, 4, 100, 100, 384, torch.bfloat16, True, 0.0),
    (2, 4, 200, 200, 448, torch.bfloat16, False, 0.0),
    (2, 4, 200, 200, 448, torch.bfloat16, True, 0.1),
    (16, 1, 100, 100, 512, torch.bfloat16, True, 0.0),
    (16, 1, 37, 37, 512, torch.bfloat16, True, 0.1),
    # bf16 above d 512 keeps the wide FMA forward and dq (d at run time)
    (2, 4, 200, 200, 576, torch.bfloat16, True, 0.1),
    (2, 4, 200, 200, 576, torch.bfloat16, False, 0.0),
    # b*h = 65,600, past the 65,535 that gridDim.y allows (at d 256, 2.1
    # GB per tensor)
    (1640, 40, 64, 64, 64, torch.bfloat16, False, 0.0),
    (1640, 40, 64, 64, 64, torch.bfloat16, True, 0.0),
    (1640, 40, 64, 64, 256, torch.bfloat16, False, 0.0),
]


def phase_kernel() -> dict:
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, bad = 0.0, []
    for b, h, sq, sk, d, dt, causal, rate in CASES:
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
        if not ok:
            bad.append((b, h, sq, sk, d, str(dt)[6:], causal, rate))
        worst = max(worst, do)
    check(not bad, f"flash kernel disagrees with its plain version at {bad}")
    errs = phase_kernel_bwd(gen)
    errs["flash_attention_fwd"] = worst
    errs["adam_update"] = phase_kernel_adam(gen)
    return errs


def phase_kernel_bwd(gen) -> dict:
    """dq and dk/dv kernels against flash_attention_bwd_plain's parts on
    the forward kernel's o and lse, over the forward's cases; dq must
    also give the same bits on a second launch."""
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
        flash_attention_bwd_dq_plain)
    worst = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0}
    bad = []
    for b, h, sq, sk, d, dt, causal, rate in CASES:
        d_k = -(-d // 64) * 64
        q, k, v, do = (torch.randn(b, h, s, d_k, device="cuda", dtype=dt,
                                   generator=gen)
                       for s in (sq, sk, sk, sq))
        if d_k != d:   # the wrapper's padding: zero head-dim columns
            for t in (q, k, v, do):
                t[..., d:] = 0
        kw = dict(causal=causal, sm_scale=1.0 / d ** 0.5,
                  dropout_rate=rate, dropout_seed=99 if rate else None)
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dq_again = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        pdq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
        pdk, pdv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                 **kw)
        torch.cuda.synchronize()
        errs = {}
        for name, got, want in (("dq", dq, pdq), ("dk", dk, pdk),
                                ("dv", dv, pdv)):
            scale = max(want.float().abs().max().item(), 1e-30)
            errs[name] = (got.float() - want.float()).abs().max().item()
            errs[name + "_rel"] = errs[name] / scale
            check(bool(torch.isfinite(got.float()).all()),
                  f"{name} not finite")
        # a CTA owns its dq rows, so a second launch gives the same bits
        same = torch.equal(dq, dq_again)
        tol = BWD_TOL[dt]
        ok = max(errs["dq_rel"], errs["dk_rel"], errs["dv_rel"]) <= tol \
            and same
        print(f"[kernel] flash_attention_bwd b{b} h{h} sq{sq} sk{sk} d{d} "
              f"{str(dt)[6:]} causal={causal} dropout={rate}: "
              f"max|ddq|={errs['dq']:.3e} ({errs['dq_rel']:.1e} of max) "
              f"max|ddk|={errs['dk']:.3e} ({errs['dk_rel']:.1e}) "
              f"max|ddv|={errs['dv']:.3e} ({errs['dv_rel']:.1e}) "
              f"(tol {tol:.0e} of max), dq bit-identical over two "
              f"launches: {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append((b, h, sq, sk, d, str(dt)[6:], causal, rate))
        worst["flash_attention_bwd_dq"] = max(
            worst["flash_attention_bwd_dq"], errs["dq"])
        worst["flash_attention_bwd_dkv"] = max(
            worst["flash_attention_bwd_dkv"], errs["dk"], errs["dv"])
    check(not bad, f"backward kernels disagree with their plain versions "
                   f"at {bad}")
    return worst


def leaf_shapes(build) -> list:
    """The weight shapes of the model ``build(ff)`` makes, from its graph
    (nothing materialized)."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.ops import ensure_weight_specs
    ff = FFModel(FFConfig())
    build(ff)
    return [tuple(w.shape) for layer in ff.layers
            for w in ensure_weight_specs(layer)]


def bert_leaf_shapes() -> list:
    """Full-width BERT-base's 200 weight shapes."""
    from flexflow_tpu_torch.models import BertConfig, build_bert
    return leaf_shapes(lambda ff: build_bert(ff, 8, 128, BertConfig.base()))


def dlrm_leaf_shapes() -> list:
    """DLRMConfig()'s 12 weight shapes: four 1,000,000 x 64 tables and the
    MLPs, 256.03 M parameters."""
    from flexflow_tpu_torch.models import build_dlrm
    return leaf_shapes(lambda ff: build_dlrm(ff, 64))


def adam_leaves(gen, shapes, dtypes):
    """Seeded (w, g, m, v) per leaf on the card; v > 0 as after a step."""
    out = []
    for shape, dt in zip(shapes, dtypes):
        w = torch.randn(shape, device="cuda", generator=gen).to(dt)
        g = (torch.randn(shape, device="cuda", generator=gen) * 1e-2).to(dt)
        m = torch.randn(shape, device="cuda", generator=gen) * 1e-3
        v = torch.rand(shape, device="cuda", generator=gen) * 1e-5
        out.append((w, g, m, v))
    return out


def phase_kernel_adam(gen) -> float:
    """The fused Adam kernel against fused_adam_update_plain over
    BERT-base's 200 leaves, DLRM's 12 (256.03 M parameters), ragged
    leaves and a bf16 leaf, with weight decay: bit-identical, since both
    round every f32 op once. More than MAX_LEAVES (384) leaves would take
    a second launch; these 217 take one."""
    from flexflow_tpu_torch.kernels.opt_update import (
        fused_adam_update, fused_adam_update_plain)
    shapes = bert_leaf_shapes() + dlrm_leaf_shapes() \
        + [(1,), (7,), (4097,), (33, 65), (3, 5, 7)]
    dtypes = [torch.float32] * (len(shapes) - 1) + [torch.bfloat16]
    leaves = adam_leaves(gen, shapes, dtypes)
    alpha_t = torch.tensor(3e-4, device="cuda")
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=0.01)
    want = [fused_adam_update_plain(w, g, m, v, alpha_t, **kw)
            for w, g, m, v in leaves]
    fused_adam_update([x[0] for x in leaves], [x[1] for x in leaves],
                      [x[2] for x in leaves], [x[3] for x in leaves],
                      alpha_t, **kw)
    torch.cuda.synchronize()
    worst, differing = 0.0, 0
    for (w, _, m, v), (pw, pm, pv) in zip(leaves, want):
        for got, ref in ((w, pw), (m, pm), (v, pv)):
            differing += int((got != ref).sum().item())
            worst = max(worst, (got.float() - ref.float()).abs().max()
                        .item())
    n = sum(w.numel() for w, _, _, _ in leaves)
    print(f"[kernel] adam_update: {len(leaves)} leaves ({n} elements, one "
          f"bf16): {differing} elements differ from the plain version, "
          f"max|diff| = {worst:.3e} (want bit-identical) "
          f"{'ok' if differing == 0 else 'FAIL'}")
    check(differing == 0, "fused Adam kernel is not bit-identical to its "
                          "plain version")
    return worst


def build_model(seq: int, impl: str, optimizer=None, metrics=(),
                dropout: float = 0.1, batch: int = 8, **cfg_kw):
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import BertConfig, build_bert
    cfg = FFConfig()
    cfg.batch_size = batch
    cfg.only_data_parallel = True
    cfg.kernel_impls = impl
    cfg.seed = 0
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    ff = FFModel(cfg)
    bcfg = BertConfig.base()
    bcfg.max_position = seq
    bcfg.dropout = dropout
    out = build_bert(ff, batch, seq, bcfg)
    ff.compile(optimizer or SGDOptimizer(0.01),
               "sparse_categorical_crossentropy", list(metrics),
               output_tensor=out)
    return ff, bcfg


def requests(bcfg, seq: int, rows: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, bcfg.vocab_size,
                                      size=(rows, seq)).astype(np.int32),
            "position_ids": np.tile(np.arange(seq, dtype=np.int32),
                                    (rows, 1))}


def phase_slice(seqs) -> dict:
    from flexflow_tpu_torch.serving import InferenceSession
    models = {}
    for seq in seqs:
        ff, bcfg = build_model(seq, "attention:flash")
        models[seq] = (ff, bcfg, InferenceSession(ff, batch_buckets=(8,)))
    torch.cuda.synchronize()
    # the main path: every count starts at 0 here
    fwd = zero_counts()["flash_attention_fwd"]
    forwards = 0
    outs = {}
    for seq, (ff, bcfg, sess) in models.items():
        for rows in (1, 3, 8):
            outs[(seq, rows)] = sess.infer(requests(bcfg, seq, rows, rows))
            forwards += 1
    launches = fwd.launches
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


def request_latency(seq: int, bcfg, sess) -> dict:
    batch = requests(bcfg, seq, 8, 0)
    for _ in range(3):
        sess.infer(batch)
    lat = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        sess.infer(batch)
        lat.append((time.perf_counter() - t0) * 1e3)
    fwd_ms, fwd_p90 = np.percentile(lat, 50), np.percentile(lat, 90)
    print(f"[times] bert-base 8x{seq}: 8-row request latency median "
          f"{fwd_ms:.3f} ms, p90 {fwd_p90:.3f} ms over {REQUESTS} "
          f"requests, one client, closed loop (host clock, ends in a "
          f"device sync)")
    return dict(fwd_ms=fwd_ms, fwd_p90_ms=fwd_p90)


def phase_times(models) -> dict:
    """Request latency of each served shape, then (with the served models
    released) the train-step time and peak memory of each trained one."""
    res = {seq: request_latency(seq, *models.pop(seq)[1:])
           for seq in sorted(models)}
    for seq in (128, 512):
        t = step_times(seq)
        res[seq].update(t)
        print(f"[times] bert-base 8x{seq} train step (flash + fused Adam, "
              f"dropout 0.1): median {t['step_ms']:.3f} ms, p90 "
              f"{t['step_p90_ms']:.3f} ms over {STEPS} steps (host clock, "
              f"ends in a device sync); peak device memory "
              f"{t['peak_mem_gb']:.3f} GB ({t['resident_gb']:.3f} GB "
              f"resident between steps)")
    return res


def dataset(bcfg, seq: int, rows: int, seed: int):
    """Seeded random ids and labels: ([input_ids, position_ids], y)."""
    rng = np.random.default_rng(seed)
    x = requests(bcfg, seq, rows, seed)
    y = rng.integers(0, bcfg.num_labels, size=(rows, 1)).astype(np.int32)
    return [x["input_ids"], x["position_ids"]], y


def counters() -> dict:
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    from flexflow_tpu_torch.kernels.opt_update import fused_adam_update
    return {"flash_attention_fwd": flash_attention,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "adam_update": fused_adam_update}


def zero_counts() -> dict:
    """Every kernel's launch count set to 0, just before a main path runs;
    returns the counted wrappers by name."""
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    return fns


def train_model(seq: int, impl: str, dropout: float = 0.1, **cfg_kw):
    from flexflow_tpu_torch import AdamOptimizer
    return build_model(seq, impl, AdamOptimizer(1e-4), ["accuracy"],
                       dropout, **cfg_kw)


def phase_train() -> dict:
    """The training path at full width: fit -> eval with every kernel's
    launches counted, then the dropout-0 comparison with the plain path."""
    ff, bcfg = train_model(128, "attention:flash,opt_update:fused")
    x, y = dataset(bcfg, 128, 24, 7)
    epochs, batches = 2, 24 // 8
    torch.cuda.synchronize()
    fns = zero_counts()  # the main path: every count starts at 0
    history = ff.fit(x, y, epochs=epochs, verbose=False)
    launches = {name: fn.launches for name, fn in fns.items()}
    steps = epochs * batches
    want = {"flash_attention_fwd": LAYERS * steps,
            "flash_attention_bwd_dq": LAYERS * steps,
            "flash_attention_bwd_dkv": LAYERS * steps,
            "adam_update": steps}
    print(f"[train] main path: fit of BERT-base 8x128, dropout 0.1, "
          f"{epochs} epochs x {batches} batches = {steps} steps; launches "
          f"{launches} (want {want})")
    check(launches == want, f"train launches {launches} != {want}")
    for rep in history:
        check(np.isfinite(rep["loss"]), f"non-finite loss {rep}")
    ev = ff.eval(x, y)
    print(f"[train] fit history (loss, accuracy) "
          f"{[(round(r['loss'], 5), r['accuracy']) for r in history]}; "
          f"eval {ev}; finite")
    check(np.isfinite(ev["loss"]) and 0.0 <= ev["accuracy"] <= 1.0,
          f"eval metrics {ev}")

    # dropout 0: the same weights through flash + fused Adam and through
    # plain attention + the unfused Adam, one batch per epoch, so the
    # history is the per-step loss
    runs = {}
    x1, y1 = dataset(bcfg, 128, 8, 11)
    for impl in ("attention:flash,opt_update:fused", "attention:xla"):
        m, _ = train_model(128, impl, dropout=0.0)
        if runs:
            first = runs["attention:flash,opt_update:fused"][0]
            m.params = {ln: {wn: t.clone() for wn, t in ws.items()}
                        for ln, ws in first.items()}
        runs[impl] = ({ln: {wn: t.clone() for wn, t in ws.items()}
                       for ln, ws in m.params.items()},
                      [r["loss"] for r in m.fit(x1, y1, epochs=4,
                                                verbose=False)])
        del m
    a = runs["attention:flash,opt_update:fused"][1]
    b = runs["attention:xla"][1]
    err = float(np.abs(np.array(a) - np.array(b)).max())
    ok = err <= TRAIN_TOL and np.all(np.isfinite(a))
    print(f"[train] dropout 0, 4 steps from the same weights: loss flash + "
          f"fused Adam {[round(v, 5) for v in a]}, plain attention + "
          f"unfused Adam {[round(v, 5) for v in b]}: max|diff| = "
          f"{err:.3e} (tol {TRAIN_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    check(ok, "dropout-0 loss histories of the two paths disagree")
    return {"launches": launches, "steps": steps}


def step_times(seq: int) -> dict:
    """Host-clock train-step time (each step ends in a device sync) and
    the step's peak device memory, BERT-base 8 x seq, flash + fused."""
    ff, bcfg = train_model(seq, "attention:flash,opt_update:fused")
    x, y = dataset(bcfg, seq, 8, 3)
    batch = {"input_ids": torch.from_numpy(x[0]).cuda(),
             "position_ids": torch.from_numpy(x[1]).cuda(),
             "label": torch.from_numpy(y).cuda()}
    step_fn = ff.executor.make_train_step()
    for _ in range(3):
        ff._run_train_step(step_fn, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    lat = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        ff._run_train_step(step_fn, batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    del ff
    return {"step_ms": float(np.percentile(lat, 50)),
            "step_p90_ms": float(np.percentile(lat, 90)),
            "peak_mem_gb": peak / 1e9, "resident_gb": base / 1e9}


def bwd_bound_ms(bh: int, s: int, d: int, dkv: bool,
                 causal: bool = False) -> tuple:
    """Least time of one backward kernel (bf16): q, k, v, do read once,
    lse and delta (f32) read once, dq (or dk and dv) written once, against
    6 (dq) or 8 (dk/dv) * d flops per (query, key) pair the mask keeps
    (s*s, or s*(s+1)/2 causal) per head on the bf16 tensor cores."""
    nbytes = 4 * bh * s * d * 2 + 2 * bh * s * 4 \
        + (2 if dkv else 1) * bh * s * d * 2
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = (8.0 if dkv else 6.0) * bh * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_backend(q, k, v, rate: float = 0.0, causal: bool = False) -> str:
    """The backend that F.scaled_dot_product_attention picks for these
    inputs (torch's own dispatch rule)."""
    from torch.nn.attention import SDPBackend
    choice = int(torch._fused_sdp_choice(q, k, v, dropout_p=rate,
                                         is_causal=causal))
    names = {int(b.value): n for n, b in SDPBackend.__members__.items()}
    return names.get(choice, str(choice))


def sdpa_efficient_bwd_ms(q, k, v, do, rate: float, causal: bool) -> float:
    """Device time of the backward of F.scaled_dot_product_attention's
    EFFICIENT_ATTENTION backend (dq, dk, dv in one call; what SDPA picks
    on the H100 where its flash backend refuses the head dim), by its
    aten op on the forward op's outputs."""
    out, lse, seed, offset = torch.ops.aten \
        ._scaled_dot_product_efficient_attention(q, k, v, None, True, rate,
                                                 causal)
    bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
    return cuda_time_ms(lambda: bwd(do, q, k, v, None, out, lse, seed, offset,
                                    rate, [True, True, True, False], causal))


def fwd_times(seq: int, rate: float, gen, causal: bool = False, b: int = 8,
              h: int = 12, d: int = 64) -> dict:
    """The forward kernel, its plain version and SDPA (with the same
    dropout rate and mask, on the backend it picks, which is named) at b h
    s d bf16."""
    import torch.nn.functional as F
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    q, k, v = (torch.randn(b, h, seq, d, device="cuda", dtype=torch.bfloat16,
                           generator=gen) for _ in range(3))
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=5 if rate else None)
    bound_ms, bound_by = attention_bound_ms(b * h, seq, seq, d, 2, causal)
    return {"ms": cuda_time_ms(lambda: flash_attention(q, k, v, **kw)),
            "plain_ms": cuda_time_ms(
                lambda: flash_attention_plain(q, k, v, **kw)),
            "library_ms": cuda_time_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, dropout_p=rate, is_causal=causal)),
            "library_backend": sdpa_backend(q, k, v, rate, causal),
            "bound_ms": bound_ms, "bound_by": bound_by}


def bwd_times(seq: int, rate: float, gen, causal: bool = False, b: int = 8,
              h: int = 12, d: int = 64) -> dict:
    """dq and dk/dv kernels, their plain versions and the backward of
    torch's SDPA (dq, dk, dv in one call, at the same dropout rate and
    mask) at b h s d bf16: its flash backend's backward op where that
    takes the shape, else its efficient backend's (named in
    ``sdpa_bwd_backend``)."""
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
        flash_attention_bwd_dq_plain)
    import torch.nn.functional as F
    q, k, v, do = (torch.randn(b, h, seq, d, device="cuda",
                               dtype=torch.bfloat16, generator=gen)
                   for _ in range(4))
    kw = dict(causal=causal, sm_scale=1.0 / d ** 0.5, dropout_rate=rate,
              dropout_seed=5 if rate else None)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    # the kernels take the head dim padded to a multiple of 64, as the
    # model's backward hands it to them; the plain versions the model's d
    d_k = -(-d // 64) * 64
    kargs = args if d_k == d else tuple(
        F.pad(t, (0, d_k - d)) for t in (q, k, v, do)) + (lse, delta)
    res = {"dq_ms": cuda_time_ms(
        lambda: flash_attention_bwd_dq(*kargs, **kw)),
           "dkv_ms": cuda_time_ms(
               lambda: flash_attention_bwd_dkv(*kargs, **kw)),
           "dq_plain_ms": cuda_time_ms(
               lambda: flash_attention_bwd_dq_plain(*args, **kw)),
           "dkv_plain_ms": cuda_time_ms(
               lambda: flash_attention_bwd_dkv_plain(*args, **kw))}
    try:
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(
            q, k, v, dropout_p=rate, is_causal=causal)
        out, lse_lib, cq, ck, mq, mk, seed, offset = fwd[:8]
        res["sdpa_bwd_ms"] = cuda_time_ms(
            lambda: torch.ops.aten
            ._scaled_dot_product_flash_attention_backward(
                do, q, k, v, out, lse_lib, cq, ck, mq, mk, rate, causal,
                seed, offset))
        res["sdpa_bwd_backend"] = "FLASH_ATTENTION"
    except RuntimeError as e:   # the flash backend refuses the shape
        res["sdpa_bwd_ms"] = sdpa_efficient_bwd_ms(q, k, v, do, rate, causal)
        res["sdpa_bwd_backend"] = "EFFICIENT_ATTENTION"
        print(f"[ktimes] sdpa flash backward refuses b{b} h{h} s{seq} d{d}: "
              f"{str(e).splitlines()[0][:120]}; timed the EFFICIENT_ATTENTION "
              f"backward instead (SDPA picks "
              f"{sdpa_backend(q, k, v, rate, causal)} here)")
    res["dq_bound"] = bwd_bound_ms(b * h, seq, d, False, causal)
    res["dkv_bound"] = bwd_bound_ms(b * h, seq, d, True, causal)
    return res


def adam_times(gen, shapes) -> dict:
    """The fused Adam kernel, its plain version and torch._fused_adam_
    (a timing yardstick only: its eps placement differs) over f32 leaves
    of ``shapes``."""
    from flexflow_tpu_torch.kernels.opt_update import (
        fused_adam_update, fused_adam_update_plain)
    leaves = adam_leaves(gen, shapes, [torch.float32] * len(shapes))
    ws, gs, ms, vs = ([x[i] for x in leaves] for i in range(4))
    alpha_t = torch.tensor(1e-4, device="cuda")
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=0.0)
    res = {"ms": cuda_time_ms(
        lambda: fused_adam_update(ws, gs, ms, vs, alpha_t, **kw), iters=5),
        "plain_ms": cuda_time_ms(
            lambda: [fused_adam_update_plain(w, g, m, v, alpha_t, **kw)
                     for w, g, m, v in leaves], iters=2)}
    steps = [torch.ones((), device="cuda") for _ in leaves]
    res["library_ms"] = cuda_time_ms(
        lambda: torch._fused_adam_(ws, gs, ms, vs, [], steps, lr=1e-4,
                                   beta1=0.9, beta2=0.999, weight_decay=0.0,
                                   eps=1e-8, amsgrad=False, maximize=False),
        iters=5)
    n = sum(w.numel() for w in ws)
    res["bound_ms"] = 28.0 * n / HBM_BYTES_PER_S * 1e3
    res["numel"] = n
    return res


def launch_host_us(n: int = 500) -> dict:
    """Host time of one call of the forward's and the dq kernel's C entry
    (ctypes, no Python wrapper) at b8 h12 s128 d64 bf16: each encodes
    four TMA tensor maps per launch (the forward q, k, v, o; dq q, do, k,
    v)."""
    fa = importlib.import_module("flexflow_tpu_torch.kernels.flash_attention")
    q, k, v, do, o = (torch.randn(8, 12, 128, 64, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(5))
    lse, delta = (torch.zeros(8, 12, 128, device="cuda") for _ in range(2))
    stream = torch.cuda.current_stream().cuda_stream
    tail = (96, 128, 128, 64, 1, 0, 0.125, 0, 0, 1.0, 0, stream)
    calls = {
        "fwd": (fa._c_fn("flash_attention_fwd", "ff_flash_attention_fwd"),
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr()) + tail),
        "dq": (fa._c_fn("flash_attention_bwd", "ff_flash_attention_bwd_dq"),
               (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), o.data_ptr()) + tail)}
    res = {}
    for name, (fn, args) in calls.items():
        check(fn(*args) == 0, f"{name} launch failed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        res[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return res


# further kernel timings: (key, kernel, b, h, s, d, causal, what)
KT_SHAPES = [
    ("fwd_d128_causal", "fwd", 4, 32, 1024, 128, True,
     "LLaMA-7B's prefill, 32 launches per prefill"),
    ("fwd_d128", "fwd", 8, 12, 512, 128, False, "head dim 128"),
    ("bwd_d64_causal", "bwd", 8, 12, 1024, 64, True, "causal backward"),
    ("bwd_d128_causal", "bwd", 2, 32, 1024, 128, True,
     "LLaMA-7B's training shape, 2 launches per step"),
    ("fwd_d256", "fwd", 4, 8, 512, 256, False, "the wide kernel"),
    ("bwd_d256", "bwd", 4, 8, 512, 256, False, "the wide kernels"),
    ("fwd_d320", "fwd", 4, 8, 512, 320, False, "the wide kernel"),
    ("bwd_d320", "bwd", 4, 8, 512, 320, False, "the wide kernels"),
    ("fwd_d512", "fwd", 4, 8, 512, 512, False, "the wide kernel"),
    ("bwd_d512", "bwd", 4, 8, 512, 512, False, "the wide kernels"),
    ("fwd_nmt", "fwd", 64, 1, 128, 512, False,
     "NMT's attention: NMTConfig's hidden 512 in one head, a 128-token "
     "sentence"),
    ("bwd_nmt", "bwd", 64, 1, 128, 512, False, "NMT's attention"),
    ("fwd_transformer", "fwd", 64, 8, 512, 8, False,
     "the Transformer's attention: TransformerConfig's kdim = hidden / "
     "heads = 64 split over 8 heads, d 8, padded to 64 by the wrapper"),
    ("bwd_transformer", "bwd", 64, 8, 512, 8, False,
     "the Transformer's attention, the kernels at the padded d 64"),
]


def phase_ktimes(smi: str) -> dict:
    """Every kernel's device time beside its plain version, its PyTorch
    yardstick and its bound: the flash kernels at s 128 and 512, without
    dropout and at 0.1, causal at GPT-2's prefill, at KT_SHAPES (LLaMA's
    and Mixtral's head dim 128, the causal backward, head dims 256, 320
    and 512, NMT's b64 h1 s128 d512), and Adam over BERT-base."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    res = {"fwd": {}, "bwd": {}}
    for rate in (0.0, 0.1):
        for seq in (128, 512):
            f = res["fwd"][(seq, rate)] = fwd_times(seq, rate, gen)
            print(f"[ktimes] flash_attention_fwd b8 h12 s{seq} d64 bf16 "
                  f"dropout {rate}: kernel {f['ms'] * 1e3:.2f} us, plain "
                  f"{f['plain_ms'] * 1e3:.2f} us, sdpa "
                  f"{f['library_ms'] * 1e3:.2f} us, bound "
                  f"{f['bound_ms'] * 1e3:.2f} us ({f['bound_by']}); "
                  f"kernel/sdpa {f['ms'] / f['library_ms']:.2f}, "
                  f"kernel/bound {f['ms'] / f['bound_ms']:.2f}")
            t = res["bwd"][(seq, rate)] = bwd_times(seq, rate, gen)
            for key, name in (("dq", "flash_attention_bwd_dq"),
                              ("dkv", "flash_attention_bwd_dkv")):
                bound, by = t[key + "_bound"]
                print(f"[ktimes] {name} b8 h12 s{seq} d64 bf16 dropout "
                      f"{rate}: kernel {t[key + '_ms'] * 1e3:.2f} us, plain "
                      f"{t[key + '_plain_ms'] * 1e3:.2f} us, bound "
                      f"{bound * 1e3:.2f} us ({by}); kernel/sdpa-backward "
                      f"{t[key + '_ms'] / t['sdpa_bwd_ms']:.2f}, "
                      f"kernel/bound {t[key + '_ms'] / bound:.2f}")
            print(f"[ktimes] sdpa flash backward (dq, dk, dv in one call) b8 "
                  f"h12 s{seq} d64 bf16 dropout {rate}: "
                  f"{t['sdpa_bwd_ms'] * 1e3:.2f} us vs dq + dk/dv "
                  f"{(t['dq_ms'] + t['dkv_ms']) * 1e3:.2f} us")
    f = res["fwd_causal"] = fwd_times(GPT_SEQ, 0.0, gen, causal=True)
    print(f"[ktimes] flash_attention_fwd b8 h12 s{GPT_SEQ} d64 bf16 causal "
          f"(GPT-2 small's prefill, {GPT_LAYERS} launches per prefill): "
          f"kernel {f['ms'] * 1e3:.2f} us, plain {f['plain_ms'] * 1e3:.2f} "
          f"us, sdpa is_causal {f['library_ms'] * 1e3:.2f} us, bound "
          f"{f['bound_ms'] * 1e3:.2f} us ({f['bound_by']}); kernel/sdpa "
          f"{f['ms'] / f['library_ms']:.2f}, kernel/bound "
          f"{f['ms'] / f['bound_ms']:.2f}; {smi}")
    for key, kind, b, hh, seq, d, causal, what in KT_SHAPES:
        shape = f"b{b} h{hh} s{seq} d{d} bf16{' causal' if causal else ''}"
        if kind == "fwd":
            f = res[key] = fwd_times(seq, 0.0, gen, causal, b, hh, d)
            print(f"[ktimes] flash_attention_fwd {shape} ({what}): kernel "
                  f"{f['ms'] * 1e3:.2f} us, plain {f['plain_ms'] * 1e3:.2f} "
                  f"us, sdpa ({f['library_backend']}) "
                  f"{f['library_ms'] * 1e3:.2f} us, bound "
                  f"{f['bound_ms'] * 1e3:.2f} us ({f['bound_by']}); "
                  f"kernel/sdpa {f['ms'] / f['library_ms']:.2f}, "
                  f"kernel/bound {f['ms'] / f['bound_ms']:.2f}; {smi}")
            continue
        t = res[key] = bwd_times(seq, 0.0, gen, causal, b, hh, d)
        lib = t["sdpa_bwd_ms"]
        for k_, name in (("dq", "flash_attention_bwd_dq"),
                         ("dkv", "flash_attention_bwd_dkv")):
            bound, by = t[k_ + "_bound"]
            print(f"[ktimes] {name} {shape} ({what}): kernel "
                  f"{t[k_ + '_ms'] * 1e3:.2f} us, plain "
                  f"{t[k_ + '_plain_ms'] * 1e3:.2f} us, bound "
                  f"{bound * 1e3:.2f} us ({by}); kernel/bound "
                  f"{t[k_ + '_ms'] / bound:.2f}; {smi}")
        print(f"[ktimes] sdpa backward ({t['sdpa_bwd_backend']}; dq, dk, "
              f"dv in one call) {shape}: {lib * 1e3:.2f} us vs dq + dk/dv "
              f"{(t['dq_ms'] + t['dkv_ms']) * 1e3:.2f} us")
    h = res["host"] = launch_host_us()
    print(f"[ktimes] host time of one C launch call (ctypes) b8 h12 s128 d64 "
          f"bf16, each encoding four TMA tensor maps: flash_attention_fwd "
          f"{h['fwd']:.2f} us, flash_attention_bwd_dq {h['dq']:.2f} us")
    for key, what, shapes in (("adam", "BERT-base", bert_leaf_shapes()),
                              ("adam_dlrm", "DLRM", dlrm_leaf_shapes())):
        a = res[key] = adam_times(gen, shapes)
        print(f"[ktimes] adam_update over {what}'s {a['numel']} f32 "
              f"parameters ({len(shapes)} leaves, one launch): kernel "
              f"{a['ms']:.4f} ms, plain {a['plain_ms']:.4f} ms, "
              f"torch._fused_adam_ {a['library_ms']:.4f} ms, bound "
              f"{a['bound_ms']:.4f} ms (bytes); kernel/bound "
              f"{a['ms'] / a['bound_ms']:.2f}; {smi}")
        free_cuda()
    return res


# the A/B's shapes: (kernel, b, h, s, d, causal, dtype); f32 above d 128
# runs the wide FMA forward
AB_SHAPES = [(*s, torch.bfloat16) for s in
             [("fwd", 8, 12, 128, 64, False), ("fwd", 8, 12, 512, 64, False),
              ("fwd", 8, 12, GPT_SEQ, 64, True)]
             + [s[1:7] for s in KT_SHAPES]] + [
    ("fwd", 4, 8, 512, 192, False, torch.float32),
    ("fwd", 4, 8, 512, 256, False, torch.float32)]


def ab_build(trees: dict) -> dict:
    """tag -> source -> the loaded flash library of the checkout at each
    root, built with the port's nvcc flags into build/ab/<tag>/, one nvcc
    per source, all at once."""
    from flexflow_tpu_torch.kernels import build
    procs, libs = [], {}
    for tag, root in trees.items():
        out = os.path.join(os.path.dirname(build.BUILD_DIR), "ab", tag)
        os.makedirs(out, exist_ok=True)
        for src in KERNELS[:2]:
            so = os.path.join(out, f"{src}.so")
            cu = os.path.join(root, "flexflow_tpu_torch", "csrc", f"{src}.cu")
            procs.append((tag, src, so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for tag, src, so, proc in procs:
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc {tag}/{src}:\n{log}")
        libs.setdefault(tag, {})[src] = ctypes.CDLL(so)
    return libs


def phase_ab(base: str, smi: str) -> None:
    """The flash kernels of the checkout at ``base`` (for example the
    parent commit, unpacked with ``git archive`` into the git-ignored
    build/) and of this one, each at AB_SHAPES on the same seeded
    inputs, timed by cuda_time_ms in the order base, change, change,
    base: how a kernel change is compared within one call. A shape the
    base refuses is skipped. Prints a line per kernel and shape, then a
    JSON line."""
    import torch.nn.functional as F
    fa = importlib.import_module("flexflow_tpu_torch.kernels.flash_attention")
    t0 = time.perf_counter()
    libs = ab_build({"base": os.path.abspath(base),
                     "change": os.path.dirname(os.path.abspath(__file__))})
    print(f"[ab] built both trees in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for kind, b, h, s, d, causal, dt in AB_SHAPES:
        shape = (f"b{b} h{h} s{s} d{d} {str(dt)[6:]}"
                 f"{' causal' if causal else ''}")
        q, k, v, do = (torch.randn(b, h, s, d, device="cuda", dtype=dt,
                                   generator=gen) for _ in range(4))
        o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        lse, delta = (torch.empty(b, h, s, device="cuda") for _ in range(2))
        tail = (b * h, s, s, d, int(dt == torch.bfloat16), int(causal),
                d ** -0.5, 0, 0, 1.0, 0)

        def launch(tag, src, sym, ts):
            fn = getattr(libs[tag][src], sym)
            fn.argtypes, fn.restype = fa._ARGTYPES[(src, sym)], ctypes.c_int
            args = [t.data_ptr() for t in ts] + list(tail)
            # the stream is read at each call, so a graph capture records it
            return lambda: fn(*args, torch.cuda.current_stream().cuda_stream)

        fwd = ("flash_attention_fwd", "ff_flash_attention_fwd",
               (q, k, v, o, lse))
        check(launch("change", *fwd)() == 0, f"forward launch at {shape}")
        delta.copy_((do.float() * o.float()).sum(-1))
        bwd = [("flash_attention_bwd", "ff_flash_attention_bwd_dq",
                (q, k, v, do, lse, delta, dq)),
               ("flash_attention_bwd", "ff_flash_attention_bwd_dkv",
                (q, k, v, do, lse, delta, dk, dv))]
        for src, sym, ts in [fwd] if kind == "fwd" else bwd:
            fns = {tag: launch(tag, src, sym, ts) for tag in libs}
            if fns["base"]() != 0:
                print(f"[ab] {sym} {shape}: the base tree refuses it")
                continue
            us = [cuda_time_ms(fns[t]) * 1e3
                  for t in ("base", "change", "change", "base")]
            row = {"kernel": sym, "shape": shape, "base_us": us[::3],
                   "change_us": us[1:3]}
            if kind == "fwd":
                row["sdpa_us"] = cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal)) * 1e3
            rows.append(row)
            print(f"[ab] {sym} {shape}: base {np.mean(us[::3]):.2f} us "
                  f"({us[0]:.2f}, {us[3]:.2f}), change "
                  f"{np.mean(us[1:3]):.2f} us ({us[1]:.2f}, {us[2]:.2f})"
                  + (f", sdpa {row['sdpa_us']:.2f} us" if "sdpa_us" in row
                     else "") + f"; {smi}")
    print(json.dumps({"ab": rows, "card": smi}))


def gpt2_model(impl: str):
    """Full-width GPT-2 small (12 layers, hidden 768, 12 heads, vocab
    50257, 1024 positions; seeded random weights) built through FFModel
    at 8 x 1024 with bf16 matmul operands and f32 results."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import GPTConfig, build_gpt2
    cfg = FFConfig()
    cfg.batch_size = 8
    cfg.only_data_parallel = True
    cfg.kernel_impls = impl
    cfg.seed = 0
    ff = FFModel(cfg)
    g = GPTConfig()
    out = build_gpt2(ff, 8, GPT_SEQ, g)
    ff.compile(SGDOptimizer(0.01), "sparse_categorical_crossentropy", [],
               output_tensor=out)
    return ff, g


def gpt_prompts(rows: int, plens, vocab: int, seed: int,
                seq: int = GPT_SEQ) -> np.ndarray:
    """(rows, seq) int32 ids: seeded random prompts in the first plens[r]
    columns of each row, zeros after."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((rows, seq), np.int32)
    for r, n in enumerate(np.broadcast_to(plens, (rows,))):
        ids[r, :n] = rng.integers(0, vocab, n)
    return ids


def no_fallback(ff, what: str) -> None:
    n = getattr(ff, "_kv_fallback_count", 0)
    check(n == 0, f"{what}: the KV path fell back to the re-forward {n} "
                  f"times")


def check_tokens(out, ids, plens, steps, vocab, what) -> None:
    """Prompt columns unchanged, generated ones in the vocabulary."""
    for r, n in enumerate(np.broadcast_to(plens, (out.shape[0],))):
        check(out.shape == ids.shape and (out[r, :n] == ids[r, :n]).all()
              and ((out[r, n:n + steps] >= 0)
                   & (out[r, n:n + steps] < vocab)).all(),
              f"{what}: row {r} tokens")


def gpt_batch(ids_np: np.ndarray) -> dict:
    """A graph batch on the card: the ids and their positions (a graph
    without a position input, as LLaMA's, ignores them)."""
    ids = torch.from_numpy(ids_np).cuda()
    return {"input_ids": ids,
            "position_ids": torch.arange(ids.shape[1], dtype=torch.int32,
                                         device=ids.device)[None]
            .expand(ids.shape[0], -1)}


def vocab_of(ff) -> int:
    """The vocabulary of an LM graph: the width of its output."""
    return ff.executor.program.output_tensors[0].shape[-1]


def prefill(ff, batch: dict, plen: int) -> dict:
    return ff.executor.kv_prefill(ff.params, ff.state, batch,
                                  prefill_len=plen)


def decode_step(ff, batch: dict, cache: dict, cur: int) -> tuple:
    """One KV decode step reading token cur - 1 of the batch's ids."""
    sb = {k: v[:, cur - 1:cur] for k, v in batch.items()}
    return ff.executor.kv_decode_step(ff.params, ff.state, sb, cache,
                                      cur - 1)


@contextlib.contextmanager
def attention_plan(ff, impl: str):
    """``ff`` with every attention layer on ``impl`` (the same weights
    through another attention path), its own plan restored after."""
    ex = ff.executor
    saved = ex._kernel_impls
    ex._kernel_impls = {"attention": impl}
    try:
        yield ff
    finally:
        ex._kernel_impls = saved


def gen_rows_check(ff, ids_np, plen: int, steps: int) -> dict:
    """The KV path's score rows over ``steps`` greedy decode steps (its
    own tokens fed back) against the re-forward rows at the same positions
    through the model's own plan ("reforward", flash) and through plain
    attention on the same weights ("xla"): the row
    ``_generate_reforward`` reads at each step is ``scored_forward(ids)[:,
    cur - 1]``, and under the causal mask it is the same row of one
    forward over the final ids. Rows agree within GEN_TOL of the reference
    row's logit range; the greedy tokens agree wherever the reference
    row's top-1/top-2 margin exceeds twice the measured difference (each
    of the two scores moves by at most it)."""
    with torch.inference_mode():
        batch = gpt_batch(ids_np)
        ids = batch["input_ids"]
        cache = prefill(ff, batch, plen)
        kv_rows = []
        for cur in range(plen, plen + steps):
            row, cache = decode_step(ff, batch, cache, cur)
            kv_rows.append(row.float())
            ids[:, cur] = torch.argmax(row, dim=-1).to(torch.int32)
        kv_rows = torch.stack(kv_rows, dim=1)           # (B, steps, V)
        del cache
        res = {"tokens": ids[:, plen:plen + steps].cpu().numpy()}
        for name in ("reforward", "xla"):
            with (attention_plan(ff, "xla") if name == "xla"
                  else contextlib.nullcontext()):
                scores = ff.executor.scored_forward(ff.params, ff.state,
                                                    batch)
            want = scores[:, plen - 1:plen - 1 + steps].float()
            del scores
            diff = (kv_rows - want).abs().amax(dim=-1)
            span = want.amax(dim=-1) - want.amin(dim=-1)
            top2 = want.topk(2, dim=-1).values
            margin = top2[..., 0] - top2[..., 1]
            same = torch.argmax(kv_rows, -1) == torch.argmax(want, -1)
            decided = margin > 2 * diff
            rel = (diff / span).max().item()
            res[name] = {"max_abs": diff.max().item(), "max_rel": rel,
                         "tokens_equal": int(same.sum().item()),
                         "decided": int(decided.sum().item()),
                         "ok": bool(rel <= GEN_TOL
                                    and same[decided].all().item()
                                    and torch.isfinite(kv_rows).all()
                                    .item())}
            del want
    return res


def parted_at_ties(ff, a: np.ndarray, b: np.ndarray) -> tuple:
    """Two greedy runs from one prompt whose computations differ (a
    segmented run re-prefills what the single hold decoded) may part
    only at a near tie: at each row's first differing position, the two
    tokens' scores in the re-forward row of run ``a`` lie within GEN_TOL
    of the row's logit range. Returns (rows equal throughout, the
    largest such gap relative to the range)."""
    with torch.inference_mode():
        scores = ff.executor.scored_forward(ff.params, ff.state,
                                            gpt_batch(a))
        equal, worst = 0, 0.0
        for r in range(a.shape[0]):
            d = np.flatnonzero(a[r] != b[r])
            if not d.size:
                equal += 1
                continue
            row = scores[r, d[0] - 1].float()
            gap = (row[int(a[r, d[0]])] - row[int(b[r, d[0]])]).abs() \
                / (row.max() - row.min())
            worst = max(worst, gap.item())
    return equal, worst


def decode_step_times(ff, rows: int, plen: int, steps: int,
                      profile: bool = False):
    """Host-clock time of each of ``steps`` greedy KV decode steps at
    ``rows`` rows after one prefill, each ending in a device sync; with
    ``profile``, also a torch.profiler trace of the steps (not of the
    prefill)."""
    seq = ff.graph_inputs[0].shape[1]
    batch = gpt_batch(gpt_prompts(rows, plen, vocab_of(ff), 20 + rows, seq))
    done = torch.zeros(rows, dtype=torch.bool,
                       device=batch["input_ids"].device)
    lat = []
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile \
        else contextlib.nullcontext()
    with torch.inference_mode():
        cache = prefill(ff, batch, plen)
        torch.cuda.synchronize()
        with prof:
            for cur in range(plen, plen + steps):
                t0 = time.perf_counter()
                row, cache = decode_step(ff, batch, cache, cur)
                nxt, done = ff._sample_next(row, None, 0.0, None, done)
                ff._write_token(batch["input_ids"], nxt, cur, False)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
    return lat, (prof if profile else None)


def profile_decode(ff, rows: int, plen: int, steps: int) -> dict:
    """torch.profiler over ``steps`` KV decode steps at ``rows`` rows:
    kernel launches, device kernel time and wall time per step, and the
    kernels that take the most device time."""
    from collections import defaultdict
    decode_step_times(ff, rows, plen, 2)
    lat, prof = decode_step_times(ff, rows, plen, steps, profile=True)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"launches_per_step": len(kernels) / steps,
            "device_ms_per_step": sum(by_name.values()),
            "wall_ms_per_step": float(np.mean(lat)),
            "top": [(n[:70], ms) for n, ms in top]}


def phase_generate(smi: str) -> dict:
    """The generation path: full-width GPT-2 small through
    InferenceSession.generate with kernel_impls="attention:flash"."""
    from flexflow_tpu_torch.serving import InferenceSession
    ff, g = gpt2_model("attention:flash")
    V = g.vocab_size
    sess = InferenceSession(ff, batch_buckets=(1, 8), decode_segment=0)
    seg_sess = InferenceSession(ff, batch_buckets=(1, 8), decode_segment=16)
    p8 = gpt_prompts(8, 512, V, 1)
    ragged_plen = np.array([100, 517, 900], np.int32)
    p3 = gpt_prompts(3, ragged_plen, V, 2)
    p1 = gpt_prompts(1, 256, V, 3)
    samp = dict(temperature=0.8, top_k=50, top_p=0.95)
    torch.cuda.synchronize()
    # the main path: every count starts at 0 here; each generate call
    # runs one prefill per segment (12 flash launches) and none per
    # decode step
    fwd = zero_counts()["flash_attention_fwd"]
    outs, prefills = {}, 0
    t0 = time.perf_counter()
    outs["greedy8"] = sess.generate(p8, 512, GEN_TOKENS)
    outs["ragged"] = sess.generate(p3, ragged_plen, GEN_TOKENS)
    eos = int(outs["ragged"][0, 100 + 3])
    outs["ragged_eos"] = sess.generate(p3, ragged_plen, GEN_TOKENS,
                                       eos_token_id=eos)
    outs["beam"] = sess.generate(p1, 256, 16, num_beams=4)
    outs["sample_a"] = sess.generate(p8, 512, 32, seed=7, **samp)
    outs["sample_b"] = sess.generate(p8, 512, 32, seed=7, **samp)
    outs["sample_c"] = sess.generate(p8, 512, 32, seed=8, **samp)
    prefills = len(outs)
    no_fallback(ff, "single-hold requests")
    outs["segmented"] = seg_sess.generate(p8, 512, GEN_TOKENS)
    prefills += -(-GEN_TOKENS // 16)
    no_fallback(ff, "segmented greedy")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = fwd.launches
    print(f"[generate] main path: GPT-2 small (12 layers, hidden 768, 12 "
          f"heads, vocab {V}) through InferenceSession.generate, "
          f"{len(outs)} requests, {prefills} prefills in {main_s:.2f} s; "
          f"flash_attention_fwd launches {launches} (want {GPT_LAYERS} x "
          f"{prefills} prefills, 0 per decode step); no KV fallback")
    check(launches == GPT_LAYERS * prefills,
          f"generate: flash launches {launches} != {GPT_LAYERS} x "
          f"{prefills}")

    # what came out
    check_tokens(outs["greedy8"], p8, 512, GEN_TOKENS, V, "greedy")
    check_tokens(outs["ragged"], p3, ragged_plen, GEN_TOKENS, V, "ragged")
    check_tokens(outs["beam"], p1, 256, 16, V, "beam")
    check_tokens(outs["sample_a"], p8, 512, 32, V, "sampling")
    # eos latches: each row equals its free run through the first eos it
    # emits and is eos after it (row 0 emits it by step 3)
    for r, n in enumerate(ragged_plen):
        row = outs["ragged_eos"][r, n:n + GEN_TOKENS]
        free = outs["ragged"][r, n:n + GEN_TOKENS]
        hit = np.flatnonzero(free == eos)
        upto = hit[0] if hit.size else GEN_TOKENS
        check((row[:upto] == free[:upto]).all() and (row[upto:] == eos).all()
              and (r > 0 or upto <= 3), f"eos does not latch on row {r}")
    check((outs["sample_a"] == outs["sample_b"]).all(),
          "sampling with one seed is not repeatable")
    check((outs["sample_a"][:, 512:544] != outs["sample_c"][:, 512:544]).any(),
          "sampling with two seeds gave the same tokens")
    seg_equal, seg_gap = parted_at_ties(ff, outs["greedy8"],
                                        outs["segmented"])
    check(seg_gap <= GEN_TOL, "segmented greedy parts from the single hold "
                              "where the two tokens do not tie")
    print(f"[generate] outputs: prompts kept, tokens in the vocabulary; "
          f"eos {eos} latches on row 0 by step 3 of {GEN_TOKENS}; "
          f"sampling (T 0.8, top-k 50, top-p 0.95, 32 tokens) repeats with "
          f"one seed and differs with another; greedy in segments of 16 "
          f"(its later segments re-prefill what the single hold decoded) "
          f"equals the single hold in {seg_equal} of 8 rows, the others "
          f"part at a near tie (the two tokens' scores {seg_gap:.2e} of "
          f"the row's range apart, tol {GEN_TOL:.0e}); ok")

    # FFModel.generate called directly: 12 launches, the KV path only
    fwd = zero_counts()["flash_attention_fwd"]
    direct = ff.generate(p8, 512, 8, kv_cache=True).cpu().numpy()
    no_fallback(ff, "FFModel.generate")
    check(fwd.launches == GPT_LAYERS,
          f"one generate call launched the forward "
          f"{fwd.launches} times, want {GPT_LAYERS}")
    check((direct[:, :520] == outs["greedy8"][:, :520]).all(),
          "FFModel.generate differs from the session's greedy run")

    # score rows of the KV path against the re-forward (flash) and the
    # same weights through plain attention
    rows = gen_rows_check(ff, p8, 512, 8)
    check((rows["tokens"] == outs["greedy8"][:, 512:520]).all(),
          "the phase's decode loop differs from generate's")
    for name in ("reforward", "xla"):
        r = rows[name]
        print(f"[generate] 8 decode steps x 8 rows, KV path vs {name} "
              f"re-forward rows: max|diff| {r['max_abs']:.3e}, "
              f"{r['max_rel']:.2e} of the row's logit range (tol "
              f"{GEN_TOL:.0e}); greedy tokens equal in {r['tokens_equal']} "
              f"of 64, {r['decided']} decided by a top-2 margin above twice "
              f"the difference, all of those equal: "
              f"{'ok' if r['ok'] else 'FAIL'}")
        check(r["ok"], f"KV decode rows vs {name}")
    res = {"launches": launches, "prefills": prefills, "rows": rows}
    res.update(generate_times(ff, sess, p8, smi))
    return res


def generate_times(ff, sess, prompts, smi: str, name: str = "gpt2-small",
                   plen: int = 512, tokens: int = GEN_TOKENS,
                   rows=(1, 8), profile: bool = True) -> dict:
    """Prefill and decode-step latencies, tokens/s, the peak memory of a
    generate call and (``profile``) a profile of the decode step, for the
    LM ``ff`` on ``prompts`` (all rows, ``plen`` tokens each)."""
    from flexflow_tpu_torch import OperatorType
    n, seq = prompts.shape
    layers = sum(1 for l in ff.executor.program.layers
                 if l.op_type == OperatorType.OP_MULTIHEAD_ATTENTION)
    lat = []
    with torch.inference_mode():
        batch = gpt_batch(prompts)
        for _ in range(6):
            t0 = time.perf_counter()
            prefill(ff, batch, plen)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
    res = {"prefill_ms": float(np.median(lat[1:]))}
    print(f"[times] {name} prefill {n}x{seq} (the layers the K/V depend "
          f"on, {layers} flash launches): median {res['prefill_ms']:.3f} ms "
          f"over 5 (host clock, ends in a device sync); {smi}")
    for b in rows:
        lat, _ = decode_step_times(ff, b, plen, tokens)
        ff._decode_measured = {}
        ff.generate(prompts[:b], plen, tokens, kv_cache=True)
        no_fallback(ff, f"timed generate at {b} rows")
        m = ff._decode_measured[b]
        res[b] = {"step_ms": float(np.median(lat)),
                  "step_p90_ms": float(np.percentile(lat, 90)),
                  "gen_step_ms": m["decode_step_s"] * 1e3,
                  "gen_prefill_ms": m["prefill_s"] * 1e3,
                  "tokens_per_s": b / m["decode_step_s"]}
        print(f"[times] {name} decode step at {b} rows (cache of {seq}): "
              f"median {res[b]['step_ms']:.3f} ms, p90 "
              f"{res[b]['step_p90_ms']:.3f} ms over {tokens} steps (host "
              f"clock, each ends in a device sync); one FFModel.generate "
              f"of {tokens} tokens: prefill "
              f"{res[b]['gen_prefill_ms']:.3f} ms, "
              f"{res[b]['gen_step_ms']:.3f} ms per token, "
              f"{res[b]['tokens_per_s']:.1f} tokens/s; {smi}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sess.generate(prompts, plen, tokens)
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["resident_gb"] = base / 1e9
    print(f"[times] {name} peak device memory of one {n}-row {tokens}-token "
          f"generate: {res['peak_mem_gb']:.3f} GB ({res['resident_gb']:.3f} "
          f"GB resident before it; the prefill frees each activation after "
          f"its last reader); {smi}")
    if not profile:
        return res
    p = res["profile"] = profile_decode(ff, n, plen, 8)
    print(f"[profile] {name} decode step at {n} rows (torch.profiler, 8 "
          f"steps): {p['launches_per_step']:.0f} kernel launches, device "
          f"kernel time {p['device_ms_per_step']:.3f} ms in a wall of "
          f"{p['wall_ms_per_step']:.3f} ms per step (busy share "
          f"{p['device_ms_per_step'] / p['wall_ms_per_step']:.3f}); most "
          f"device time: "
          + "; ".join(f"{n_} {ms:.4f} ms" for n_, ms in p["top"]))
    return res


LLAMA_LAYERS = 32                  # generation depth, of LLaMA-7B's 32
LLAMA_SEQ, LLAMA_ROWS = 1024, 4    # LLaMA-7B generation, 4 x 1024
LLAMA_PLEN, LLAMA_TOKENS = 512, 32  # prompt, new tokens per generate
LLAMA_RAGGED = (100, 517, 900)     # ragged prompt lengths
LLAMA_SHORT = 2                    # depth of the primitive and train checks
LLAMA_PRIM_SEQ = 256               # sequence of the primitive-form check


def llama_model(impl: str, layers: int = 0, batch: int = LLAMA_ROWS,
                seq: int = LLAMA_SEQ, fused: bool = True, optimizer=None):
    """LLaMA-7B's width (hidden 4096, FFN 11008, 32 heads of 128, vocab
    32000; seeded random weights, initialised on the card) at ``layers``
    layers (all 32 by default), built through FFModel with bf16 matmul
    operands and f32 results."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import LlamaConfig, build_llama
    cfg = FFConfig()
    cfg.batch_size = batch
    cfg.only_data_parallel = True
    cfg.kernel_impls = impl
    cfg.seed = 0
    ff = FFModel(cfg)
    lc = LlamaConfig()
    lc.num_layers = layers or lc.num_layers
    out = build_llama(ff, batch, seq, lc, fused_attention=fused)
    ff.compile(optimizer or SGDOptimizer(0.01),
               "sparse_categorical_crossentropy", [], output_tensor=out)
    return ff, lc


def lm_generate(ff, tag: str, what: str, smi: str, seed: int) -> dict:
    """A causal LM built at LLAMA_ROWS x LLAMA_SEQ with "attention:flash"
    generating through InferenceSession.generate (the llama and mixtral
    phases): greedy over LLAMA_ROWS rows of LLAMA_PLEN-token prompts,
    ragged prompts, and ragged with eos; one flash launch per layer per
    prefill and none per decode step, no KV fallback; the KV path's score
    rows against the re-forward through flash and through plain attention;
    then the times of generate_times."""
    from flexflow_tpu_torch import OperatorType
    from flexflow_tpu_torch.serving import InferenceSession
    V = vocab_of(ff)
    L = sum(1 for l in ff.executor.program.layers
            if l.op_type == OperatorType.OP_MULTIHEAD_ATTENTION)
    sess = InferenceSession(ff, batch_buckets=(1, LLAMA_ROWS))
    plen = LLAMA_PLEN
    p4 = gpt_prompts(LLAMA_ROWS, plen, V, seed, LLAMA_SEQ)
    ragged_plen = np.array(LLAMA_RAGGED, np.int32)
    p3 = gpt_prompts(3, ragged_plen, V, seed + 1, LLAMA_SEQ)
    torch.cuda.synchronize()
    # the main path: every count starts at 0 here; each generate call
    # runs one prefill (L flash launches) and none per decode step
    fwd = zero_counts()["flash_attention_fwd"]
    outs = {}
    t0 = time.perf_counter()
    outs["greedy"] = sess.generate(p4, plen, LLAMA_TOKENS)
    outs["ragged"] = sess.generate(p3, ragged_plen, LLAMA_TOKENS)
    eos = int(outs["ragged"][0, ragged_plen[0] + 3])
    outs["ragged_eos"] = sess.generate(p3, ragged_plen, LLAMA_TOKENS,
                                       eos_token_id=eos)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    prefills = len(outs)
    launches = fwd.launches
    no_fallback(ff, f"{what} generate")
    print(f"[{tag}] main path: {what} through InferenceSession.generate, "
          f"{prefills} requests of {LLAMA_TOKENS} tokens ({LLAMA_ROWS} rows "
          f"of {plen}-token prompts; 3 ragged prompts {ragged_plen.tolist()} "
          f"padded to {LLAMA_ROWS}, then with eos) in {main_s:.2f} s; "
          f"flash_attention_fwd launches {launches} (want {L} x {prefills} "
          f"prefills, 0 per decode step); no KV fallback")
    check(launches == L * prefills,
          f"{tag}: flash launches {launches} != {L} x {prefills}")
    check_tokens(outs["greedy"], p4, plen, LLAMA_TOKENS, V, f"{tag} greedy")
    check_tokens(outs["ragged"], p3, ragged_plen, LLAMA_TOKENS, V,
                 f"{tag} ragged")
    for r, n in enumerate(ragged_plen):
        row = outs["ragged_eos"][r, n:n + LLAMA_TOKENS]
        free = outs["ragged"][r, n:n + LLAMA_TOKENS]
        hit = np.flatnonzero(free == eos)
        upto = hit[0] if hit.size else LLAMA_TOKENS
        check((row[:upto] == free[:upto]).all() and (row[upto:] == eos).all()
              and (r > 0 or upto <= 3), f"{tag}: eos does not latch on "
                                        f"row {r}")

    # one prefill and one decode step alone: L launches, then none
    with torch.inference_mode():
        batch = gpt_batch(p4)
        zero_counts()
        cache = prefill(ff, batch, plen)
        torch.cuda.synchronize()
        per_prefill = fwd.launches
        decode_step(ff, batch, cache, plen)
        torch.cuda.synchronize()
        per_step = fwd.launches - per_prefill
        del cache, batch
    print(f"[{tag}] flash_attention_fwd launches: {per_prefill} in one "
          f"prefill (want {L}), {per_step} in one decode step (want 0)")
    check(per_prefill == L and per_step == 0,
          f"{tag}: {per_prefill} launches per prefill, {per_step} per "
          f"decode step")

    # score rows of the KV path (RoPE at kv_index, cached keys rotated)
    # against the re-forward through flash and the same weights through
    # plain attention
    steps = 4
    rows = gen_rows_check(ff, p4, plen, steps)
    check((rows["tokens"] == outs["greedy"][:, plen:plen + steps]).all(),
          f"{tag}: the phase's decode loop differs from generate's")
    for name in ("reforward", "xla"):
        r = rows[name]
        print(f"[{tag}] {steps} decode steps x {LLAMA_ROWS} rows, KV path "
              f"vs {name} re-forward rows: max|diff| {r['max_abs']:.3e}, "
              f"{r['max_rel']:.2e} of the row's logit range (tol "
              f"{GEN_TOL:.0e}); greedy tokens equal in {r['tokens_equal']} "
              f"of {steps * LLAMA_ROWS}, {r['decided']} decided by a top-2 "
              f"margin above twice the difference, all of those equal: "
              f"{'ok' if r['ok'] else 'FAIL'}")
        check(r["ok"], f"{tag}: KV decode rows vs {name}")
    res = {"launches": launches, "prefills": prefills, "rows": rows}
    res["times"] = generate_times(ff, sess, p4, smi, name=what.lower(),
                                  plen=plen, tokens=LLAMA_TOKENS,
                                  rows=(1, LLAMA_ROWS), profile=True)
    return res


def phase_llama(smi: str) -> dict:
    """The LLaMA family at LLaMA-7B width: LLAMA_LAYERS layers generating
    through InferenceSession.generate (the causal flash forward at d =
    128 in each prefill, RoPE in the op, the KV decode), the primitive
    form at 2 layers against the fused form on the same weights, and 2
    layers training through fit (flash forward, dq, dk/dv, fused Adam)."""
    t0 = time.perf_counter()
    ff, lc = llama_model("attention:flash", LLAMA_LAYERS)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for ws in ff.params.values()
                   for t in ws.values())
    print(f"[llama] LLaMA-7B width ({lc.num_layers} of 32 layers, hidden "
          f"{lc.hidden_size}, FFN {lc.intermediate_size}, {lc.num_heads} "
          f"heads of {lc.hidden_size // lc.num_heads}, vocab "
          f"{lc.vocab_size}): {n_params} f32 parameters built and compiled "
          f"on the card in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB resident")
    res = lm_generate(ff, "llama", "LLaMA-7B", smi, 31)
    del ff
    free_cuda()
    res["primitive"] = llama_primitive_check()
    res["train"] = llama_train()
    return res


def llama_primitive_check() -> dict:
    """The primitive form (dense / transpose / batch_matmul / slice /
    concat, RoPE tables and mask as constants) at LLaMA-7B width and 2
    layers, 2 x 256: its logits against the fused form on the same weights
    (llama_fuse_params), and a 4-token generate, which takes the
    re-forward path (the graph has no attention op to cache)."""
    from flexflow_tpu_torch.models.nlp import llama_fuse_params
    seq = LLAMA_PRIM_SEQ
    prim, lc = llama_model("auto", LLAMA_SHORT, 2, seq, fused=False)
    fused, _ = llama_model("attention:flash", LLAMA_SHORT, 2, seq)
    fused.params = llama_fuse_params(prim.params, lc)
    ids = gpt_prompts(2, seq, lc.vocab_size, 41, seq)
    with torch.inference_mode():
        a = prim.executor.scored_forward(prim.params, prim.state,
                                         gpt_batch(ids)).float()
        b = fused.executor.scored_forward(fused.params, fused.state,
                                          gpt_batch(ids)).float()
        rel = ((a - b).abs().amax(-1)
               / (a.amax(-1) - a.amin(-1))).max().item()
        finite = bool(torch.isfinite(a).all().item())
    del a, b
    names = {t.name for t in prim.graph_inputs}
    check(not prim._kv_decode_eligible(names, None),
          "the primitive form must not be KV-eligible")
    forwards = []
    scored = prim.executor.scored_forward
    prim.executor.scored_forward = \
        lambda *a: (forwards.append(1), scored(*a))[1]
    fwd = zero_counts()["flash_attention_fwd"]
    plen, new = seq // 2, 4
    p2 = gpt_prompts(2, plen, lc.vocab_size, 42, seq)
    out = prim.generate(p2, plen, new).cpu().numpy()
    launches = fwd.launches
    prim.executor.scored_forward = scored
    no_fallback(prim, "primitive generate")
    check_tokens(out, p2, plen, new, lc.vocab_size, "primitive generate")
    kv = fused.generate(p2, plen, new, kv_cache=True).cpu().numpy()
    equal, gap = parted_at_ties(prim, out, kv)
    ok = rel <= GEN_TOL and finite and len(forwards) == new \
        and launches == 0 and gap <= GEN_TOL
    print(f"[llama] primitive form, LLaMA-7B width x {LLAMA_SHORT} layers "
          f"at 2x{seq}: logits vs the fused form on the same weights "
          f"(llama_fuse_params) {rel:.2e} of the row's range (tol "
          f"{GEN_TOL:.0e}), finite; a {new}-token generate ran "
          f"{len(forwards)} re-forwards and {launches} flash launches; "
          f"its tokens equal the fused form's KV decode in "
          f"{equal} of 2 rows, the others part at a near tie "
          f"({gap:.2e} of the range): {'ok' if ok else 'FAIL'}")
    check(ok, "llama primitive form")
    del prim, fused
    return {"rel": rel, "forwards": len(forwards)}


def lm_train(tag: str, what: str, model_fn, layers: int,
             epsilon: float = 1e-8) -> dict:
    """Training an LM at 2 x LLAMA_SEQ, ``layers`` layers
    (``model_fn(impl, optimizer) -> (ff, cfg)``): fit with Adam (alpha
    1e-4, ``epsilon``), flash and the fused update, every launch counted;
    then, from the same weights, the loss history against plain attention
    and the unfused Adam."""
    from flexflow_tpu_torch import AdamOptimizer
    seq, b, steps = LLAMA_SEQ, 2, 3
    impl = "attention:flash,opt_update:fused"
    ff, cfg = model_fn(impl, AdamOptimizer(1e-4, epsilon=epsilon))
    rng = np.random.default_rng(43)
    ids = rng.integers(0, cfg.vocab_size, (b * steps, seq + 1)).astype(
        np.int32)
    x, y = ids[:, :seq], ids[:, 1:]
    torch.cuda.synchronize()
    fns = zero_counts()  # the main path: every count starts at 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = ff.fit([x], y, epochs=1, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: fn.launches for name, fn in fns.items()}
    want = {"flash_attention_fwd": layers * steps,
            "flash_attention_bwd_dq": layers * steps,
            "flash_attention_bwd_dkv": layers * steps,
            "adam_update": steps}
    print(f"[{tag}] train: fit of {what} width x {layers} layers at "
          f"{b}x{seq}, {steps} steps in {fit_s:.2f} s, peak {peak:.3f} GB; "
          f"loss {history[0]['loss']:.5f}; launches {launches} (want "
          f"{want})")
    check(launches == want, f"{tag} train launches {launches} != {want}")
    check(bool(np.isfinite(history[0]["loss"])), f"{tag} train loss")
    del ff
    free_cuda()
    # the same weights and batch through both paths, one step per epoch
    runs = {}
    for impl_ in (impl, "attention:xla"):
        m, _ = model_fn(impl_, AdamOptimizer(1e-4, epsilon=epsilon))
        if runs:
            m.params = {ln: {wn: t.clone() for wn, t in ws.items()}
                        for ln, ws in runs[impl][0].items()}
        runs[impl_] = ({ln: {wn: t.clone() for wn, t in ws.items()}
                        for ln, ws in m.params.items()},
                       [r["loss"] for r in m.fit([x[:b]], y[:b], epochs=3,
                                                 verbose=False)])
        del m
        free_cuda()
    a, c = runs[impl][1], runs["attention:xla"][1]
    err = float(np.abs(np.array(a) - np.array(c)).max())
    ok = err <= TRAIN_TOL and np.all(np.isfinite(a))
    print(f"[{tag}] train, 3 steps from the same weights: loss flash + "
          f"fused Adam {[round(v, 5) for v in a]}, plain attention + "
          f"unfused Adam {[round(v, 5) for v in c]}: max|diff| = {err:.3e} "
          f"(tol {TRAIN_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{tag}: loss histories of the two paths disagree")
    del runs
    free_cuda()
    return {"launches": launches, "steps": steps, "peak_gb": peak,
            "loss_diff": err}


def llama_train() -> dict:
    """Training at LLaMA-7B width, 2 layers, 2 x 1024. 32 layers of f32
    Adam state (6.74 B x 16 B) do not fit on one card, hence the depth."""
    return lm_train("llama", "LLaMA-7B", lambda impl, opt: llama_model(
        impl, LLAMA_SHORT, 2, LLAMA_SEQ, optimizer=opt), LLAMA_SHORT)


MIXTRAL_LAYERS = 8   # generation depth, of Mixtral-8x7B's 32 (f32 weights)
MIXTRAL_TRAIN_LAYERS = 1


def mixtral_model(impl: str, layers: int, batch: int = LLAMA_ROWS,
                  seq: int = LLAMA_SEQ, optimizer=None):
    """Mixtral-8x7B's width (hidden 4096, FFN 14336, 32 heads / 8 kv heads
    of 128, 8 SwiGLU experts top-2, vocab 32000; seeded random weights,
    initialised on the card) at ``layers`` layers, built through FFModel
    with bf16 matmul operands and f32 results."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import MixtralConfig, build_mixtral
    cfg = FFConfig()
    cfg.batch_size = batch
    cfg.only_data_parallel = True
    cfg.kernel_impls = impl
    cfg.seed = 0
    ff = FFModel(cfg)
    mc = MixtralConfig()
    mc.num_layers = layers
    out = build_mixtral(ff, batch, seq, mc)
    ff.compile(optimizer or SGDOptimizer(0.01),
               "sparse_categorical_crossentropy", [], output_tensor=out)
    return ff, mc


def phase_mixtral(smi: str) -> dict:
    """Mixtral at Mixtral-8x7B width: MIXTRAL_LAYERS layers generating
    through InferenceSession.generate (the causal flash forward at d = 128
    after GQA's K/V repeat, RoPE, the dense mixture routed by TopK, Equal,
    Cast and ReduceSum, the KV decode), then 1 layer training through fit.
    The port keeps f32 weights: one layer is 1.45 B parameters (5.81 GB),
    so 8 layers with the embedding and head are 47.5 GB; 32 would be
    186.8 GB."""
    t0 = time.perf_counter()
    ff, mc = mixtral_model("attention:flash", MIXTRAL_LAYERS)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for ws in ff.params.values()
                   for t in ws.values())
    print(f"[mixtral] Mixtral-8x7B width ({mc.num_layers} of 32 layers, "
          f"hidden {mc.hidden_size}, FFN {mc.intermediate_size}, "
          f"{mc.num_heads} heads / {mc.num_kv_heads} kv heads of "
          f"{mc.hidden_size // mc.num_heads}, {mc.num_experts} experts "
          f"top-{mc.experts_per_tok}, vocab {mc.vocab_size}): {n_params} f32 "
          f"parameters built and compiled on the card in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB resident")
    res = lm_generate(ff, "mixtral", "Mixtral-8x7B-8L", smi, 51)
    del ff
    free_cuda()
    # Adam at epsilon 1e-4: the flash and plain attention paths differ by
    # bf16 roundings (2e-4 in the first loss), and a top-2 pick that flips
    # on them sends a token's gradient to another expert, whose weights
    # Adam at 1e-8 then moves by a full +-alpha; the histories then part
    # by 1.5e-2, 2.6e-2, 6.1e-2 over steps 2-4 (1e-4: 2.3e-4, 2.3e-3,
    # 7.6e-3), where the fused and unfused updates agree bit for bit
    # either way (PERF.md sec. 6)
    res["train"] = lm_train(
        "mixtral", "Mixtral-8x7B",
        lambda impl, opt: mixtral_model(impl, MIXTRAL_TRAIN_LAYERS, 2,
                                        LLAMA_SEQ, optimizer=opt),
        MIXTRAL_TRAIN_LAYERS, epsilon=1e-4)
    return res


MOE_BATCH, MOE_BATCHES = 64, 8


def moe_model(impl: str, seed: int = 0):
    """build_moe_mnist at MoeConfig() (the reference example's defaults)
    at batch MOE_BATCH, Adam, bf16 matmul operands and f32 results."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models import MoeConfig, build_moe_mnist
    cfg = FFConfig()
    cfg.batch_size = MOE_BATCH
    cfg.only_data_parallel = True
    cfg.kernel_impls = impl
    cfg.seed = seed
    ff = FFModel(cfg)
    mc = MoeConfig()
    build_moe_mnist(ff, MOE_BATCH, mc)
    ff.compile(AdamOptimizer(1e-3), "sparse_categorical_crossentropy",
               ["accuracy"])
    return ff, mc


def phase_moe() -> dict:
    """The MoE operator family training: build_moe_mnist through fit with
    the fused Adam (one launch per step), the loss history against the
    unfused Adam from the same weights, and the slots the capacity
    drops."""
    from flexflow_tpu_torch import OperatorType
    from flexflow_tpu_torch.ops.moe_ops import dropped_slots
    ff, mc = moe_model("opt_update:fused")
    rng = np.random.default_rng(61)
    n = MOE_BATCH * MOE_BATCHES
    x = rng.standard_normal((n, mc.in_dim)).astype(np.float32)
    y = rng.integers(0, mc.num_classes, (n, 1)).astype(np.int32)
    epochs = 2
    torch.cuda.synchronize()
    fns = zero_counts()  # the main path: every count starts at 0
    t0 = time.perf_counter()
    history = ff.fit(x, y, epochs=epochs, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    steps = epochs * MOE_BATCHES
    want = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "adam_update": steps}
    ev = ff.eval(x, y)
    print(f"[moe] main path: fit of build_moe_mnist (MoeConfig(): "
          f"{mc.num_exp} experts top-{mc.num_select}, hidden "
          f"{mc.hidden_size}, alpha {mc.alpha}, lambda_bal {mc.lambda_bal}, "
          f"in {mc.in_dim}) at batch {MOE_BATCH}, {epochs} epochs x "
          f"{MOE_BATCHES} batches = {steps} steps in {fit_s:.2f} s "
          f"({fit_s / steps * 1e3:.2f} ms per step, host clock); history "
          f"{[(round(r['loss'], 5), r['accuracy']) for r in history]}; eval "
          f"{ev}; launches {launches} (want {want})")
    check(launches == want, f"moe launches {launches} != {want}")
    check(all(np.isfinite(r["loss"]) for r in history)
          and np.isfinite(ev["loss"]), "moe: non-finite loss")

    # the (token, choice) slots the capacity drops on one batch, from the
    # gate's top-k through the graph
    prog, ex = ff.executor.program, ff.executor
    topk = next(l for l in prog.layers if l.op_type == OperatorType.OP_TOPK)
    group = next(l for l in prog.layers
                 if l.op_type == OperatorType.OP_GROUP_BY)
    with torch.inference_mode():
        env = prog.init_env({"input": x[:MOE_BATCH]}, ff.device)
        assign = prog.emit_layers(prog.layers, env, ff.params,
                                  ex._kv_ctx(None, ff.state),
                                  topk.outputs[1].guid)
    cap = group.outputs[0].shape[0]
    dropped = dropped_slots(assign, mc.num_exp, cap)
    print(f"[moe] capacity {cap} per expert (ceil({mc.alpha} x "
          f"{mc.num_select} x {MOE_BATCH} / {mc.num_exp})): the trained "
          f"gate's top-{mc.num_select} of one batch fills "
          f"{assign.numel() - dropped} of {assign.numel()} (token, choice) "
          f"slots, {dropped} dropped")
    del ff
    free_cuda()

    # the same weights and batches through the fused and the unfused Adam,
    # one batch per epoch, so the history is the per-step loss
    runs = {}
    for impl in ("opt_update:fused", "auto"):
        m, _ = moe_model(impl)
        if runs:
            m.params = {ln: {wn: t.clone() for wn, t in ws.items()}
                        for ln, ws in runs["opt_update:fused"][0].items()}
        runs[impl] = ({ln: {wn: t.clone() for wn, t in ws.items()}
                       for ln, ws in m.params.items()},
                      [r["loss"] for r in m.fit(x[:MOE_BATCH],
                                                y[:MOE_BATCH], epochs=4,
                                                verbose=False)])
        del m
    a, b = runs["opt_update:fused"][1], runs["auto"][1]
    err = float(np.abs(np.array(a) - np.array(b)).max())
    ok = err <= TRAIN_TOL and np.all(np.isfinite(a))
    print(f"[moe] 4 steps from the same weights: loss fused Adam "
          f"{[round(v, 5) for v in a]}, unfused Adam "
          f"{[round(v, 5) for v in b]}: max|diff| = {err:.3e} (tol "
          f"{TRAIN_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    check(ok, "moe: loss histories of the fused and unfused Adam disagree")
    return {"launches": launches, "steps": steps, "dropped": dropped,
            "slots": int(assign.numel()), "loss_diff": err}


# the zoo phase: the rest of the model zoo at the published widths
ZOO_STEPS = 3       # steps of the main path's fit and of the plain run
ZOO_TIMED = 6       # timed train steps per model, after the fit
ZOO_REQUESTS = 5    # timed requests of each served model
ZOO_CLASSES = 1000  # the published ImageNet head (the builders default 10)
ZOO_SEQ = 128       # NMT's source and target length (NMTConfig fixes none)
# the steps profiled: NMT's LSTM recurrence (launch-bound) and ResNet-50's
ZOO_PROFILED = ("nmt", "resnet50")


class ZooSpec:
    """One model of the zoo phase: ``build(ff, batch)`` returns its
    output tensor, ``data(rows, seed)`` seeded inputs (in graph-input
    order) and labels; ``flash`` is its attention layers (flash launches
    per step of each kernel), ``served`` whether it also answers requests
    through InferenceSession.infer."""

    def __init__(self, tag, what, batch, build, data, loss, flash=0,
                 served=False):
        self.tag, self.what, self.batch = tag, what, batch
        self.build, self.data, self.loss = build, data, loss
        self.flash, self.served = flash, served


def zoo_specs() -> list:
    from flexflow_tpu_torch import models as zoo
    tc, nc = zoo.TransformerConfig(), zoo.NMTConfig()
    dc, xc = zoo.DLRMConfig(), zoo.XDLConfig()

    def images(hw):
        def data(rows, seed):
            rng = np.random.default_rng(seed)
            return ([rng.standard_normal((rows, 3, hw, hw),
                                         dtype=np.float32)],
                    rng.integers(0, ZOO_CLASSES, (rows, 1)).astype(np.int32))
        return data

    def transformer_data(rows, seed):
        rng = np.random.default_rng(seed)
        shape = (rows, tc.sequence_length)
        return ([rng.standard_normal(shape + (tc.hidden_size,),
                                     dtype=np.float32)],
                rng.standard_normal(shape + (1,), dtype=np.float32))

    def nmt_data(rows, seed):
        rng = np.random.default_rng(seed)
        src = rng.integers(0, nc.src_vocab, (rows, ZOO_SEQ)).astype(np.int32)
        tgt = rng.integers(1, nc.tgt_vocab, (rows, ZOO_SEQ)).astype(np.int32)
        dec_in = np.concatenate([np.zeros((rows, 1), np.int32),
                                 tgt[:, :-1]], axis=1)
        return [src, dec_in], tgt

    def recsys(cfg, dense):
        def data(rows, seed):
            rng = np.random.default_rng(seed)
            xs = [rng.integers(0, n, (rows, cfg.embedding_bag_size))
                  .astype(np.int32) for n in cfg.embedding_size]
            if dense:
                xs.append(rng.standard_normal((rows, cfg.mlp_bot[0]),
                                              dtype=np.float32))
            return xs, rng.integers(0, 2, (rows, 1)).astype(np.int32)
        return data

    sce = "sparse_categorical_crossentropy"
    tables = (f"{len(dc.embedding_size)} tables of {dc.embedding_size[0]} "
              f"x {dc.sparse_feature_size}, bag {dc.embedding_bag_size}")
    return [
        ZooSpec("transformer", f"Transformer (TransformerConfig(): hidden "
                f"{tc.hidden_size}, {tc.num_heads} heads of "
                f"{tc.hidden_size // tc.num_heads ** 2} (kdim = hidden / "
                f"heads, split over the heads; the kernel pads to 64), "
                f"{tc.num_layers} layers, seq {tc.sequence_length}, MSE)",
                64, lambda ff, b: zoo.build_transformer(ff, b, tc),
                transformer_data, "mean_squared_error", tc.num_layers, True),
        ZooSpec("nmt", f"NMT (NMTConfig(): vocab {nc.src_vocab} / "
                f"{nc.tgt_vocab}, embed {nc.embed_dim}, LSTM hidden "
                f"{nc.hidden_size} x {nc.num_layers} layers each side, "
                f"{nc.num_heads} attention head of {nc.hidden_size}; src = "
                f"tgt = {ZOO_SEQ}, sparse CE)", 64,
                lambda ff, b: zoo.build_nmt(ff, b, ZOO_SEQ, ZOO_SEQ, nc),
                nmt_data, sce, 1),
        ZooSpec("resnet50", f"ResNet-50 (224x224, {ZOO_CLASSES} classes)",
                64, lambda ff, b: zoo.build_resnet50(ff, b, ZOO_CLASSES, 224),
                images(224), sce, served=True),
        ZooSpec("resnext50", f"ResNeXt-50 32x4d (224x224, {ZOO_CLASSES} "
                f"classes)", 16,
                lambda ff, b: zoo.build_resnext50(ff, b, ZOO_CLASSES, 224),
                images(224), sce),
        ZooSpec("inception_v3", f"Inception-v3 (299x299, {ZOO_CLASSES} "
                f"classes)", 64,
                lambda ff, b: zoo.build_inception_v3(ff, b, ZOO_CLASSES,
                                                     299),
                images(299), sce),
        ZooSpec("alexnet", f"AlexNet (229x229, {ZOO_CLASSES} classes)", 64,
                lambda ff, b: zoo.build_alexnet(ff, b, ZOO_CLASSES, 229),
                images(229), sce),
        ZooSpec("dlrm", f"DLRM (DLRMConfig(): {tables}, bottom "
                f"{'-'.join(map(str, dc.mlp_bot))}, top "
                f"{'-'.join(map(str, dc.mlp_top))})", 64,
                lambda ff, b: zoo.build_dlrm(ff, b, dc), recsys(dc, True),
                sce),
        ZooSpec("xdl", f"XDL (XDLConfig(): {tables}, MLP "
                f"{'-'.join(map(str, xc.mlp))})", 64,
                lambda ff, b: zoo.build_xdl(ff, b, xc), recsys(xc, False),
                sce),
    ]


def zoo_model(spec, impl: str):
    """``spec``'s model through FFModel on the card, bf16 matmul and conv
    operands, seeded random weights, Adam (alpha 1e-4, epsilon 1e-4: the
    conv biases under BatchNorm and MHA's key bias have a true gradient
    of 0, whose f32 noise Adam at 1e-8 turns into +-alpha steps)."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    cfg = FFConfig()
    cfg.batch_size = spec.batch
    cfg.only_data_parallel = True
    cfg.kernel_impls = impl
    cfg.seed = 0
    ff = FFModel(cfg)
    out = spec.build(ff, spec.batch)
    ff.compile(AdamOptimizer(1e-4, epsilon=1e-4), spec.loss, [],
               output_tensor=out)
    return ff


def host_tree(tree) -> dict:
    return {ln: {n: t.detach().cpu().clone() for n, t in d.items()}
            for ln, d in tree.items()}


def device_tree(tree) -> dict:
    return {ln: {n: t.cuda() for n, t in d.items()}
            for ln, d in tree.items()}


def profile_train_step(ff, step_fn, batch) -> dict:
    """torch.profiler over one train step: kernel launches, device kernel
    time, wall time, the busy share and the kernels that take the most
    device time."""
    from collections import defaultdict
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ff._run_train_step(step_fn, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(float)
    kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    family = defaultdict(float)
    for name, ms in by_name.items():
        low = name.lower()
        family["conv / GEMM" if any(w in low for w in (
            "conv", "gemm", "xmma", "cudnn", "cutlass", "implicit"))
            else "flash" if "flash" in low
            else "elementwise / reduce" if any(w in low for w in (
                "elementwise", "reduce")) else "other"] += ms
    return {"launches": kernels, "device_ms": dev_ms, "wall_ms": wall,
            "busy": dev_ms / wall, "top": [(n[:60], ms) for n, ms in top],
            "family_ms": dict(family)}


def zoo_run(spec, smi: str) -> dict:
    """One model of the zoo: fit for ZOO_STEPS steps (one batch, so the
    history is the per-step loss) through flash and the fused Adam with
    every launch counted, the timed steps and their peak memory, the
    served requests; then the same weights, state and batch through plain
    attention and the unfused Adam."""
    from flexflow_tpu_torch.serving import InferenceSession
    t0 = time.perf_counter()
    ff = zoo_model(spec, "attention:flash,opt_update:fused")
    torch.cuda.synchronize()
    n_params, n_leaves, adam = leaf_counts(ff)
    init, init_state = host_tree(ff.params), host_tree(ff.state)
    print(f"[zoo] {spec.what}, batch {spec.batch}: {n_params} f32 "
          f"parameters in {n_leaves} leaves, {len(ff.state)} BatchNorm "
          f"states, built on the card in {time.perf_counter() - t0:.2f} s")
    xs, y = spec.data(spec.batch, 71)
    fns = zero_counts()  # the main path: every count starts at 0
    t0 = time.perf_counter()
    history = ff.fit(xs, y, epochs=ZOO_STEPS, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    want = {"flash_attention_fwd": spec.flash * ZOO_STEPS,
            "flash_attention_bwd_dq": spec.flash * ZOO_STEPS,
            "flash_attention_bwd_dkv": spec.flash * ZOO_STEPS,
            "adam_update": adam * ZOO_STEPS}
    losses = [r["loss"] for r in history]
    print(f"[zoo] {spec.tag} main path: fit, {ZOO_STEPS} steps in "
          f"{fit_s:.2f} s, loss {[round(v, 5) for v in losses]}; launches "
          f"{launches} (want {want}: {spec.flash} flash layers, "
          f"ceil({n_leaves} leaves / 384) Adam launches per step)")
    check(launches == want, f"{spec.tag} launches {launches} != {want}")
    check(all(np.isfinite(v) for v in losses), f"{spec.tag}: loss {losses}")
    if ff.state:
        moved = sum(not torch.equal(ff.state[ln][n].cpu(), t)
                    for ln, d in init_state.items() for n, t in d.items())
        print(f"[zoo] {spec.tag}: {moved} of {2 * len(ff.state)} running "
              f"statistics moved in training")
        check(moved == 2 * len(ff.state), f"{spec.tag}: running state")

    # what the plain plan is held to: the running statistics and the
    # served outputs after the same ZOO_STEPS steps
    trained_state = host_tree(ff.state)
    inputs = {t.name: a for t, a in zip(ff.graph_inputs, xs)}
    served = None
    res = {"params": n_params, "leaves": n_leaves, "fit_s": fit_s,
           "launches": launches, "adam_per_step": adam}
    if spec.served:
        sess = InferenceSession(ff, batch_buckets=(spec.batch,))
        sess.infer(inputs)
        torch.cuda.synchronize()
        fwd = zero_counts()["flash_attention_fwd"]
        lat = []
        for _ in range(ZOO_REQUESTS):
            t1 = time.perf_counter()
            served = sess.infer(inputs)
            lat.append((time.perf_counter() - t1) * 1e3)
        res["request_ms"] = float(np.percentile(lat, 50))
        res["request_p90_ms"] = float(np.percentile(lat, 90))
        res["serve_launches"] = fwd.launches
        print(f"[zoo] {spec.tag} InferenceSession.infer, {spec.batch} rows "
              f"(eval: running statistics): median {res['request_ms']:.3f} "
              f"ms, p90 {res['request_p90_ms']:.3f} ms over {ZOO_REQUESTS} "
              f"requests (host clock, ends in the copy to the host); flash "
              f"forward launches {fwd.launches} (want {spec.flash} x "
              f"{ZOO_REQUESTS}), output {served.shape}")
        check(fwd.launches == spec.flash * ZOO_REQUESTS,
              f"{spec.tag} serve launches")
        check(bool(np.isfinite(served).all()), f"{spec.tag} served output")
        del sess
    batch = {t.name: torch.from_numpy(a).cuda()
             for t, a in zip(ff.graph_inputs, xs)}
    batch["label"] = torch.from_numpy(y).cuda()
    step_fn = ff.executor.make_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(ZOO_TIMED):
        t1 = time.perf_counter()
        ff._run_train_step(step_fn, batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
    res.update(step_ms=float(np.percentile(lat, 50)),
               step_p90_ms=float(np.percentile(lat, 90)),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[zoo] {spec.tag} train step (flash + fused Adam): median "
          f"{res['step_ms']:.3f} ms, p90 {res['step_p90_ms']:.3f} ms over "
          f"{ZOO_TIMED} steps (host clock, each ending in a device sync); "
          f"peak device memory {res['peak_gb']:.3f} GB; per step "
          f"{spec.flash} / {spec.flash} / {spec.flash} flash forward / dq / "
          f"dk/dv and {adam} Adam launches; {smi}")
    if spec.tag in ZOO_PROFILED:
        p = res["profile"] = profile_train_step(ff, step_fn, batch)
        print(f"[zoo] {spec.tag} train step under torch.profiler: "
              f"{p['launches']} kernel launches, {p['device_ms']:.3f} ms of "
              f"device time in {p['wall_ms']:.3f} ms wall, busy "
              f"{p['busy']:.3f}; by kernel family "
              + ", ".join(f"{k} {ms:.3f} ms" for k, ms in sorted(
                  p["family_ms"].items(), key=lambda kv: -kv[1]))
              + "; most device time: "
              + "; ".join(f"{n} {ms:.3f} ms" for n, ms in p["top"])
              + f"; {smi}")
    del ff, step_fn, batch
    free_cuda()

    # the same weights, state and batch through plain attention and the
    # unfused Adam
    ref = zoo_model(spec, "attention:xla")
    ref.params, ref.state = device_tree(init), device_tree(init_state)
    plain = [r["loss"] for r in ref.fit(xs, y, epochs=ZOO_STEPS,
                                        verbose=False)]
    err = float(np.abs(np.array(losses) - np.array(plain)).max())
    ok = err <= TRAIN_TOL
    print(f"[zoo] {spec.tag}, {ZOO_STEPS} steps from the same weights: "
          f"loss flash + fused Adam {[round(v, 5) for v in losses]}, plain "
          f"attention + unfused Adam {[round(v, 5) for v in plain]}: "
          f"max|diff| = {err:.3e} (tol {TRAIN_TOL:.0e}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{spec.tag}: loss histories of the two plans disagree")
    res["loss_diff"] = err
    if trained_state:
        serr = max(float((ref.state[ln][n].cpu() - t).abs().max()
                         / max(float(t.abs().max()), 1.0))
                   for ln, d in trained_state.items() for n, t in d.items())
        print(f"[zoo] {spec.tag} running statistics after training, both "
              f"plans: max|diff| = {serr:.3e} of max(1, |value|) (tol "
              f"{TRAIN_TOL:.0e})")
        check(serr <= TRAIN_TOL, f"{spec.tag}: running statistics differ")
    if served is not None:
        want_out = InferenceSession(ref, batch_buckets=(spec.batch,)) \
            .infer(inputs)
        rel = float(np.abs(served - want_out).max()
                    / max(float(np.abs(want_out).max()), 1e-30))
        print(f"[zoo] {spec.tag} served output against the plain plan's "
              f"trained model: max|diff| = {rel:.3e} of max|output| (tol "
              f"{SLICE_TOL:.0e})")
        check(rel <= SLICE_TOL, f"{spec.tag}: served outputs differ")
    del ref
    free_cuda()
    return res


def phase_zoo(smi: str) -> dict:
    """The rest of the model zoo at published widths, each model trained
    through fit with exact launch counts, held against the plain plan,
    timed; the Transformer and ResNet-50 also served. cuDNN runs its
    deterministic algorithms: ResNet-50's training at initialisation
    amplifies f32 rounding by orders of magnitude per step, so the two
    plans' histories agree only where their convolutions sum alike."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    res = {}
    for spec in zoo_specs():
        t0 = time.perf_counter()
        res[spec.tag] = zoo_run(spec, smi)
        print(f"[wall] zoo {spec.tag}: {time.perf_counter() - t0:.1f} s")
    torch.backends.cudnn.deterministic = det
    return res


FE_SEQ = 512          # the fx import's sequence (BERT-base's longest)
FE_KERAS_SEQ = 128    # the Keras model's sequence
FE_STEPS = 3          # fit steps of each imported model
FE_HIST_STEPS = 4     # steps of the dropout-0 history comparison
FE_TIMED = 6          # timed train steps of the fx import
FE_ROWS = 8           # batch of the fx and Keras models
ONNX_BATCH = 64       # AlexNet's batch (alexnet.cc's)
# ONNX AlexNet through the port (bf16 conv and matmul operands, f32
# accumulation) vs an f32 functional forward of the same initializers, on
# the logits, relative to the oracle's largest |logit|: each of the 8
# layers rounds its operands to bf16 (2**-9 relative each), and the
# roundings add up through the depth
ONNX_TOL = 3e-2


class FxBlock(torch.nn.Module):
    """A BERT encoder block in plain torch.nn (post-norm, as BERT)."""

    def __init__(self, d, heads, ffn, dropout):
        super().__init__()
        nn = torch.nn
        self.attn = nn.MultiheadAttention(d, heads, dropout=dropout,
                                          batch_first=True)
        self.ln1 = nn.LayerNorm(d, eps=1e-12)
        self.fc1 = nn.Linear(d, ffn)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(ffn, d)
        self.ln2 = nn.LayerNorm(d, eps=1e-12)

    def forward(self, x):
        a, _ = self.attn(x, x, x)
        x = self.ln1(x + a)
        return self.ln2(x + self.fc2(self.act(self.fc1(x))))


class FxBert(torch.nn.Module):
    """BERT-base's encoder as a user writes it in torch.nn: token and
    position embeddings (positions from ``torch.arange``, which the fx
    import folds into a constant), 12 blocks, a 2-class head on the first
    token."""

    def __init__(self, seq, dropout, vocab=30522, d=768, heads=12,
                 ffn=3072, layers=12):
        super().__init__()
        nn = torch.nn
        self.seq = seq
        self.tok = nn.Embedding(vocab, d)
        self.pos = nn.Embedding(512, d)
        self.blocks = nn.ModuleList(FxBlock(d, heads, ffn, dropout)
                                    for _ in range(layers))
        self.head = nn.Linear(d, 2)

    def forward(self, ids):
        x = self.tok(ids) + self.pos(torch.arange(self.seq))
        for b in self.blocks:
            x = b(x)
        return torch.softmax(self.head(x[:, 0]), dim=-1)


def fx_import(dropout: float, impl: str):
    """FxBert on the CPU (seeded), imported through
    ``PyTorchModel.torch_to_ff`` at FE_ROWS x FE_SEQ onto the card,
    compiled (Adam 1e-4, epsilon 1e-4), the torch weights copied."""
    from flexflow_tpu_torch import (AdamOptimizer, DataType, FFConfig,
                                    FFModel)
    from flexflow_tpu_torch.frontends import PyTorchModel
    torch.manual_seed(0)
    module = FxBert(FE_SEQ, dropout)
    cfg = FFConfig()
    cfg.batch_size = FE_ROWS
    cfg.only_data_parallel = True
    cfg.kernel_impls = impl
    cfg.seed = 0
    ff = FFModel(cfg)
    x = ff.create_tensor((FE_ROWS, FE_SEQ), DataType.DT_INT32,
                         name="input_ids")
    pm = PyTorchModel(module)
    outs = pm.torch_to_ff(ff, [x])
    ff.compile(AdamOptimizer(1e-4, epsilon=1e-4),
               "sparse_categorical_crossentropy", ["accuracy"],
               output_tensor=outs[0])
    pm.copy_weights(ff)
    return ff


def fe_ids(rows: int, seq: int, seed: int, vocab: int = 30522):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (rows, seq)).astype(np.int32),
            rng.integers(0, 2, (rows, 1)).astype(np.int32))


def leaf_counts(ff) -> tuple:
    """(parameters, leaves, fused Adam launches a step) of ``ff``: the
    kernel takes up to ``ff_adam_max_leaves`` leaves a launch."""
    from flexflow_tpu_torch.kernels.opt_update import _c_fn
    leaves = [t for ws in ff.params.values() for t in ws.values()]
    n = len(leaves)
    return (sum(t.numel() for t in leaves), n,
            -(-n // _c_fn("ff_adam_max_leaves")()))


def htod_copies(fn, dst: str = "cuda") -> int:
    """The host-to-device copies one call of ``fn`` makes: every ATen
    copy (``to``, which inference mode dispatches whole, ``_to_copy``,
    ``copy_``) from a CPU tensor to one on ``dst``, counted by a
    dispatch mode. (torch.profiler's "Memcpy HtoD" device records are
    not a count: after an earlier profile in the same process they can
    come back empty.)"""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten

    class Copies(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket in (aten.to, aten._to_copy):
                src, to = args[0], out
            elif func.overloadpacket is aten.copy_:
                to, src = args[0], args[1]
            else:
                return out
            if isinstance(src, torch.Tensor) and src.device.type == "cpu" \
                    and to.device.type == dst:
                Copies.n += 1
            return out

    with Copies():
        fn()
    return Copies.n


def fe_fx(smi: str) -> dict:
    """(a) the slice's main path: BERT-base width and depth written in
    torch.nn, imported through torch.fx, served and trained on the card
    through the flash and fused-Adam kernels."""
    from flexflow_tpu_torch import OperatorType
    from flexflow_tpu_torch.serving import InferenceSession
    t0 = time.perf_counter()
    ff = fx_import(0.1, "attention:flash,opt_update:fused")
    mha = [l for l in ff.layers
           if l.op_type == OperatorType.OP_MULTIHEAD_ATTENTION]
    n_params, n_leaves, adam = leaf_counts(ff)
    (pos,) = ff.const_inputs
    staged = ff.executor.program._staged[pos.guid][2]
    print(f"[frontends] fx: FxBert (torch.nn; vocab 30522, hidden 768, 12 "
          f"heads, FFN 3072, 12 layers, attention dropout 0.1) imported "
          f"through PyTorchModel.torch_to_ff at {FE_ROWS}x{FE_SEQ} in "
          f"{time.perf_counter() - t0:.2f} s: {len(ff.layers)} layers, "
          f"{len(mha)} attention, {n_params} parameters in {n_leaves} "
          f"leaves; folded constant {pos.name} {pos.shape} staged on "
          f"{staged.device}")
    check(len(mha) == LAYERS, f"fx import has {len(mha)} attention layers")
    check(staged.device.type == "cuda" and pos.shape == (FE_SEQ,),
          "the position constant is not staged on the card")
    sess = InferenceSession(ff, batch_buckets=(FE_ROWS,))
    reqs = {rows: {"input_ids": fe_ids(rows, FE_SEQ, 40 + rows)[0]}
            for rows in (1, 3, 8)}
    sess.infer(reqs[8])
    torch.cuda.synchronize()
    fwd = zero_counts()["flash_attention_fwd"]   # the main path from here
    outs = {rows: sess.infer(r) for rows, r in reqs.items()}
    serve = fwd.launches
    print(f"[frontends] fx: InferenceSession.infer of 1, 3, 8 rows: flash "
          f"forward launches {serve} (want {LAYERS} x 3)")
    check(serve == LAYERS * 3, f"fx serve launches {serve}")
    with attention_plan(ff, "xla"):
        plain = {rows: sess.infer(r) for rows, r in reqs.items()}
    for rows, out in outs.items():
        err = float(np.abs(out - plain[rows]).max())
        sums = float(np.abs(out.sum(axis=1) - 1.0).max())
        ok = out.shape == (rows, 2) and bool(np.isfinite(out).all()) \
            and sums < 1e-5 and err <= SLICE_TOL
        print(f"[frontends] fx: request of {rows} rows: shape {out.shape}, "
              f"|row sum - 1| <= {sums:.1e}, max|flash - plain attention| "
              f"= {err:.3e} (tol {SLICE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        check(ok, f"fx import served output, {rows} rows")
    h2d = htod_copies(lambda: sess.infer(reqs[8]))
    print(f"[frontends] fx: one served request makes {h2d} host-to-device "
          f"copies (want 1: the request's ids, the position constant "
          f"staying on the card)")
    check(h2d == 1, f"served request makes {h2d} host-to-device copies")

    ids, y = fe_ids(FE_ROWS, FE_SEQ, 7)
    fns = zero_counts()   # the main path: fit
    history = ff.fit([ids], y, epochs=FE_STEPS, verbose=False)
    launches = {name: fn.launches for name, fn in fns.items()}
    want = {"flash_attention_fwd": LAYERS * FE_STEPS,
            "flash_attention_bwd_dq": LAYERS * FE_STEPS,
            "flash_attention_bwd_dkv": LAYERS * FE_STEPS,
            "adam_update": adam * FE_STEPS}
    losses = [r["loss"] for r in history]
    print(f"[frontends] fx: fit, {FE_STEPS} steps at dropout 0.1, loss "
          f"{[round(v, 5) for v in losses]}; launches {launches} (want "
          f"{want}: ceil({n_leaves} leaves / 384) Adam launches a step)")
    check(launches == want, f"fx train launches {launches} != {want}")
    check(all(np.isfinite(v) for v in losses), f"fx losses {losses}")
    batch = {"input_ids": torch.from_numpy(ids).cuda(),
             "label": torch.from_numpy(y).cuda()}
    step_fn = ff.executor.make_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(FE_TIMED):
        t1 = time.perf_counter()
        ff._run_train_step(step_fn, batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
    step_h2d = htod_copies(lambda: ff._run_train_step(step_fn, batch))
    res = {"serve_launches": serve, "train_launches": launches,
           "adam_per_step": adam, "leaves": n_leaves, "params": n_params,
           "step_ms": float(np.percentile(lat, 50)),
           "step_p90_ms": float(np.percentile(lat, 90)),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "step_htod": step_h2d}
    print(f"[frontends] fx train step {FE_ROWS}x{FE_SEQ} (flash + fused "
          f"Adam, dropout 0.1): median {res['step_ms']:.3f} ms, p90 "
          f"{res['step_p90_ms']:.3f} ms over {FE_TIMED} steps (host clock, "
          f"each ending in a device sync); peak device memory "
          f"{res['peak_gb']:.3f} GB; {step_h2d} host-to-device copies a "
          f"step with the batch on the card; {smi}")
    check(ff.executor.program._staged[pos.guid][2] is staged,
          "the position constant was copied again")
    del ff, sess, step_fn, batch
    free_cuda()

    # dropout 0: the same params through flash + fused Adam and through
    # plain attention + the unfused Adam, one batch a step
    ff = fx_import(0.0, "attention:flash,opt_update:fused")
    init = host_tree(ff.params)
    ids, y = fe_ids(FE_ROWS, FE_SEQ, 11)
    a = [r["loss"] for r in ff.fit([ids], y, epochs=FE_HIST_STEPS,
                                   verbose=False)]
    del ff
    free_cuda()
    ref = fx_import(0.0, "attention:xla")
    ref.params = device_tree(init)
    b = [r["loss"] for r in ref.fit([ids], y, epochs=FE_HIST_STEPS,
                                    verbose=False)]
    del ref
    free_cuda()
    err = float(np.abs(np.array(a) - np.array(b)).max())
    ok = err <= TRAIN_TOL and bool(np.all(np.isfinite(a)))
    print(f"[frontends] fx: dropout 0, {FE_HIST_STEPS} steps from the same "
          f"params: loss flash + fused Adam {[round(v, 5) for v in a]}, "
          f"plain attention + unfused Adam {[round(v, 5) for v in b]}: "
          f"max|diff| = {err:.3e} (tol {TRAIN_TOL:.0e}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "fx import: dropout-0 loss histories disagree")
    res["loss_diff"] = err
    return res


def keras_bert(k, seq: int, dropout: float = 0.1):
    """BERT-base width and depth through the Keras layer set: token and
    position embeddings, 12 blocks of MultiHeadAttention(12, 64) / Add /
    LayerNormalization / Dense, and a Flatten -> Dense(2) -> Softmax head."""
    from flexflow_tpu_torch import DataType
    ids = k.Input((seq,), DataType.DT_INT32, name="input_ids")
    pos = k.Input((seq,), DataType.DT_INT32, name="position_ids")
    x = k.Add()([k.Embedding(30522, 768)(ids.tensor),
                 k.Embedding(512, 768)(pos.tensor)])
    for _ in range(LAYERS):
        a = k.MultiHeadAttention(12, 64, dropout=dropout)(x, x)
        x = k.LayerNormalization(epsilon=1e-12)(k.Add()([x, a]))
        f = k.Dense(768)(k.Dense(3072, activation="gelu")(x))
        x = k.LayerNormalization(epsilon=1e-12)(k.Add()([x, f]))
    out = k.Softmax()(k.Dense(2)(k.Flatten()(x)))
    return k.Model(inputs=[ids, pos], outputs=out)


def fe_keras() -> dict:
    """(b) the Keras frontend at BERT-base width: Model.compile("adam")
    on the card, fit with a learning-rate schedule and an early stop."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.frontends import keras
    from flexflow_tpu_torch.frontends.keras.callbacks import (
        Callback, EarlyStopping, LearningRateScheduler)
    t0 = time.perf_counter()
    model = keras_bert(keras, FE_KERAS_SEQ)
    cfg = FFConfig()
    cfg.only_data_parallel = True
    cfg.kernel_impls = "attention:flash,opt_update:fused"
    cfg.seed = 0
    model.compile("adam", "sparse_categorical_crossentropy", ["accuracy"],
                  config=cfg, batch_size=FE_ROWS)
    ff = model.ffmodel
    _, n_leaves, adam = leaf_counts(ff)
    print(f"[frontends] keras: BERT-base width (12 x MultiHeadAttention(12, "
          f"64), hidden 768, FFN 3072, vocab 30522) compiled through "
          f"Model.compile('adam', batch_size={FE_ROWS}) at "
          f"{FE_ROWS}x{FE_KERAS_SEQ} on {ff.device} in "
          f"{time.perf_counter() - t0:.2f} s: {len(ff.layers)} layers, "
          f"{n_leaves} leaves")
    check(ff.device.type == "cuda", "the Keras model is not on the card")

    def schedule(epoch):
        return 1e-4 / epoch

    class Rates(Callback):   # after the scheduler: the rate of the next step
        def __init__(self):
            self.seen = []

        def on_epoch_end(self, epoch, logs=None):
            opt = self.model.ffmodel.optimizer
            self.seen.append((opt.alpha, float(opt.alpha_t(
                self.model.ffmodel._step + 1, ff.device))))

    ids, y = fe_ids(FE_ROWS, FE_KERAS_SEQ, 21)
    pos = np.tile(np.arange(FE_KERAS_SEQ, dtype=np.int32), (FE_ROWS, 1))
    stop = EarlyStopping(monitor="loss", patience=1, min_delta=1e9)
    rates = Rates()
    torch.cuda.synchronize()
    fns = zero_counts()   # the main path: Model.fit
    history = model.fit([ids, pos], y, epochs=3, verbose=False,
                        callbacks=[LearningRateScheduler(schedule), stop,
                                   rates])
    launches = {name: fn.launches for name, fn in fns.items()}
    steps = len(history)
    want = {"flash_attention_fwd": LAYERS * steps,
            "flash_attention_bwd_dq": LAYERS * steps,
            "flash_attention_bwd_dkv": LAYERS * steps,
            "adam_update": adam * steps}
    losses = [r["loss"] for r in history]
    b1, b2 = ff.optimizer.beta1, ff.optimizer.beta2
    want_rates = [(schedule(e + 1), schedule(e + 1) * np.sqrt(
        1 - b2 ** (e + 2)) / (1 - b1 ** (e + 2))) for e in range(steps)]
    print(f"[frontends] keras: Model.fit(epochs=3) with LearningRate"
          f"Scheduler(1e-4 / epoch) and EarlyStopping(loss, patience 1, "
          f"min_delta 1e9): {steps} epochs (stopped at epoch "
          f"{stop.stopped_epoch}), loss {[round(v, 5) for v in losses]}; "
          f"alpha and the next step's alpha_t after each epoch "
          f"{rates.seen} (want {want_rates}); launches {launches} (want "
          f"{want})")
    check(steps == 2 and stop.stopped_epoch == 1,
          f"Keras fit ran {steps} epochs")
    check(launches == want, f"Keras launches {launches} != {want}")
    check(all(np.isfinite(v) for v in losses), f"Keras losses {losses}")
    # alpha_t is computed in f32 on the card: 1 - beta2**t loses ~1e-5
    check(np.allclose(rates.seen, want_rates, rtol=1e-4, atol=0),
          f"scheduled rates {rates.seen} != {want_rates}")
    pred = model.predict([ids, pos])
    print(f"[frontends] keras: predict {pred.shape}, finite "
          f"{bool(np.isfinite(pred).all())}")
    check(pred.shape == (FE_ROWS, 2) and bool(np.isfinite(pred).all()),
          "Keras predict")
    res = {"launches": launches, "epochs": steps, "adam_per_step": adam,
           "rates": rates.seen}
    del model, ff
    free_cuda()
    return res


def alexnet_onnx(seed: int):
    """AlexNet's layers as alexnet.cc has them (``build_alexnet``: 1000
    classes, 229 x 229) encoded with the port's ONNX wire encoder, with
    seeded He-normal initializers; returns (bytes, initializers)."""
    from flexflow_tpu_torch.frontends import onnx_wire as w
    rng = np.random.default_rng(seed)
    ini, nodes = {}, []

    def param(name, shape, fan_in):
        ini[name] = (rng.standard_normal(shape, dtype=np.float32)
                     * np.float32(np.sqrt(2.0 / fan_in)))
        ini[name + "_b"] = (0.01 * rng.standard_normal(shape[0],
                                                       dtype=np.float32))

    x, c_in = "input", 3
    convs = [(64, 11, 4, 2, True), (192, 5, 1, 2, True),
             (384, 3, 1, 1, False), (256, 3, 1, 1, False),
             (256, 3, 1, 1, True)]
    for i, (c, k, s, p, pool) in enumerate(convs):
        param(f"conv{i}", (c, c_in, k, k), c_in * k * k)
        nodes += [w.make_node("Conv", [x, f"conv{i}", f"conv{i}_b"],
                              [f"c{i}"], name=f"conv{i}",
                              kernel_shape=[k, k], strides=[s, s],
                              pads=[p, p, p, p]),
                  w.make_node("Relu", [f"c{i}"], [f"r{i}"],
                              name=f"relu{i}")]
        x, c_in = f"r{i}", c
        if pool:
            nodes.append(w.make_node("MaxPool", [x], [f"p{i}"],
                                     name=f"pool{i}", kernel_shape=[3, 3],
                                     strides=[2, 2]))
            x = f"p{i}"
    nodes.append(w.make_node("Flatten", [x], ["flat"], name="flat"))
    x, f_in = "flat", 256 * 6 * 6
    for i, f_out in enumerate((4096, 4096, ZOO_CLASSES)):
        param(f"fc{i}", (f_out, f_in), f_in)
        nodes.append(w.make_node("Gemm", [x, f"fc{i}", f"fc{i}_b"],
                                 [f"g{i}"], name=f"fc{i}", transB=1))
        x, f_in = f"g{i}", f_out
        if i < 2:
            nodes.append(w.make_node("Relu", [x], [f"gr{i}"],
                                     name=f"fc_relu{i}"))
            x = f"gr{i}"
    nodes.append(w.make_node("Softmax", [x], ["probs"], name="softmax",
                             axis=-1))
    data = w.make_model(
        nodes, [w.make_value_info("input", 1, (ONNX_BATCH, 3, 229, 229))],
        [w.make_value_info("probs", 1, (ONNX_BATCH, ZOO_CLASSES))],
        [w.make_tensor(n, a) for n, a in ini.items()], graph_name="alexnet")
    return data, ini


def alexnet_oracle(ini: dict, x: torch.Tensor) -> torch.Tensor:
    """The logits of the same initializers by an f32 functional forward
    on the card (the oracle only; TF32 off)."""
    F = torch.nn.functional
    dev = {n: torch.from_numpy(a).cuda() for n, a in ini.items()}
    convs = [(4, 2, True), (1, 2, True), (1, 1, False), (1, 1, False),
             (1, 1, True)]
    with torch.no_grad():
        for i, (s, p, pool) in enumerate(convs):
            x = F.relu(F.conv2d(x, dev[f"conv{i}"], dev[f"conv{i}_b"], s, p))
            if pool:
                x = F.max_pool2d(x, 3, 2)
        x = x.flatten(1)
        for i in range(3):
            x = F.linear(x, dev[f"fc{i}"], dev[f"fc{i}_b"])
            if i < 2:
                x = F.relu(x)
    return x


def fe_onnx() -> dict:
    """(c) ONNX through the wire codec: AlexNet's bytes imported with
    ONNXModel.apply, served through InferenceSession.infer and held
    against the f32 oracle, then trained through fit."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.frontends.onnx_frontend import ONNXModel
    from flexflow_tpu_torch.serving import InferenceSession
    t0 = time.perf_counter()
    data, ini = alexnet_onnx(5)
    t_enc = time.perf_counter() - t0
    om = ONNXModel(data)
    del data
    cfg = FFConfig()
    cfg.batch_size = ONNX_BATCH
    cfg.only_data_parallel = True
    cfg.kernel_impls = "opt_update:fused"
    cfg.seed = 0
    ff = FFModel(cfg)
    x_t = ff.create_tensor((ONNX_BATCH, 3, 229, 229), name="input")
    (out,) = om.apply(ff, {"input": x_t})
    ff.compile(AdamOptimizer(1e-4, epsilon=1e-4),
               "sparse_categorical_crossentropy", [], output_tensor=out)
    om.copy_weights(ff)
    _, n_leaves, adam = leaf_counts(ff)
    print(f"[frontends] onnx: AlexNet ({len(ini) // 2} weight layers, "
          f"{sum(a.size for a in ini.values())} parameters) encoded with "
          f"onnx_wire in {t_enc:.2f} s, imported through ONNXModel.apply "
          f"and copy_weights: {len(ff.layers)} layers, {n_leaves} leaves, "
          f"{time.perf_counter() - t0:.2f} s in all")
    rng = np.random.default_rng(6)
    xs = rng.standard_normal((ONNX_BATCH, 3, 229, 229), dtype=np.float32)
    y = rng.integers(0, ZOO_CLASSES, (ONNX_BATCH, 1)).astype(np.int32)
    sess = InferenceSession(ff, batch_buckets=(ONNX_BATCH,))
    probs = sess.infer({"input": xs})
    logits = ff.executor.scored_forward(ff.params, ff.state,
                                        {"input": xs}).float()
    oracle = alexnet_oracle(ini, torch.from_numpy(xs).cuda())
    scale = float(oracle.abs().max())
    err = float((logits - oracle).abs().max()) / scale
    perr = float(np.abs(probs - torch.softmax(oracle, -1).cpu().numpy())
                 .max())
    agree = float((logits.argmax(-1) == oracle.argmax(-1)).float().mean())
    ok = probs.shape == (ONNX_BATCH, ZOO_CLASSES) \
        and bool(np.isfinite(probs).all()) and err <= ONNX_TOL
    print(f"[frontends] onnx: InferenceSession.infer of {ONNX_BATCH} rows "
          f"{probs.shape}; logits against the f32 oracle (F.conv2d, "
          f"F.max_pool2d, F.linear): max|diff| = {err:.3e} of max|logit| "
          f"{scale:.3f} (tol {ONNX_TOL:.0e}), probabilities max|diff| "
          f"{perr:.3e}, argmax agrees on {agree:.3f} of rows "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "ONNX AlexNet logits against the oracle")
    del sess, logits, oracle
    fns = zero_counts()   # the main path: fit
    history = ff.fit([xs], y, epochs=FE_STEPS, verbose=False)
    launches = {name: fn.launches for name, fn in fns.items()}
    want = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "adam_update": adam * FE_STEPS}
    losses = [r["loss"] for r in history]
    print(f"[frontends] onnx: fit, {FE_STEPS} steps, loss "
          f"{[round(v, 5) for v in losses]}; launches {launches} (want "
          f"{want})")
    check(launches == want, f"ONNX launches {launches} != {want}")
    check(all(np.isfinite(v) for v in losses), f"ONNX losses {losses}")
    res = {"launches": launches, "logit_err": err, "adam_per_step": adam}
    del ff, om
    free_cuda()
    return res


def phase_frontends(smi: str) -> dict:
    """The frontends on the card: (a) a torch.nn BERT-base imported
    through torch.fx (the slice's main path), (b) the Keras layer set at
    BERT-base width with callbacks, (c) ONNX AlexNet through the wire
    codec."""
    res = {}
    for name, fn, a in (("fx", fe_fx, (smi,)), ("keras", fe_keras, ()),
                        ("onnx", fe_onnx, ())):
        t0 = time.perf_counter()
        res[name] = fn(*a)
        print(f"[wall] frontends {name}: {time.perf_counter() - t0:.1f} s")
    return res


RES_EPOCHS = 2        # epochs of each supervised run
RES_BATCHES = 4       # batches of 8 rows an epoch
RES_EVERY = 2         # checkpoint every 2 steps
RES_KEEP = 2          # max_to_keep
# a NaN poisoning after step 3 (rolled back to step 2 at the step-4
# save), then a corrupted step-6 checkpoint and a crash before step 6
# (the restore walks past 6 to the epoch boundary at 4)
RES_PLAN = "nan@3;corrupt_ckpt@6;crash@6"
# steps the faulty run executes, replays included: 0-3, 2-3 again, 4-5,
# then 4-7 again
RES_EXECUTED = 12
RES_DISK_BYTES = 8e9  # two run directories and the timing saves
RES_WRAPPER_CALLS = 200_000
RES_ABBA_STEPS = 6    # timed steps per block of the tracing on/off ABBA
RES_LEAVES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "data", "bert_base_checkpoint_leaves.json")


def res_model(trace_file: str):
    """BERT-base 8x128 for the resilience phase: dropout 0.1, Adam 1e-4,
    flash + fused Adam, tracing on with a Chrome-trace export."""
    return train_model(128, "attention:flash,opt_update:fused",
                       trace="true", trace_export_file=trace_file)


def host_state(ff) -> dict:
    """Host copies of the params and Adam's m and v."""
    return {slot: {ln: {wn: t.detach().cpu().clone()
                        for wn, t in ws.items()}
                   for ln, ws in tree.items()}
            for slot, tree in (("params", ff.params),
                               ("m", ff.opt_state["m"]),
                               ("v", ff.opt_state["v"]))}


def supervised_run(ff, directory: str, x, y) -> dict:
    """One Supervisor run over the phase's epochs with every kernel's
    launches and the executed steps counted. The executor's step wrapper
    counts every step it runs, replays included, in the trace's
    ``executor.train_steps`` counter (``_step`` is rewound by each
    restore, so it cannot count them)."""
    from flexflow_tpu_torch.obs import events
    from flexflow_tpu_torch.resilience import Supervisor
    check(events.enabled(), "tracing is off: the executed steps would "
          "not be counted")
    steps0 = events.counters().get("executor.train_steps", 0)
    torch.cuda.synchronize()
    fns = zero_counts()   # the main path: every count starts at 0
    t0 = time.perf_counter()
    sup = Supervisor(ff, directory, checkpoint_every=RES_EVERY,
                     max_to_keep=RES_KEEP)
    hist = sup.run(x, y, epochs=RES_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    steps = int(events.counters().get("executor.train_steps", 0) - steps0)
    want = {"flash_attention_fwd": LAYERS * steps,
            "flash_attention_bwd_dq": LAYERS * steps,
            "flash_attention_bwd_dkv": LAYERS * steps,
            "adam_update": steps}
    check(launches == want, f"resilience launches {launches} != {want} "
          f"for {steps} executed steps")
    return {"sup": sup, "hist": hist, "wall_s": wall, "steps": steps,
            "launches": launches}


def span_seconds(path: str) -> dict:
    """Seconds spent in each span name of an exported Chrome trace
    (nested spans count in each of their names)."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    out: dict = {}
    for e in evs:
        if e["ph"] == "X":
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
    return out


def check_trace(path: str) -> dict:
    """The faulty run's exported Chrome trace: it parses and holds the
    spans and instants the phase names."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    want = {"model.compile", "executor.train_step", "supervisor.epoch",
            "supervisor.save", "ckpt.save", "ckpt.restore"}
    check(want <= names, f"trace lacks {sorted(want - names)}")
    phases = [e["args"]["phase"] for e in spans
              if e["name"] == "executor.train_step"]
    check(phases[0] == "compile" and set(phases[1:]) == {"steady"},
          f"train_step phases {phases}")
    restarts = [e for e in evs
                if e["ph"] == "i" and e["name"] == "resilience.restart"]
    check(len(restarts) == 2, f"{len(restarts)} resilience.restart "
          f"instants, want 2")
    counts = {n: sum(e["name"] == n for e in spans) for n in sorted(want)}
    print(f"[resilience] trace {os.path.basename(path)}: {len(evs)} "
          f"events, spans {counts}, train_step phases {phases[0]} then "
          f"{len(phases) - 1} x steady, resilience.restart instants "
          f"{[e['args']['reason'] for e in restarts]}")
    return counts


def check_metrics() -> None:
    from flexflow_tpu_torch.obs.metrics_registry import REGISTRY
    text = REGISTRY.render()
    lines = [ln for ln in text.splitlines() if not ln.startswith("#")]
    want = ["ff_checkpoint_saves_total ",
            'ff_resilience_restarts_total{reason="SimulatedCrash"} ',
            'ff_resilience_restarts_total{reason="nan_loss"} ',
            "ff_checkpoint_corrupt_skipped_total ",
            "ff_train_samples_per_sec ",
            'ff_model_compiles_total{model="<unnamed>"} ']
    got = [ln for ln in lines if any(ln.startswith(w) for w in want)]
    missing = [w for w in want if not any(ln.startswith(w) for ln in got)]
    check(not missing, f"exposition lacks {missing}")
    print("[resilience] exposition: " + "; ".join(got))


def check_manifest(step_dir: str) -> int:
    """The port's manifest of one BERT-base step lists the leaf keys,
    shapes and dtypes that the JAX package's keystr gives for this model
    (tests/data/bert_base_checkpoint_leaves.json, made and checked by
    the CPU tests)."""
    with open(RES_LEAVES) as f:
        want = json.load(f)["leaves"]
    with open(os.path.join(step_dir, "manifest.json")) as f:
        got = {k: {"shape": r["shape"], "dtype": r["dtype"]}
               for k, r in json.load(f)["leaves"].items()}
    check(got == want, f"manifest leaves differ from the JAX package's: "
          f"{sorted(set(got) ^ set(want))[:4]}")
    return len(got)


def identical(a: dict, b: dict) -> tuple:
    """(leaves compared, leaves that differ in any bit)."""
    n, bad = 0, []
    for slot in a:
        for ln in a[slot]:
            for wn, t in a[slot][ln].items():
                n += 1
                if not torch.equal(t, b[slot][ln][wn]):
                    bad.append(f"{slot}/{ln}/{wn}")
    return n, bad


def save_restore_times(ff, tmp: str, smi: str) -> dict:
    """Blocking save, async save (caller side and until wait()), and
    restore with its CRC share, of the whole training state."""
    from flexflow_tpu_torch.runtime import checkpoint as ck
    nbytes = sum(t.numel() * t.element_size()
                 for tree in (ff.params, ff.opt_state["m"],
                              ff.opt_state["v"])
                 for ws in tree.values() for t in ws.values())
    d = os.path.join(tmp, "timing")
    mgr = ck.CheckpointManager(d, max_to_keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save_model_checkpoint(ff, d, step=1, manager=mgr, blocking=True)
    save_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save_model_checkpoint(ff, d, step=2, manager=mgr, blocking=False)
    caller_s = time.perf_counter() - t0
    mgr.wait()
    async_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = ck.restore_model_checkpoint(ff, d)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(step == 2, f"restored step {step}")
    t0 = time.perf_counter()
    state, _ = mgr.restore(2, verify=False)
    load_s = time.perf_counter() - t0
    with open(os.path.join(d, "2", "manifest.json")) as f:
        manifest = json.load(f)
    t0 = time.perf_counter()
    ck._verify_manifest(state, manifest, "timing")
    crc_s = time.perf_counter() - t0
    del state
    print(f"[resilience] checkpoint of {nbytes / 1e9:.3f} GB (params + "
          f"Adam m, v; f32): blocking save {save_s:.3f} s = "
          f"{nbytes / save_s / 1e9:.3f} GB/s (host copy, CRC32, pickle, "
          f"fsync, rename); async save returns to the caller in "
          f"{caller_s:.3f} s, wait() after {async_s:.3f} s; restore "
          f"{restore_s:.3f} s = {nbytes / restore_s / 1e9:.3f} GB/s (load "
          f"{load_s:.3f} s without the CRC check; the CRC32 check "
          f"{crc_s:.3f} s = {crc_s / restore_s:.3f} of the restore); "
          f"{smi}")
    shutil.rmtree(d, ignore_errors=True)
    return dict(bytes=nbytes, save_s=save_s, caller_s=caller_s,
                async_s=async_s, restore_s=restore_s, load_s=load_s,
                crc_s=crc_s)


def step_ms(ff, step_fn, batch, n: int) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        ff._run_train_step(step_fn, batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def overhead_times(ff, bcfg, smi: str) -> dict:
    """The host cost that telemetry and fault injection add to a step
    when both are off, each measured directly on a no-op (the code
    around a no-op against the no-op): the step wrapper per call, the
    fault sites of ``_run_train_step`` per step (no plan installed), and
    ``fit``'s per-epoch span and gauge; their sum per step against the
    train-step median. Then the step median with tracing on and off,
    interleaved off, on, on, off (printed only)."""
    from flexflow_tpu_torch.executor import _instrument_step
    from flexflow_tpu_torch.obs import events
    from flexflow_tpu_torch.obs.metrics_registry import REGISTRY
    from flexflow_tpu_torch.resilience import faults
    x, y = dataset(bcfg, 128, 8, 3)
    batch = {"input_ids": torch.from_numpy(x[0]).cuda(),
             "position_ids": torch.from_numpy(x[1]).cuda(),
             "label": torch.from_numpy(y).cuda()}
    step_fn = ff.executor.make_train_step()
    events.disable()
    faults.clear()
    check(not faults.active(), "a fault plan is still installed")
    step_ms(ff, step_fn, batch, 3)
    off = step_ms(ff, step_fn, batch, 2 * RES_ABBA_STEPS)
    step_med = float(np.median(off))
    n = RES_WRAPPER_CALLS

    def per_call_us(fn, *args) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        return (time.perf_counter() - t0) / n * 1e6

    def noop():
        return None

    wrap_us = max(per_call_us(_instrument_step(noop, "bench"))
                  - per_call_us(noop), 0.0)

    def noop_step(params, opt_state, state, step, b):
        return params, opt_state, state, {}

    def bare_step(fn, b):
        # _run_train_step without its fault sites
        ff.params, ff.opt_state, ff.state, bm = fn(
            ff.params, ff.opt_state, ff.state, ff._step, b)
        ff._step += 1
        return bm

    step0 = ff._step
    fault_us = max(per_call_us(ff._run_train_step, noop_step, batch)
                   - per_call_us(bare_step, noop_step, batch), 0.0)
    ff._step = step0

    def epoch_telemetry():
        # fit's per-epoch span and gauge, as fit records them
        events.record_span("fit.epoch", 0.0, 1.0, epoch=0,
                           batches=RES_BATCHES)
        REGISTRY.gauge("ff_train_samples_per_sec",
                       "Training throughput of the last completed epoch"
                       ).set(1.0)

    epoch_us = per_call_us(epoch_telemetry)
    total_us = wrap_us + fault_us + epoch_us / RES_BATCHES
    share = total_us / (step_med * 1e3)
    print(f"[resilience] disabled-mode host cost ({n} calls each, code "
          f"around a no-op minus the no-op): step wrapper {wrap_us:.4f} "
          f"us a call, fault sites of _run_train_step {fault_us:.4f} us a "
          f"step, fit's epoch span + gauge {epoch_us:.4f} us an epoch "
          f"({RES_BATCHES} steps); together {total_us:.4f} us a step "
          f"against the train-step median {step_med:.3f} ms (tracing "
          f"off, {len(off)} steps): {100 * share:.5f}% of a step (limit "
          f"3%)")
    check(share <= 0.03, f"disabled telemetry and fault sites cost "
          f"{100 * share:.3f}% of a step")
    blocks = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        if mode == "on":
            events.enable()
        else:
            events.disable()
        blocks[mode] += step_ms(ff, step_fn, batch, RES_ABBA_STEPS)
    events.disable()
    on_ms = float(np.median(blocks["on"]))
    off_ms = float(np.median(blocks["off"]))
    print(f"[resilience] train step with tracing on / off, interleaved "
          f"off-on-on-off, {2 * RES_ABBA_STEPS} steps each: median "
          f"{on_ms:.3f} / {off_ms:.3f} ms (host clock, each step ends in "
          f"a device sync; printed only); {smi}")
    return dict(wrap_us=wrap_us, fault_us=fault_us, epoch_us=epoch_us,
                step_ms=step_med, share=share, traced_ms=on_ms,
                untraced_ms=off_ms)


def phase_resilience(smi: str) -> dict:
    """Checkpointing, fault injection, the Supervisor and telemetry on
    the card: BERT-base 8x128 (dropout 0.1, Adam 1e-4, flash + fused
    Adam) trained by the Supervisor twice from the same seed, clean and
    under RES_PLAN; the faulty run must end bit-identical to the clean
    one with every executed step (replays included) through the kernels.
    Then the serving fault hook, the cross-package manifest, the trace
    and metrics, and the save / restore / overhead numbers."""
    import tempfile
    from flexflow_tpu_torch.obs import events
    from flexflow_tpu_torch.resilience import faults, status
    from flexflow_tpu_torch.serving import InferenceSession
    tmp = tempfile.mkdtemp(prefix="ff_resilience_")
    try:
        free = shutil.disk_usage(tmp).free
        check(free >= RES_DISK_BYTES,
              f"{free / 1e9:.1f} GB free under {tmp}; the resilience "
              f"phase needs {RES_DISK_BYTES / 1e9:.0f} GB")
        runs = {}
        for name, plan in (("clean", ""), ("faulty", RES_PLAN)):
            events.clear()
            status.reset()
            faults.install(plan)
            trace = os.path.join(tmp, f"{name}_trace.json")
            ff, bcfg = res_model(trace)
            x, y = dataset(bcfg, 128, RES_BATCHES * 8, 7)
            r = supervised_run(ff, os.path.join(tmp, name), x, y)
            r.update(state=host_state(ff), trace=trace,
                     status=status.snapshot())
            sup = r.pop("sup")
            r.update(restarts=sup.restarts, rollbacks=sup.nan_rollbacks)
            print(f"[resilience] {name} run (plan {plan!r}): "
                  f"{RES_EPOCHS} epochs x {RES_BATCHES} batches, "
                  f"checkpoint every {RES_EVERY} steps, max_to_keep "
                  f"{RES_KEEP}: {r['steps']} steps executed, wall "
                  f"{r['wall_s']:.3f} s, restarts {r['restarts']}, NaN "
                  f"rollbacks {r['rollbacks']}, launches "
                  f"{r['launches']}, history "
                  f"{[round(h['loss'], 6) for h in r['hist']]}")
            print(f"[resilience] {name} status.snapshot() {r['status']}")
            secs = span_seconds(trace)
            print(f"[resilience] {name} run, seconds by span (host clock; "
                  f"a save span holds its ckpt.save): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                      secs.items())))
            runs[name] = r
            if name == "clean":
                shutil.rmtree(os.path.join(tmp, name), ignore_errors=True)
                del ff
                free_cuda()
        clean, faulty = runs["clean"], runs["faulty"]
        check(clean["steps"] == RES_EPOCHS * RES_BATCHES
              and faulty["steps"] == RES_EXECUTED,
              f"executed steps {clean['steps']} / {faulty['steps']}, want "
              f"{RES_EPOCHS * RES_BATCHES} / {RES_EXECUTED}")
        check((faulty["restarts"], faulty["rollbacks"]) == (2, 1)
              and faulty["status"]["corrupt_checkpoints_skipped"] == 1
              and faulty["status"]["faults_injected"] == 3,
              f"faulty run recovered {faulty['restarts']} / "
              f"{faulty['rollbacks']} times, status {faulty['status']}")
        n, bad = identical(clean["state"], faulty["state"])
        loss_c, loss_f = clean["hist"][-1]["loss"], faulty["hist"][-1]["loss"]
        print(f"[resilience] faulty vs clean: {n} leaves (params, Adam m "
              f"and v) compared, {len(bad)} differ in any bit "
              f"{bad[:4]}; last epoch's loss {loss_f!r} vs {loss_c!r}; "
              f"wall {faulty['wall_s']:.3f} s vs {clean['wall_s']:.3f} s "
              f"({faulty['wall_s'] / clean['wall_s']:.3f}x)")
        check(not bad and loss_f == loss_c,
              "the faulty run did not end bit-identical to the clean run")
        del runs["clean"]["state"], runs["faulty"]["state"]
        newest = os.path.join(tmp, "faulty", str(RES_EPOCHS * RES_BATCHES))
        nleaves = check_manifest(newest)
        print(f"[resilience] manifest of step {RES_EPOCHS * RES_BATCHES}: "
              f"{nleaves} leaves, keys, shapes and dtypes equal to the "
              f"JAX package's keystr tree for this model")
        spans = check_trace(faulty["trace"])
        check_metrics()
        path = faulty["status"]["last_flight_record"]
        check(path is not None and os.path.exists(path),
              f"no flight record at {path}")
        with open(path) as f:
            rec = json.load(f)
        check(rec["reason"] == "nan_rollback", f"flight record {rec}")
        print(f"[resilience] flight record {path}: reason "
              f"{rec['reason']}, {len(rec['events'])} events, exception "
              f"{rec.get('exception')!r}")

        # serving fault hook: the second call fails, the third answers
        # the first's logits bit for bit
        sess = InferenceSession(ff, batch_buckets=(8,))
        req = requests(bcfg, 128, 8, 5)
        faults.install("infer_fail@1")
        fwd = zero_counts()["flash_attention_fwd"]
        first = sess.infer(req)
        try:
            sess.infer(req)
            raised = None
        except faults.FaultError as e:
            raised = e
        third = sess.infer(req)
        faults.clear()
        check(raised is not None and np.array_equal(first, third)
              and fwd.launches == 2 * LAYERS,
              f"serving fault hook: raised {raised!r}, equal "
              f"{np.array_equal(first, third)}, flash launches "
              f"{fwd.launches}")
        print(f"[resilience] InferenceSession.infer under 'infer_fail@1': "
              f"call 2 raised {raised!r}; call 3 equals call 1 bit for "
              f"bit ({first.shape}); {fwd.launches} flash launches")

        events.disable()
        times = save_restore_times(ff, tmp, smi)
        times.update(overhead_times(ff, bcfg, smi))
        return {"launches": faulty["launches"], "steps": faulty["steps"],
                "clean_launches": clean["launches"], "spans": spans,
                "wall_s": (faulty["wall_s"], clean["wall_s"]), **times}
    finally:
        events.disable()
        faults.clear()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the strategy search on one card
# ---------------------------------------------------------------------------
SEARCH_SEQ = 512                   # BERT-base 8 x 512, uncut
SEARCH_BUDGET = 8
SEARCH_FIT_STEPS = 3               # fit steps of the searched model
SEARCH_TIMED_STEPS = 6             # timed steps after the fit
SEARCH_EXTRA_SEQS = (1024, 2048, 4096)   # beyond the table's s128/s512
RECOMPILE_SEQ = 128
RECOMPILE_BATCHES = 3              # batches per epoch; 2 epochs
RECOMPILE_ALPHA = 5e-5             # Adam's alpha after the trigger
SEARCH_DEVICE = "cuda"             # the CPU rehearsal test sets "cpu"


def search_bert_config():
    """BERT-base, uncut (the CPU rehearsal test swaps in a tiny one)."""
    from flexflow_tpu_torch.models import BertConfig
    return BertConfig.base()


def search_model(seq: int, dropout: float, **cfg_kw):
    """BERT-base (``BertConfig.base()``, uncut) at 8 x seq with Adam 1e-4,
    built through FFModel.compile with the config overrides given."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models import build_bert
    cfg = FFConfig()
    cfg.batch_size = 8
    cfg.seed = 0
    cfg.device = SEARCH_DEVICE
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    ff = FFModel(cfg)
    bcfg = search_bert_config()
    bcfg.max_position = seq
    bcfg.dropout = dropout
    out = build_bert(ff, 8, seq, bcfg)
    ff.compile(AdamOptimizer(1e-4), "sparse_categorical_crossentropy",
               ["accuracy"], output_tensor=out)
    return ff, bcfg


def plan_launches(ff, steps: int, remat: bool = False) -> dict:
    """The launches ``steps`` train steps make under the model's adopted
    kernel plan: one forward, dq and dk/dv per flash layer (two forwards
    with block remat), ceil(leaves / 384) fused Adam launches."""
    plan = ff.executor._kernel_impls
    n_flash = sum(1 for l in ff.executor.program.layers
                  if plan.get(l.name) == "flash")
    leaves = sum(len(ws) for ws in ff.params.values())
    adam = -(-leaves // 384) if plan.get("opt_update") == "fused" else 0
    return {"flash_attention_fwd": n_flash * steps * (2 if remat else 1),
            "flash_attention_bwd_dq": n_flash * steps,
            "flash_attention_bwd_dkv": n_flash * steps,
            "adam_update": adam * steps}


def snapshot(ff) -> dict:
    """A copy of the model's weights."""
    return {ln: {wn: t.detach().clone() for wn, t in ws.items()}
            for ln, ws in ff.params.items()}


def load_params(ff, snap: dict) -> None:
    with torch.no_grad():
        for ln, ws in snap.items():
            for wn, t in ws.items():
                ff.params[ln][wn].copy_(t)


def bert_data(seq: int, rows: int, seed: int):
    return dataset(search_bert_config(), seq, rows, seed)


def device_batch(x, y) -> dict:
    return {"input_ids": torch.from_numpy(x[0]).to(SEARCH_DEVICE),
            "position_ids": torch.from_numpy(x[1]).to(SEARCH_DEVICE),
            "label": torch.from_numpy(y).to(SEARCH_DEVICE)}


def timed_steps(ff, batch, n: int) -> list:
    """Host-clock ms of ``n`` train steps, each ending in a device sync."""
    step_fn = ff.executor.make_train_step()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        ff._run_train_step(step_fn, batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def search_calibration(smi: str, cache: str) -> dict:
    """The calibration the search prices with, measured on the card: the
    bf16 matmul chain (mxu_eff), the host dispatch and memory-bandwidth
    rows, the op_attention@flash / @xla rows at s 128 and 512 (the
    package's sizes), then both impls at SEARCH_EXTRA_SEQS timed the same
    way, and the crossover they give."""
    from flexflow_tpu_torch.parallel.machine import DeviceMesh, MachineSpec
    from flexflow_tpu_torch.search.calibration import (
        CalibrationTable, _attn_seq_len, _bench_attention_impl,
        attention_bench_fn, calibrate_kernel_impls, calibrate_mesh,
        shape_class, ATTN_IMPL_SIZES)
    from flexflow_tpu_torch.search.costmodel import OpCostModel
    spec = MachineSpec.detect("cuda")
    dmesh = DeviceMesh(spec, devices=["cuda"])
    cm = OpCostModel(spec)
    achieved = cm.calibrate("cuda")
    tab = CalibrationTable(cache)
    calib = calibrate_mesh(dmesh, table=tab)
    fns = zero_counts()
    calibrate_kernel_impls(dmesh, tab)
    calib_launches = fns["flash_attention_fwd"].launches
    rows = {}
    for impl in ("xla", "flash"):
        for nb in ATTN_IMPL_SIZES:
            s = _attn_seq_len(nb)
            rows[(impl, s)] = tab.get(
                "cuda", f"op_attention@{impl}", "float32",
                shape_class(4 * 8 * 64 * s), 0)
    for s in SEARCH_EXTRA_SEQS:
        for impl in ("xla", "flash"):
            rows[(impl, s)] = _bench_attention_impl(impl, s, "cuda")
    # device time of the same calls by CUDA-graph replay (no host
    # launch gaps), beside the event-timed rows the search prices with
    dev_ms = {}
    with torch.no_grad():
        for s in (128, 512) + SEARCH_EXTRA_SEQS:
            for impl in ("xla", "flash"):
                dev_ms[(impl, s)] = cuda_time_ms(
                    attention_bench_fn(impl, s, "cuda"), iters=5)
        # the library call at the table's shapes (timed only): SDPA on
        # the backend it picks for b1 h8 d64 f32 causal
        for s in (128, 512):
            q, k, v = (torch.randn(1, 8, s, 64, device="cuda")
                       for _ in range(3))
            dev_ms[("sdpa", s)] = cuda_time_ms(
                lambda q=q, k=k, v=v:
                torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True), iters=5)
    check(tab.measured == 2 + 2 * len(ATTN_IMPL_SIZES),
          f"calibration rows measured {tab.measured}")
    # each row: 2 warm-up calls and 3 timed ones
    check(calib_launches == len(ATTN_IMPL_SIZES) * (2 + 3),
          f"calibration launched the flash forward {calib_launches} times")
    seqs = sorted({s for _, s in rows})

    def crossover(t):
        """The shortest measured length from which flash wins at every
        longer one too (None: xla wins at the longest)."""
        out = None
        for s in reversed(seqs):
            if t[("flash", s)] >= t[("xla", s)]:
                break
            out = s
        return out

    cross, cross_dev = crossover(rows), crossover(dev_ms)
    print(f"[search] calibration on {smi}: bf16 matmul chain "
          f"{achieved / 1e12:.1f} TFLOP/s, mxu_eff {cm.mxu_eff:.4f} of "
          f"{spec.peak_flops / 1e12:.1f}; host dispatch "
          f"{calib.dispatch_s * 1e6:.3f} us/op; HBM streaming read "
          f"{calib.mem_bw / 1e9:.1f} GB/s; flash forward launched "
          f"{calib_launches} times while calibrating")
    for s in seqs:
        src = "table" if s in (128, 512) else "phase"
        print(f"[search] op_attention b1 h8 s{s} d64 f32 causal ({src}): "
              f"xla {rows[('xla', s)] * 1e6:.2f} us, flash "
              f"{rows[('flash', s)] * 1e6:.2f} us (event-timed); device "
              f"{dev_ms[('xla', s)] * 1e3:.2f} / "
              f"{dev_ms[('flash', s)] * 1e3:.2f} us (graph replay)")
    print(f"[search] library: SDPA b1 h8 d64 f32 causal, device "
          f"{dev_ms[('sdpa', 128)] * 1e3:.2f} us at s128, "
          f"{dev_ms[('sdpa', 512)] * 1e3:.2f} us at s512 (graph replay)")
    print(f"[search] flash/xla crossover: flash is faster at every "
          f"measured length from s = {cross} (event-timed, what the search "
          f"prices with), s = {cross_dev} (device time); "
          f"FLASH_AUTO_MIN_SEQ stays 1024")
    return {"achieved_tflops": achieved / 1e12, "mxu_eff": cm.mxu_eff,
            "dispatch_us": calib.dispatch_s * 1e6,
            "membw_gbs": calib.mem_bw / 1e9,
            "rows_us": {f"{i}@{s}": v * 1e6 for (i, s), v in rows.items()},
            "device_us": {f"{i}@{s}": v * 1e3
                          for (i, s), v in dev_ms.items()},
            "crossover": cross, "crossover_device": cross_dev,
            "launches": calib_launches}


def searched_bert(smi: str) -> dict:
    """BERT-base 8x512 compiled with search_budget=8 and calibration on
    (the search, the floor guard and the measured kernel plan), its
    3-step fit counted against the plan, 6 timed steps against the
    search's prediction; then the same model data-parallel on the
    default plan (plain attention, unfused Adam) from the same weights,
    whose dropout-0 loss history the searched one must match."""
    x, y = bert_data(SEARCH_SEQ, 8, 21)
    t0 = time.perf_counter()
    ff, _ = search_model(SEARCH_SEQ, 0.0, search_budget=SEARCH_BUDGET,
                         calibration_v2="true")
    compile_s = time.perf_counter() - t0
    phases = dict(ff._compile_phases)
    search_s = phases["search_s"]
    rec = ff._kernel_record
    impls = sorted({(o["op"], o["impl"]) for o in rec["ops"]})
    init = snapshot(ff)
    fns = zero_counts()  # the main path of the searched model
    h_s = [r["loss"] for r in ff.fit(x, y, epochs=SEARCH_FIT_STEPS,
                                     verbose=False)]
    launches = {n: f.launches for n, f in fns.items()}
    want = plan_launches(ff, SEARCH_FIT_STEPS)
    check(launches == want, f"searched launches {launches} != {want}")
    check(want["flash_attention_fwd"] > 0 and want["adam_update"] > 0,
          f"the measured plan chose no kernel: {impls}")
    ms = timed_steps(ff, device_batch(x, y), SEARCH_TIMED_STEPS)
    pred = ff._search_predicted["searched_cost_s"] * 1e3
    guard = getattr(ff, "_floor_guard_record", None)
    check(guard is not None and guard["adopted"] in ("searched", "dp"),
          f"the floor guard did not run: {guard}")
    del ff
    free_cuda()
    dp, _ = search_model(SEARCH_SEQ, 0.0, only_data_parallel=True)
    check(not dp.executor._kernel_impls, "the DP run planned kernels")
    load_params(dp, init)
    del init
    h_dp = [r["loss"] for r in dp.fit(x, y, epochs=SEARCH_FIT_STEPS,
                                      verbose=False)]
    del dp
    err = float(np.abs(np.array(h_s) - np.array(h_dp)).max())
    print(f"[search] BERT-base 8x{SEARCH_SEQ}, search_budget "
          f"{SEARCH_BUDGET}, calibration on: compile {compile_s:.3f} s, "
          f"of which the search {search_s:.3f} s ({phases}); plan {impls} "
          f"(measured {rec['measured']}, {rec['n_nondefault']}/"
          f"{rec['n_ops']} ops off the default); floor guard {guard}")
    print(f"[search] kernel record ops[0] {rec['ops'][0]}; "
          f"ops[-1] {rec['ops'][-1]}")
    print(f"[search] fit {SEARCH_FIT_STEPS} steps: launches {launches} "
          f"(the plan's {want}); predicted step {pred:.3f} ms vs "
          f"measured median {float(np.median(ms)):.3f} ms of "
          f"{SEARCH_TIMED_STEPS} (p90 {float(np.percentile(ms, 90)):.3f})")
    print(f"[search] dropout 0 loss: searched {[round(v, 6) for v in h_s]} "
          f"vs data-parallel on the default plan "
          f"{[round(v, 6) for v in h_dp]}: max|diff| {err:.3e} "
          f"(tol {TRAIN_TOL:.0e})")
    check(err <= TRAIN_TOL and np.all(np.isfinite(h_s)),
          "searched and data-parallel loss histories disagree")
    return {"launches": launches, "search_s": search_s,
            "phases": phases,
            "compile_s": compile_s, "predicted_ms": pred,
            "step_ms": float(np.median(ms)), "guard": guard,
            "plan": impls, "err": err}


def remat_check(smi: str) -> dict:
    """The same BERT-base 8x512 train step with remat="blocks" against
    none, flash + fused Adam, dropout 0.1: bit-identical loss histories
    from the same weights, 24 / 12 / 12 / ceil(leaves / 384) launches a
    step with remat, peak memory and the median step of both."""
    x, y = bert_data(SEARCH_SEQ, 8, 23)
    batch = device_batch(x, y)
    out = {}
    init = None
    for remat in ("none", "blocks"):
        ff, _ = search_model(SEARCH_SEQ, 0.1, only_data_parallel=True,
                             kernel_impls="attention:flash,opt_update:fused",
                             remat=remat)
        check((ff.executor._remat is not None) == (remat == "blocks"),
              f"remat={remat}: blocks {ff.executor._remat}")
        if init is None:
            init = snapshot(ff)
        else:
            load_params(ff, init)
        step_fn = ff.executor.make_train_step()
        torch.cuda.synchronize()
        fns = zero_counts()
        hist = [float(ff._run_train_step(step_fn, batch)["loss"])
                for _ in range(SEARCH_FIT_STEPS)]
        launches = {n: f.launches for n, f in fns.items()}
        want = plan_launches(ff, SEARCH_FIT_STEPS, remat == "blocks")
        check(launches == want,
              f"remat={remat} launches {launches} != {want}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = timed_steps(ff, batch, SEARCH_TIMED_STEPS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[remat] = {"hist": hist, "launches": launches, "peak_gb": peak,
                      "step_ms": float(np.median(ms))}
        del ff, step_fn
        free_cuda()
        print(f"[search] remat={remat}: losses {hist}; launches "
              f"{launches}; peak {peak:.3f} GB; median step "
              f"{float(np.median(ms)):.3f} ms")
    same = out["none"]["hist"] == out["blocks"]["hist"]
    print(f"[search] remat bit-identical to no remat at dropout 0.1: "
          f"{same}; peak {out['blocks']['peak_gb']:.3f} vs "
          f"{out['none']['peak_gb']:.3f} GB; step "
          f"{out['blocks']['step_ms']:.3f} vs "
          f"{out['none']['step_ms']:.3f} ms")
    check(same, "remat changed the loss history")
    return out


class _AlphaAt:
    """An epoch callback that sets Adam's alpha after epoch ``epoch``:
    the hand-made twin of the recompile trigger."""
    stop_requested = False

    def __init__(self, epoch: int, alpha: float):
        self.epoch, self.alpha = epoch, alpha

    def on_epoch_end(self, epoch, logs=None, model=None):
        if epoch == self.epoch:
            model.optimizer.alpha = self.alpha


def recompile_check() -> dict:
    """A 2-epoch fit of BERT-base 8x128 (flash + fused Adam, dropout
    0.1) whose recompile trigger fires once, after the last step of the
    first epoch, and whose alter changes Adam's alpha; the same fit from
    the same weights with the alpha changed by hand there (an epoch
    callback) must give the same history, and ff_recompiles_total must
    rise by 1."""
    from flexflow_tpu_torch.obs.metrics_registry import REGISTRY
    x, y = bert_data(RECOMPILE_SEQ, 8 * RECOMPILE_BATCHES, 29)
    counter = REGISTRY.counter("ff_recompiles_total")
    before = counter.value()
    hists, init = {}, None
    for how in ("trigger", "hand"):
        ff, _ = search_model(RECOMPILE_SEQ, 0.1, only_data_parallel=True,
                             kernel_impls="attention:flash,opt_update:fused")
        if init is None:
            init = snapshot(ff)
        else:
            load_params(ff, init)
        cbs = None
        if how == "trigger":
            rs = ff.recompile_on_condition(
                lambda s: s.iteration == RECOMPILE_BATCHES,
                lambda s: setattr(s.ff.optimizer, "alpha",
                                  RECOMPILE_ALPHA))
        else:
            cbs = [_AlphaAt(0, RECOMPILE_ALPHA)]
        fns = zero_counts()
        hists[how] = [r["loss"] for r in ff.fit(
            x, y, epochs=2, callbacks=cbs, verbose=False)]
        launches = {n: f.launches for n, f in fns.items()}
        want = plan_launches(ff, 2 * RECOMPILE_BATCHES)
        check(launches == want,
              f"recompile {how}: launches {launches} != {want}")
        check(ff.optimizer.alpha == RECOMPILE_ALPHA, "alpha unchanged")
        if how == "trigger":
            check(rs.recompilations == 1,
                  f"{rs.recompilations} recompiles")
        del ff
        free_cuda()
    recompiles = counter.value() - before
    print(f"[search] recompile_on_condition: 2 epochs x "
          f"{RECOMPILE_BATCHES} batches of BERT-base 8x{RECOMPILE_SEQ}, "
          f"alpha 1e-4 -> {RECOMPILE_ALPHA} after step "
          f"{RECOMPILE_BATCHES}: ff_recompiles_total +{recompiles:g}; "
          f"losses {hists['trigger']} vs by hand {hists['hand']}; "
          f"launches {launches}")
    check(recompiles == 1, f"ff_recompiles_total rose by {recompiles}")
    check(hists["trigger"] == hists["hand"],
          "the recompiled run's history differs from the hand-made one")
    return {"recompiles": recompiles, "launches": launches}


def phase_search(smi: str) -> dict:
    """The strategy search on one card (module docstring, phase 15)."""
    import tempfile
    cache = tempfile.mkdtemp(prefix="ff_search_cache_")
    os.environ["FF_CACHE_DIR"] = cache
    try:
        cal = search_calibration(smi, cache)
        free_cuda()
        srch = searched_bert(smi)
        free_cuda()
        rem = remat_check(smi)
        free_cuda()
        rc = recompile_check()
        return {"calibration": cal, "searched": srch, "remat": rem,
                "recompile": rc}
    finally:
        os.environ.pop("FF_CACHE_DIR", None)
        shutil.rmtree(cache, ignore_errors=True)


SERVE_REQUESTS = 64   # single-row requests per (front, model)
SERVE_CLIENTS = 16    # client threads per front
SERVE_IDLE = 20       # closed-loop requests of one client per model
SERVE_BUCKETS = (1, 4, 8)
CB_SEQS = 32          # sequences through the continuous batcher
CB_SEG = 8            # its decode segment (budgets are multiples of it)
CB_SLOTS = 8          # the KV budget is this many full-context sequences
SERVE_PLENS = (100, 901)   # ragged GPT-2 prompt lengths [lo, hi)
CB_MAX_SEGMENTS = 8   # budgets of 1 ... 8 segments
PLAN_PLEN = 300       # prompt length of the plan-session comparison
FLEET_REQUESTS = 32
FLEET_CRASH = "infer_crash@6"   # the 7th call of one replica kills it
FLEET_ARGS = ("--model", "gpt2-tiny")   # the replica runs on the card
ROOT = os.path.dirname(os.path.abspath(__file__))


def http_post(url: str, body: bytes, headers=None, timeout: float = 120.0):
    """(status, JSON body, headers) of one POST; HTTP errors included."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def http_get(url: str, timeout: float = 30.0) -> dict:
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def infer_body(batch: dict) -> bytes:
    return json.dumps({"inputs": [
        {"name": k, "shape": list(v.shape), "datatype": "INT32",
         "data": v.ravel().tolist()} for k, v in batch.items()]}).encode()


def client_run(jobs, clients: int) -> list:
    """Run ``jobs`` (callables) on ``clients`` threads; their results in
    job order. A job that raises fails the run."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=clients) as pool:
        futs = [pool.submit(j) for j in jobs]
        return [f.result(timeout=600) for f in futs]


def pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


LOAD_CLIENT = r"""
import json, sys, time, urllib.error, urllib.request
from concurrent.futures import ThreadPoolExecutor
jobs, clients, out = json.load(open(sys.argv[1])), int(sys.argv[2]), sys.argv[3]
def post(j):
    req = urllib.request.Request(j["url"], data=j["body"].encode(),
        method="POST", headers={"Content-Type": "application/json",
                                "x-ff-trace-id": j["trace"]})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return {"code": code, "ms": (time.perf_counter() - t0) * 1e3,
            "doc": json.loads(body or b"{}")}
with ThreadPoolExecutor(max_workers=clients) as pool:
    res = list(pool.map(post, jobs))
json.dump(res, open(out, "w"))
"""


def load_clients(jobs, clients: int) -> list:
    """POST each job (``{"url", "body", "trace"}``) from ``clients``
    threads of another process, so that the server's interpreter runs
    only the server; per job in order ``{"code", "ms", "doc"}``, the
    client's latency on its own clock."""
    import subprocess
    import tempfile
    with tempfile.TemporaryDirectory(prefix="ff_load_") as d:
        src, dst = os.path.join(d, "jobs.json"), os.path.join(d, "out.json")
        with open(src, "w") as f:
            json.dump(jobs, f)
        subprocess.run([sys.executable, "-c", LOAD_CLIENT, src,
                        str(clients), dst], check=True, timeout=600)
        with open(dst) as f:
            return json.load(f)


def request_stages(traces) -> dict:
    """trace id -> {stage: ms} from the request trace's spans
    (request.admission / queue / batch / response) in obs.events."""
    from flexflow_tpu_torch.obs import events as obs_events
    out = {}
    for e in obs_events.events():
        t = (e.get("attrs") or {}).get("trace")
        if t in traces and e["name"].startswith("request."):
            out.setdefault(t, {})[e["name"][len("request."):]] = \
                e["dur"] * 1e3
    return out


def front_split(got, stages) -> dict:
    """Medians over requests of where each request's time went, each
    read within the same request: the device batch it rode (the batch
    span: stacking, session.infer ending in the copy of the result to
    the host, the fan-out), the wait before that batch began (response
    span minus batch span: queue and batching window) and what lies
    outside the scheduler (client latency minus response span: HTTP,
    JSON, the handler's hand-off). The front's overhead is client
    latency minus the batch span."""
    rows = []
    for r in got:
        st = stages.get(r["trace"], {})
        check("batch" in st and "response" in st,
              f"request {r['trace']}: no batch / response span ({st})")
        rows.append((r["ms"], st["batch"], st["response"] - st["batch"],
                     r["ms"] - st["response"]))
    a = np.asarray(rows, np.float64)
    return {"batch_ms": pct(a[:, 1], 50),
            "overhead_ms": pct(a[:, 0] - a[:, 1], 50),
            "overhead_p90_ms": pct(a[:, 0] - a[:, 1], 90),
            "wait_ms": pct(a[:, 2], 50),
            "outside_ms": pct(a[:, 3], 50)}


def serve_fronts(smi: str) -> dict:
    """BERT-base (uncut, flash) at s 128 and 512 in one ModelRepository
    behind serve_http and serve_async: single-row requests from 16 client
    threads of another process per front, each request's time split by
    its request trace, the outputs against plain attention, 12 flash
    launches per scheduled device batch. Each bucket (1, 4, 8) is an
    InferenceSession of a model compiled at that batch over one set of
    weights."""
    from flexflow_tpu_torch.serving import (InferenceSession,
                                            ModelRepository, serve_async,
                                            serve_http)
    from flexflow_tpu_torch.serving.session import ServingPlanSession
    repo = ModelRepository()
    models = {}
    for seq in (128, 512):
        # BERT's pooler reshapes to the compile-time batch (build_bert),
        # so each bucket is a model compiled at that batch, all over the
        # largest's weights, routed by rows as a serving plan's buckets
        ff, bcfg = build_model(seq, "attention:flash")
        per = {8: InferenceSession(ff, batch_buckets=(8,))}
        for b in SERVE_BUCKETS[:-1]:
            fb, _ = build_model(seq, "attention:flash", batch=b)
            fb.params, fb.state = ff.params, ff.state
            per[b] = InferenceSession(fb, batch_buckets=(b,))
        sess = ServingPlanSession(per)
        for rows in SERVE_BUCKETS:
            sess.infer(requests(bcfg, seq, rows, 99))
        repo.register(f"bert{seq}", sess)
        models[seq] = (ff, bcfg, sess)
    torch.cuda.synchronize()
    reqs = {seq: [requests(bcfg, seq, 1, 1000 + i)
                  for i in range(SERVE_REQUESTS)]
            for seq, (_, bcfg, _) in models.items()}
    bodies = {seq: [infer_body(r).decode() for r in rs]
              for seq, rs in reqs.items()}
    from flexflow_tpu_torch.obs import events as obs_events
    traced = obs_events.enabled()
    obs_events.enable()     # request traces: each request's own stages
    http = serve_http(repo, port=0, block=False, max_batch=8,
                      max_delay_ms=2)
    aio = serve_async(repo, port=0, block=False, max_batch=8,
                      max_delay_ms=2)
    fronts = {"serve_http": (http.server.server_address[1], http.schedulers),
              "serve_async": (aio.port, aio.schedulers)}
    res = {"fronts": {}}

    def jobs_for(front, port, seqs, n):
        return [{"url": f"http://127.0.0.1:{port}/v2/models/bert{s}/infer",
                 "body": bodies[s][i], "trace": f"{front}-{s}-{i}",
                 "seq": s, "i": i} for i in range(n) for s in seqs]

    try:
        for front, (port, scheds) in fronts.items():
            jobs = jobs_for(front, port, (128, 512), SERVE_REQUESTS)
            obs_events.clear()
            # the main path: every count starts at 0 here
            fwd = zero_counts()["flash_attention_fwd"]
            t0 = time.perf_counter()
            got = load_clients(jobs, SERVE_CLIENTS)
            wall = time.perf_counter() - t0
            launches = fwd.launches
            for j, r in zip(jobs, got):
                r.update(seq=j["seq"], i=j["i"], trace=j["trace"])
                check(r["code"] == 200, f"{front} bert{j['seq']} request "
                                        f"{j['i']}: HTTP {r['code']} "
                                        f"{r['doc']}")
            stages = request_stages({j["trace"] for j in jobs})
            stats = {name: s.stats() for name, s in scheds.items()}
            calls = sum(st["batches"] + st["individual_retries"]
                        for st in stats.values())
            print(f"[serve] {front}: {len(jobs)} single-row requests "
                  f"({SERVE_REQUESTS} to each of bert128, bert512) from "
                  f"{SERVE_CLIENTS} client threads of another process in "
                  f"{wall:.3f} s; flash_attention_fwd launches={launches} "
                  f"(want {LAYERS} x {calls} device batches, individual "
                  f"retries included)")
            check(launches == LAYERS * calls,
                  f"{front}: flash launches {launches} != {LAYERS} x {calls}")
            met = http_get(f"http://127.0.0.1:{port}/v2/metrics")["models"]
            per = {}
            for seq in (128, 512):
                name = f"bert{seq}"
                mine = [r for r in got if r["seq"] == seq]
                lat = [r["ms"] for r in mine]
                m = met[name]
                out = {r["i"]: r["doc"]["outputs"][0] for r in mine}
                per[name] = {
                    "client_p50_ms": pct(lat, 50),
                    "client_p90_ms": pct(lat, 90),
                    "client_p99_ms": pct(lat, 99),
                    "server_p50_ms": m["latency_p50_ms"],
                    "server_p90_ms": m["latency_p90_ms"],
                    "server_p99_ms": m["latency_p99_ms"],
                    "batches": m["batches"],
                    "mean_batch_rows": m["mean_batch_rows"],
                    "load": front_split(mine, stages),
                    "outs": {i: np.asarray(o["data"], np.float32)
                             .reshape(o["shape"]) for i, o in out.items()}}
                p = per[name]
                q = p["load"]
                print(f"[serve] {front} {name}: client median "
                      f"{p['client_p50_ms']:.3f} / p90 "
                      f"{p['client_p90_ms']:.3f} / p99 "
                      f"{p['client_p99_ms']:.3f} ms; server sketch p50 "
                      f"{p['server_p50_ms']} / p90 {p['server_p90_ms']} / "
                      f"p99 {p['server_p99_ms']} ms; {p['batches']} "
                      f"batches, mean {p['mean_batch_rows']:.3f} rows; per "
                      f"request (request trace, medians): its device batch "
                      f"{q['batch_ms']:.3f} ms, front overhead = client - "
                      f"batch {q['overhead_ms']:.3f} ms (p90 "
                      f"{q['overhead_p90_ms']:.3f}) = wait before the batch "
                      f"{q['wait_ms']:.3f} + outside the scheduler "
                      f"{q['outside_ms']:.3f} ms ({smi})")
            res["fronts"][front] = {"launches": launches, "calls": calls,
                                    "models": per}
        # one client, closed loop: what the front adds to one request
        # on an idle server
        for front, (port, _) in fronts.items():
            for seq in (128, 512):
                jobs = jobs_for(f"{front}-idle", port, (seq,), SERVE_IDLE)
                obs_events.clear()
                got = load_clients(jobs, 1)
                for j, r in zip(jobs, got):
                    r["trace"] = j["trace"]
                    check(r["code"] == 200,
                          f"{front} idle request: HTTP {r['code']}")
                q = front_split(got, request_stages(
                    {j["trace"] for j in jobs}))
                res["fronts"][front]["models"][f"bert{seq}"]["idle"] = q
                print(f"[serve] {front} bert{seq}, one client, idle "
                      f"server, {SERVE_IDLE} requests (request trace, "
                      f"medians): client "
                      f"{pct([r['ms'] for r in got], 50):.3f} ms, device "
                      f"batch {q['batch_ms']:.3f} ms, front overhead "
                      f"{q['overhead_ms']:.3f} ms = wait before the batch "
                      f"{q['wait_ms']:.3f} + outside the scheduler "
                      f"{q['outside_ms']:.3f} ms ({smi})")
    finally:
        http.stop()
        aio.stop()
        obs_events.clear()
        if not traced:
            obs_events.disable()
    # every response against the same weights through plain attention
    for seq, (ff, bcfg, sess) in models.items():
        ref, _ = build_model(seq, "attention:xla")
        ref.params = ff.params
        ref_sess = InferenceSession(ref, batch_buckets=(8,))
        rows = [reqs[seq][i] for i in range(SERVE_REQUESTS)]
        want = np.concatenate([ref_sess.infer(
            {k: np.concatenate([r[k] for r in rows[j:j + 8]])
             for k in rows[0]}) for j in range(0, len(rows), 8)])
        worst = 0.0
        for front, r in res["fronts"].items():
            outs = r["models"][f"bert{seq}"].pop("outs")
            for i in range(SERVE_REQUESTS):
                o = outs[i]
                check(o.shape == (1, bcfg.num_labels)
                      and np.isfinite(o).all(),
                      f"{front} bert{seq} request {i}: output {o.shape}")
                worst = max(worst, float(np.abs(o[0] - want[i]).max()))
        print(f"[serve] bert{seq}: every response of both fronts against "
              f"plain attention on the same weights: max|diff| = "
              f"{worst:.3e} (tol {SLICE_TOL:.0e})")
        check(worst <= SLICE_TOL, f"bert{seq} served outputs differ from "
                                  f"plain attention by {worst}")
        res[f"bert{seq}_max_abs_err"] = worst
        del ref, ref_sess
    res["repo"], res["models"] = repo, models
    return res


def serve_shedding(repo, models) -> dict:
    """Against a full queue (the session's lock held, so the batch in the
    worker's hand cannot reach the card): a 1 ms deadline, a malformed
    request and a request during the drain are answered without a flash
    launch."""
    import threading
    from flexflow_tpu_torch.serving import serve_http
    ff, bcfg, sess = models[128]
    held = sess.session_for(1)._lock    # the 1-row bucket's dispatch lock
    h = serve_http(repo, port=0, block=False, max_batch=8, max_delay_ms=2,
                   max_queue=2)
    url = f"http://127.0.0.1:{h.server.server_address[1]}" \
          f"/v2/models/bert128/infer"
    sched = h.schedulers["bert128"]
    fwd = zero_counts()["flash_attention_fwd"]
    ok = infer_body(requests(bcfg, 128, 1, 5))
    bad = infer_body({"input_ids": np.zeros((1, 7), np.int32),
                      "position_ids": np.zeros((1, 7), np.int32)})
    backlog, codes = [], {}
    drainer = None
    held.acquire()
    try:
        def post_ok():
            backlog.append(http_post(url, ok)[0])
        threads = []
        end = time.perf_counter() + 30
        while sched._q.qsize() < 2 and time.perf_counter() < end:
            t = threading.Thread(target=post_ok, daemon=True)
            t.start()
            threads.append(t)
            time.sleep(0.05)
        check(sched._q.qsize() == 2, "the bounded queue did not fill")
        n0 = fwd.launches
        c, doc, hd = http_post(url, ok, {"x-ff-timeout-ms": "1"})
        codes["deadline_1ms"] = (c, hd.get("Retry-After"))
        check(c in (503, 504) and fwd.launches == n0,
              f"1 ms deadline against a full queue: HTTP {c} {doc}, "
              f"launches {fwd.launches - n0}")
        c, doc, hd = http_post(url, bad)
        codes["malformed"] = (c, hd.get("Retry-After"))
        check(c == 400 and fwd.launches == n0,
              f"malformed request: HTTP {c} {doc}, launches "
              f"{fwd.launches - n0}")
        drainer = threading.Thread(target=h.drain, args=(120.0,),
                                   daemon=True)
        drainer.start()
        while not h.state.draining:
            time.sleep(0.005)
        c, doc, hd = http_post(url, ok)
        codes["draining"] = (c, hd.get("Retry-After"))
        check(c == 503 and hd.get("Retry-After") and fwd.launches == n0,
              f"request while draining: HTTP {c} {doc} {hd}, launches "
              f"{fwd.launches - n0}")
    finally:
        held.release()
        if drainer is not None:
            drainer.join(timeout=120)
        else:
            h.stop()
    for t in threads:
        t.join(timeout=60)
    check(backlog and all(c == 200 for c in backlog),
          f"the backlog's requests: {backlog}")
    print(f"[serve] shedding against a full queue (max_queue 2, "
          f"{len(backlog)} requests held behind the session lock): "
          f"1 ms deadline -> {codes['deadline_1ms']}, malformed -> "
          f"{codes['malformed']}, while draining -> {codes['draining']} "
          f"(HTTP code, Retry-After); flash launches during the three: 0; "
          f"the held backlog then answered 200")
    return codes


def gpt2_session(buckets=SERVE_BUCKETS, decode_segment: int = 32):
    from flexflow_tpu_torch.serving import InferenceSession
    ff, g = gpt2_model("attention:flash")
    return ff, g, InferenceSession(ff, batch_buckets=buckets,
                                   decode_segment=decode_segment)


def cb_run(sess, work, eos: int, admission: str) -> tuple:
    from flexflow_tpu_torch.serving.fleet import (ContinuousBatcher,
                                                  kv_slot_capacity)
    from flexflow_tpu_torch.search.serving_plan import kv_cache_bytes
    ff = sess.ff
    per_seq = sum(kv_cache_bytes(l, 1, GPT_SEQ) for l in ff.layers)
    cap = kv_slot_capacity(ff, CB_SLOTS * per_seq)
    check(cap == CB_SLOTS, f"kv_slot_capacity {cap} != {CB_SLOTS}")
    cb = ContinuousBatcher(sess, kv_cache_bytes_budget=CB_SLOTS * per_seq,
                           eos_token_id=eos, decode_segment=CB_SEG,
                           admission=admission)
    try:
        fwd = zero_counts()["flash_attention_fwd"]
        t0 = time.perf_counter()
        seqs = [cb.submit(ids, plen, mnew) for ids, plen, mnew in work]
        got = [s.wait(timeout_s=600.0) for s in seqs]
        wall = time.perf_counter() - t0
        launches = fwd.launches
        st = cb.stats()
    finally:
        cb.close()
    return got, st, wall, launches


def emitted(row, plen: int, mnew: int, eos: int) -> int:
    """Tokens a sequence really generated: up to and with its first eos."""
    gen = row[plen:plen + mnew]
    hit = np.flatnonzero(gen == eos)
    return int(hit[0]) + 1 if hit.size else mnew


def row_probe(ff, want, got, plens, ends, smi: str) -> dict:
    """Is a row's result on this card independent of the rows that share
    its batch, the premise of the batcher's per-sequence contract? For
    a row that parted from its oracle (else row 0), at its first
    differing position d: the logits of that position through the KV
    path (prefill to the start of d's decode segment, then the oracle's
    tokens fed to the decode steps up to d) with the row alone and as
    row 0 of an 8-row batch; the same for the full forward
    (scored_forward); and the port's bf16 GEMM (mm_f32) of one row alone
    against the same row inside 8, at GPT-2's LM-head and MLP shapes."""
    from flexflow_tpu_torch.ops.registry import mm_f32
    parted = np.flatnonzero((want != got).any(axis=1))
    k = int(parted[0]) if parted.size else 0
    diff = np.flatnonzero(want[k] != got[k])
    d = int(diff[0]) if diff.size else int(ends[k]) - 1
    s0 = int(plens[k]) + CB_SEG * ((d - int(plens[k])) // CB_SEG)
    others = [(k + j) % want.shape[0] for j in range(8)]

    def kv_logits(ids):
        with torch.inference_mode():
            batch = gpt_batch(ids)
            cache = prefill(ff, batch, s0)
            for cur in range(s0, d + 1):
                row, cache = decode_step(ff, batch, cache, cur)
            return row[0].float()

    def fwd_logits(ids):
        with torch.inference_mode():
            return ff.executor.scored_forward(
                ff.params, ff.state, gpt_batch(ids))[0, d - 1].float()

    def compare(one, eight, tokens=True):
        span = (one.max() - one.min()).item()
        out = {"bit_equal": bool(torch.equal(one, eight)),
               "max_abs": (one - eight).abs().max().item(),
               "range": span}
        if tokens and parted.size:
            t_o, t_b = int(want[k, d]), int(got[k, d])
            out["gap_alone"] = (one[t_o] - one[t_b]).item() / span
            out["gap_in_8"] = (eight[t_o] - eight[t_b]).item() / span
        return out

    res = {"row": k, "parted": bool(parted.size), "position": d,
           "segment_start": s0,
           "kv": compare(kv_logits(want[k:k + 1]), kv_logits(want[others])),
           "forward": compare(fwd_logits(want[k:k + 1]),
                              fwd_logits(want[others]))}
    dev = ff.device
    gen = torch.Generator(device=dev).manual_seed(14)
    for name, (kin, nout) in (("lm_head", (768, vocab_of(ff))),
                              ("mlp", (768, 3072))):
        h = torch.randn(8, kin, generator=gen, device=dev) \
            .to(torch.bfloat16)
        w = torch.randn(kin, nout, generator=gen, device=dev) \
            .to(torch.bfloat16)
        res[f"gemm_{name}"] = compare(mm_f32(h[:1], w)[0],
                                      mm_f32(h, w)[0], tokens=False)
    print(f"[serve] row-independence probe, row {k} "
          f"({'parted from its oracle' if parted.size else 'no row parted'}"
          f") at position {d} (decode segment from {s0}): the row alone "
          f"against row 0 of an 8-row batch: "
          + "; ".join(f"{n} " + ("bit-equal" if r["bit_equal"] else
                                  f"max|diff| {r['max_abs']:.3e} of range "
                                  f"{r['range']:.3e}")
                      + (f", the two tokens' gap {r['gap_alone']:.3e} "
                         f"alone / {r['gap_in_8']:.3e} in 8"
                         if "gap_alone" in r else "")
                      for n, r in res.items() if isinstance(r, dict))
          + f" ({smi})")
    return res


def serve_generate(smi: str) -> dict:
    """GPT-2 small behind POST /generate, then the continuous batcher
    under continuous and static admission against per-sequence
    session.generate."""
    from flexflow_tpu_torch.serving import ModelRepository, serve_http
    ff, g, sess = gpt2_session()
    vocab = g.vocab_size
    rng = np.random.default_rng(14)
    plens = rng.integers(*SERVE_PLENS, 8).astype(np.int32)
    ids = gpt_prompts(8, plens, vocab, 14, seq=GPT_SEQ)
    sess.generate(ids, plens, 4)      # warm-up, outside the count
    repo = ModelRepository()
    repo.register("gpt2", sess)
    h = serve_http(repo, port=0, block=False, max_batch=8)
    try:
        body = json.dumps({
            "inputs": [{"name": "input_ids", "shape": [8, GPT_SEQ],
                        "datatype": "INT32", "data": ids.ravel().tolist()}],
            "parameters": {"prompt_len": plens.tolist(),
                           "max_new_tokens": 32}}).encode()
        fwd = zero_counts()["flash_attention_fwd"]
        t0 = time.perf_counter()
        code, doc, _ = http_post(
            f"http://127.0.0.1:{h.server.server_address[1]}"
            f"/v2/models/gpt2/generate", body)
        gen_ms = (time.perf_counter() - t0) * 1e3
        gen_launches = fwd.launches
    finally:
        h.stop()
    check(code == 200, f"POST generate: HTTP {code} {doc}")
    out = np.asarray(doc["outputs"][0]["data"], np.int32).reshape(8, GPT_SEQ)
    check(gen_launches == LAYERS, f"POST generate: {gen_launches} flash "
                                  f"launches, want {LAYERS} (one prefill)")
    direct = sess.generate(ids, plens, 32)
    check_tokens(out, ids, plens, 32, vocab, "POST generate")
    check((out == direct).all(), "POST generate differs from "
                                 "session.generate on the same request")
    print(f"[serve] POST /v2/models/gpt2/generate: 8 ragged prompts of "
          f"{plens.min()}-{plens.max()} tokens, 32 new tokens each, "
          f"{gen_ms:.3f} ms, flash launches {gen_launches} (one prefill), "
          f"equal to session.generate ({smi})")
    # the batcher's work: ragged prompts, budgets 8 ... 64 in multiples of
    # the segment, so a sequence's segments are the oracle's
    plens = rng.integers(*SERVE_PLENS, CB_SEQS).astype(np.int32)
    budgets = rng.integers(1, CB_MAX_SEGMENTS + 1, CB_SEQS) * CB_SEG
    ids = gpt_prompts(CB_SEQS, plens, vocab, 15, seq=GPT_SEQ)
    # the eos: the token most often generated first by the first 8
    probe = sess.generate(ids[:8], plens[:8], 4)
    firsts = [int(probe[r, plens[r]]) for r in range(8)]
    eos = max(set(firsts), key=firsts.count)
    work = [(ids[k, :plens[k]], int(plens[k]), int(budgets[k]))
            for k in range(CB_SEQS)]
    oracle_sess = type(sess)(ff, batch_buckets=SERVE_BUCKETS,
                             decode_segment=CB_SEG)
    want = np.stack([oracle_sess.generate(
        ids[k:k + 1], int(plens[k]), int(budgets[k]), eos_token_id=eos)[0]
        for k in range(CB_SEQS)])
    res = {"post_generate_ms": gen_ms, "post_generate_launches":
           gen_launches, "eos": eos}
    for admission in ("continuous", "static"):
        got, st, wall, launches = cb_run(sess, work, eos, admission)
        got = np.stack(got)
        toks = sum(emitted(got[k], plens[k], budgets[k], eos)
                   for k in range(CB_SEQS))
        check(st["completed"] == CB_SEQS, f"{admission}: {st}")
        check(launches == LAYERS * st["iterations"],
              f"{admission}: flash launches {launches} != {LAYERS} x "
              f"{st['iterations']} iterations")
        for k in range(CB_SEQS):
            n = plens[k] + budgets[k]
            check((got[k, :plens[k]] == ids[k, :plens[k]]).all()
                  and (got[k, n:] == 0).all(),
                  f"{admission}: sequence {k} prompt / tail")
        mask = np.arange(GPT_SEQ)[None] < (plens + budgets)[:, None]
        a, b = np.where(mask, want, 0), np.where(mask, got, 0)
        equal, gap = 0, 0.0
        for j in range(0, CB_SEQS, 8):    # 8 rows of scores at a time
            e, w = parted_at_ties(ff, a[j:j + 8], b[j:j + 8])
            equal, gap = equal + e, max(gap, w)
        print(f"[serve] ContinuousBatcher admission={admission}: "
              f"{CB_SEQS} sequences (prompts {plens.min()}-{plens.max()}, "
              f"budgets {budgets.min()}-{budgets.max()} in segments of "
              f"{CB_SEG}, eos {eos}), {CB_SLOTS} KV slots: "
              f"{st['iterations']} iterations, {st['evicted_early']} early "
              f"evictions, flash launches {launches} (= {LAYERS} x "
              f"iterations), {toks} tokens in {wall:.3f} s = "
              f"{toks / wall:.1f} tokens/s; {equal}/{CB_SEQS} rows "
              f"bit-identical to session.generate(row[None]), the others "
              f"part at a score gap <= {gap:.3e} of the row's range (tol "
              f"{GEN_TOL:.0e}) ({smi})")
        check(gap <= GEN_TOL, f"{admission}: a row parted from "
                              f"session.generate beyond a near tie")
        if admission == "continuous":
            probe_rows = (a, b)
        res[admission] = {"iterations": st["iterations"],
                          "evicted_early": st["evicted_early"],
                          "launches": launches, "tokens": toks,
                          "wall_s": wall, "tokens_per_s": toks / wall,
                          "equal_rows": equal, "worst_gap": gap}
    res["row_probe"] = row_probe(ff, *probe_rows, plens, plens + budgets,
                                 smi)
    res["session"] = (ff, g, sess)
    return res


def serve_plan(ff, g, sess, smi: str) -> dict:
    """optimize_strategy(mode="serving") on the compiled GPT-2 at buckets
    (1, 4, 8), the plan verified and exported, then loaded by the
    repository's own loader (ModelRepository._load_with_builder with
    serving_strategy_file): one model per bucket compiled from its
    bucket's sub-strategy, with the floor guard against plain data
    parallelism. Every model takes the plain session's weights."""
    import tempfile
    from flexflow_tpu_torch.analysis import verify_serving_plan
    from flexflow_tpu_torch.models import build_gpt2
    from flexflow_tpu_torch.search.optimizer import optimize_strategy
    from flexflow_tpu_torch.serving import ModelRepository
    tmp = tempfile.mkdtemp(prefix="ff_serving_plan_")
    path = os.path.join(tmp, "gpt2_serving.json")
    cfg = ff.config
    cfg.serving_buckets = ",".join(str(b) for b in SERVE_BUCKETS)
    cfg.export_strategy_file = path
    built = []

    def weights(f2):
        built.append(f2)
        f2.params = ff.params

    try:
        t0 = time.perf_counter()
        optimize_strategy(ff, mode="serving")
        search_s = time.perf_counter() - t0
        cfg.export_strategy_file = ""    # the loads below export nothing
        plan = ff._serving_plan
        report = verify_serving_plan(plan, ff.layers, ff.dmesh,
                                     context="chip_smoke")
        check(not report.findings, f"verifier findings: "
              f"{[f.format() for f in report.findings]}")
        t0 = time.perf_counter()
        psess = ModelRepository()._load_with_builder(
            "gpt2", lambda f: build_gpt2(f, 8, GPT_SEQ, g), SERVE_BUCKETS,
            cfg, None, 1, post_compile=weights, serving_strategy_file=path)
        load_s = time.perf_counter() - t0
    finally:
        cfg.export_strategy_file = ""
        shutil.rmtree(tmp, ignore_errors=True)
    searched = built[:len(SERVE_BUCKETS)]
    for b, f2 in zip(SERVE_BUCKETS, searched):
        sv = getattr(f2.strategy, "serving", None) or {}
        check(list(sv.get("buckets", {})) == [str(b)],
              f"bucket {b}: the model did not import its sub-strategy of "
              f"the plan")
    check(sorted(psess.floor_guard) == list(SERVE_BUCKETS),
          f"floor guard records {psess.floor_guard}")
    for b in SERVE_BUCKETS:
        adopted = psess.floor_guard[b]["adopted"]
        want = searched[SERVE_BUCKETS.index(b)] if adopted == "searched" \
            else built[len(SERVE_BUCKETS)]
        check(psess.session_for(b).ff is want,
              f"bucket {b}: the session is not the {adopted} model")
    plan_launches = plain_launches = 0
    for rows in SERVE_BUCKETS:
        plens = np.full(rows, PLAN_PLEN, np.int32) \
            + np.arange(rows, dtype=np.int32)
        ids = gpt_prompts(rows, plens, vocab_of(ff), 20 + rows,
                          seq=GPT_SEQ)
        fwd = zero_counts()["flash_attention_fwd"]
        a = psess.generate(ids, plens, 16)
        plan_launches += fwd.launches
        fwd = zero_counts()["flash_attention_fwd"]
        b = sess.generate(ids, plens, 16)
        plain_launches += fwd.launches
        check((a == b).all(), f"plan session != plain session at {rows} "
                              f"rows")
    check(plan_launches == plain_launches > 0,
          f"flash launches: plan session {plan_launches}, plain "
          f"{plain_launches}")
    meas = psess.measured_profile()
    rows = {}
    for b, p in sorted(plan.buckets.items()):
        m = meas.get(str(b), {})
        rows[b] = {"predicted_prefill_s": p.cost.prefill,
                   "predicted_decode_step_s": p.cost.decode_step,
                   "measured_prefill_s": m.get("prefill_s"),
                   "measured_decode_step_s": m.get("decode_step_s"),
                   "kv_bytes": p.cost.kv_bytes,
                   "floor_guard": psess.floor_guard.get(b)}
        print(f"[serve] serving plan bucket {b}: predicted prefill "
              f"{p.cost.prefill * 1e3:.4f} ms / decode step "
              f"{p.cost.decode_step * 1e3:.4f} ms; measured prefill "
              f"{m.get('prefill_s', float('nan')) * 1e3:.4f} ms / decode "
              f"step {m.get('decode_step_s', float('nan')) * 1e3:.4f} ms "
              f"(_decode_measured, host clock, device-synced); KV "
              f"{p.cost.kv_bytes / 2**20:.1f} MiB; floor guard "
              f"{psess.floor_guard.get(b)} ({smi})")
    print(f"[serve] serving plan: search {search_s:.3f} s at buckets "
          f"{SERVE_BUCKETS} on one card, verifier findings "
          f"{len(report.findings)}; loaded through ModelRepository"
          f"._load_with_builder(serving_strategy_file=...), each bucket's "
          f"model compiled from its imported sub-strategy, load + floor "
          f"guard {load_s:.3f} s; plan-session outputs equal the plain "
          f"session's at 1, 4 and 8 rows, flash launches {plan_launches} "
          f"= the plain session's {plain_launches}")
    return {"search_s": search_s, "load_s": load_s, "findings":
            len(report.findings), "buckets": rows}


def serve_fleet_check(smi: str) -> dict:
    """Two replica processes (gpt2-tiny, on the card) behind serve_fleet,
    one killed mid-request by its fault plan; every request answered
    through failover, then Autoscaler.tick repairs the fleet."""
    import threading
    from flexflow_tpu_torch.serving.fleet import (Autoscaler,
                                                  AutoscalerConfig,
                                                  FleetRouter, serve_fleet)
    argv = [sys.executable, "-m", "flexflow_tpu_torch.serving.fleet.replica",
            "--port", "{port}", "--name", "{name}", *FLEET_ARGS]
    env = {"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    router = FleetRouter(spawn_argv=argv, spawn_env=env,
                         poll_interval_s=0.25)
    fh = serve_fleet(router)
    try:
        crash = router.spawn("replica-a",
                             extra_env={"FF_FAULT_PLAN": FLEET_CRASH})
        router.spawn("replica-b")

        def wait_ready(n: int, what: str) -> None:
            end = time.perf_counter() + 180
            while time.perf_counter() < end:
                with router._lock:
                    up = [r for r in router._replicas
                          if r.ready_at is not None and r.alive_locked()]
                if len(up) >= n:
                    return
                time.sleep(0.1)
            codes = {r.name: r.proc.poll() for r in router.replicas()
                     if r.proc is not None}
            raise RuntimeError(f"check failed: {what}: replicas not ready "
                               f"(exit codes {codes})")

        wait_ready(2, "startup")
        ttr = {r.name: r.ready_at - r.spawned_at for r in router.replicas()}
        rng = np.random.default_rng(16)
        answered = []
        lock = threading.Lock()

        def job(i):
            # even requests infer (through the replica's scheduler, so
            # its metrics and sketches count them), odd ones generate
            ids = np.zeros((1, 32), np.int32)
            ids[0, :5] = rng.integers(0, 64, 5)
            if i % 2:
                verb, body = "generate", json.dumps({
                    "inputs": [{"name": "input_ids", "shape": [1, 32],
                                "datatype": "INT32",
                                "data": ids.ravel().tolist()}],
                    "parameters": {"prompt_len": 5, "max_new_tokens": 8}}
                ).encode()
            else:
                verb, body = "infer", infer_body(
                    {"input_ids": ids,
                     "position_ids": np.arange(32, dtype=np.int32)[None]})
            code, doc, _ = http_post(
                f"{fh.url}/v2/models/gpt2-tiny/{verb}", body)
            with lock:
                answered.append(code)
            check(code == 200, f"fleet request {i}: HTTP {code} {doc}")
        t0 = time.perf_counter()
        client_run([lambda i=i: job(i) for i in range(FLEET_REQUESTS)], 4)
        wall = time.perf_counter() - t0
        crash.proc.wait(timeout=30)
        stats = router.fleet_health()["fleet"]
        check(crash.proc.returncode not in (None, 0),
              f"replica-a did not crash ({crash.proc.returncode})")
        check(stats["failovers"] >= 1, f"no failover: {stats}")
        metrics = router.fleet_metrics()["models"]
        scaler = Autoscaler(router, AutoscalerConfig(min_replicas=2,
                                                     max_replicas=2))
        action = scaler.tick()
        check(action == "repair", f"Autoscaler.tick -> {action}")
        wait_ready(2, "repair")
        new = [r for r in router.replicas() if r.name not in ttr]
        ttr.update({r.name: r.ready_at - r.spawned_at for r in new})
        again = scaler.tick()
        check(again == "hold", f"second tick -> {again}")
        print(f"[serve] fleet: 2 replica processes (gpt2-tiny on the "
              f"card) behind serve_fleet, {FLEET_REQUESTS} requests (infer "
              f"and generate alternating) in {wall:.3f} s, all 200; replica-a died under "
              f"{FLEET_CRASH} (exit {crash.proc.returncode}), failovers "
              f"{stats['failovers']}; Autoscaler.tick -> {action}, then "
              f"{again}: {len(router.replicas())} replicas")
        print(f"[serve] fleet time to ready (spawn -> first passing "
              f"/healthz, host clock): "
              + ", ".join(f"{k} {v:.3f} s" for k, v in ttr.items())
              + f" ({smi})")
        for model, m in metrics.items():
            print(f"[serve] fleet merged /v2/metrics {model}: "
                  f"{ {k: m[k] for k in ('replicas', 'requests', 'completed', 'failed', 'batches')} } "
                  f"latency_ms {m.get('latency_ms')}")
        return {"time_to_ready_s": ttr, "failovers": stats["failovers"],
                "wall_s": wall, "merged": {k: {f: v for f, v in m.items()
                                               if f != "sketches"}
                                           for k, m in metrics.items()}}
    finally:
        fh.stop(drain_children=True)


def phase_serve(smi: str) -> dict:
    """The serving stack on one card (module docstring, phase 16)."""
    res = serve_fronts(smi)
    repo, models = res.pop("repo"), res.pop("models")
    res["shedding"] = serve_shedding(repo, models)
    del repo, models
    free_cuda()
    gen = serve_generate(smi)
    ff, g, sess = gen.pop("session")
    res["generate"] = gen
    res["plan"] = serve_plan(ff, g, sess, smi)
    del ff, sess
    free_cuda()
    res["fleet"] = serve_fleet_check(smi)
    res["launches"] = {
        "fronts": sum(r["launches"] for r in res["fronts"].values()),
        "post_generate": gen["post_generate_launches"],
        "batcher": sum(gen[a]["launches"]
                       for a in ("continuous", "static"))}
    return res


def kernel_rows(errs, serve, kt, train, gen, llama, mixtral, moe,
                zoo, fe, resil, search, srv) -> list:
    """The kernels' JSON rows: times at b8 h12 s128 d64 bf16 without
    dropout, with s512, dropout 0.1, the causal shapes, head dims 128,
    256, 320 and 512, NMT's and the Transformer's attention, Adam over
    DLRM, and the LLaMA, Mixtral, MoE, zoo, frontends, resilience,
    search and serving-stack launches beside them."""
    zoo_launches = {tag: r["launches"] for tag, r in zoo.items()}
    fe_launches = {"fx_train": fe["fx"]["train_launches"],
                   "keras_train": fe["keras"]["launches"],
                   "onnx_train": fe["onnx"]["launches"]}

    def fe_row(name):
        return {k: v[name] for k, v in fe_launches.items()}

    def search_row(name):
        """The search phase's launches: the searched BERT-base 8x512
        fit (3 steps), the remat train steps (3), the recompile fit."""
        return {"search_train_launches":
                    search["searched"]["launches"][name],
                "remat_train_launches":
                    search["remat"]["blocks"]["launches"][name],
                "recompile_train_launches":
                    search["recompile"]["launches"][name]}

    def fwd_row(seq, rate):
        return dict(kt["fwd"][(seq, rate)])

    def bwd_row(key, seq, rate):
        return bwd_row_t(key, kt["bwd"][(seq, rate)])

    def bwd_row_t(key, t):
        return {"ms": t[key + "_ms"], "plain_ms": t[key + "_plain_ms"],
                "bound_ms": t[key + "_bound"][0],
                "bound_by": t[key + "_bound"][1],
                # one call computes dq, dk and dv together
                "library_ms": t["sdpa_bwd_ms"],
                "library_backend": t["sdpa_bwd_backend"]}

    rows = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "flexflow_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "flexflow_tpu/kernels/flash_attention.py:110",
        "launches": serve["launches"],
        "max_abs_err": errs["flash_attention_fwd"], **fwd_row(128, 0.0),
        "shape": "b8 h12 s128 d64 bf16",
        "train_launches": train["launches"]["flash_attention_fwd"],
        "at_s512": fwd_row(512, 0.0),
        "dropout_0.1": {"s128": fwd_row(128, 0.1),
                        "s512": fwd_row(512, 0.1)},
        # the generation path: GPT-2 small's causal prefill, 12 launches
        # per prefill and none per decode step
        "generate_launches": gen["launches"],
        "generate_prefills": gen["prefills"],
        "causal_prefill_s1024": dict(kt["fwd_causal"]),
        # LLaMA-7B and Mixtral (8 layers): one launch per layer per
        # prefill at b4 h32 s1024 d128 causal
        "llama_generate_launches": llama["launches"],
        "llama_prefills": llama["prefills"],
        "llama_train_launches":
            llama["train"]["launches"]["flash_attention_fwd"],
        "mixtral_generate_launches": mixtral["launches"],
        "mixtral_prefills": mixtral["prefills"],
        "mixtral_train_launches":
            mixtral["train"]["launches"]["flash_attention_fwd"],
        "llama_prefill_b4_h32_s1024_d128_causal":
            dict(kt["fwd_d128_causal"]),
        "b8_h12_s512_d128": dict(kt["fwd_d128"]),
        "b4_h8_s512_d256": dict(kt["fwd_d256"]),
        "b4_h8_s512_d320": dict(kt["fwd_d320"]),
        "b4_h8_s512_d512": dict(kt["fwd_d512"]),
        # NMT's attention (NMTConfig: hidden 512, one head) at a 128-token
        # sentence; bf16 at d 192 ... 512 runs the wide wgmma kernel
        "nmt_b64_h1_s128_d512": dict(kt["fwd_nmt"]),
        "wide_bf16_kernel": "flash_fwd_wgmma_wide_kernel (d 192-512)",
        # the Transformer's attention (zoo phase), d 8 padded to 64; the
        # zoo's train launches (6 a step for the Transformer, 1 for NMT)
        # and the Transformer's served forwards
        "transformer_b64_h8_s512_d8": dict(kt["fwd_transformer"]),
        "zoo_train_launches": {t: n["flash_attention_fwd"]
                               for t, n in zoo_launches.items()},
        "zoo_serve_launches": zoo["transformer"]["serve_launches"],
        # the frontends: the fx import's served forwards (12 a forward)
        # and each imported model's fit
        "frontends_serve_launches": fe["fx"]["serve_launches"],
        "frontends_train_launches": fe_row("flash_attention_fwd"),
        # the resilience phase's faulty supervised run, replays included
        "resilience_train_launches":
            resil["launches"]["flash_attention_fwd"],
        "resilience_executed_steps": resil["steps"],
        # the search phase: calibrating op_attention@flash, then the
        # searched model's and the remat and recompile runs' steps
        "search_calibration_launches": search["calibration"]["launches"],
        **search_row("flash_attention_fwd"),
        # the serve phase: BERT-base behind both HTTP fronts (12 a
        # scheduled batch), POST /generate (one prefill) and the
        # continuous batcher under both admissions (12 an iteration)
        "serve_front_launches": srv["launches"]["fronts"],
        "serve_front_batches": {f: r["calls"]
                                for f, r in srv["fronts"].items()},
        "serve_generate_launches": srv["launches"]["post_generate"],
        "serve_batcher_launches": srv["launches"]["batcher"],
        "serve_batcher_iterations": {
            a: srv["generate"][a]["iterations"]
            for a in ("continuous", "static")}}]
    for key, name, line in (("dq", "flash_attention_bwd_dq", 169),
                            ("dkv", "flash_attention_bwd_dkv", 210)):
        rows.append({
            "name": name, "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"flexflow_tpu/kernels/flash_attention.py:{line}",
            "launches": train["launches"][name],
            "max_abs_err": errs[name], **bwd_row(key, 128, 0.0),
            "shape": "b8 h12 s128 d64 bf16",
            "at_s512": bwd_row(key, 512, 0.0),
            "dropout_0.1": {"s128": bwd_row(key, 128, 0.1),
                            "s512": bwd_row(key, 512, 0.1)},
            "llama_train_launches": llama["train"]["launches"][name],
            "mixtral_train_launches": mixtral["train"]["launches"][name],
            "b8_h12_s1024_d64_causal": bwd_row_t(key,
                                                 kt["bwd_d64_causal"]),
            "llama_b2_h32_s1024_d128_causal": bwd_row_t(
                key, kt["bwd_d128_causal"]),
            "b4_h8_s512_d256": bwd_row_t(key, kt["bwd_d256"]),
            "b4_h8_s512_d320": bwd_row_t(key, kt["bwd_d320"]),
            "b4_h8_s512_d512": bwd_row_t(key, kt["bwd_d512"]),
            "nmt_b64_h1_s128_d512": bwd_row_t(key, kt["bwd_nmt"]),
            "transformer_b64_h8_s512_d8": bwd_row_t(
                key, kt["bwd_transformer"]),
            "zoo_train_launches": {t: n[name]
                                   for t, n in zoo_launches.items()},
            "frontends_train_launches": fe_row(name),
            "resilience_train_launches": resil["launches"][name],
            **search_row(name),
            "wide_bf16_kernel": f"flash_bwd_{key}_wgmma_wide_kernel (d "
                                "192-512)"})
    a = kt["adam"]
    rows.append({
        "name": "adam_update", "route": "cuda",
        "source": "flexflow_tpu_torch/csrc/adam_update.cu",
        "replaces": "flexflow_tpu/kernels/opt_update.py:27",
        "launches": train["launches"]["adam_update"],
        "max_abs_err": errs["adam_update"], "ms": a["ms"],
        "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
        "bound_by": "bytes", "library_ms": a["library_ms"],
        "shape": f"BERT-base, {a['numel']} f32 parameters in 200 leaves",
        "llama_train_launches": llama["train"]["launches"]["adam_update"],
        "mixtral_train_launches":
            mixtral["train"]["launches"]["adam_update"],
        "moe_train_launches": moe["launches"]["adam_update"],
        "zoo_train_launches": {t: n["adam_update"]
                               for t, n in zoo_launches.items()},
        "frontends_train_launches": fe_row("adam_update"),
        "resilience_train_launches": resil["launches"]["adam_update"],
        **search_row("adam_update"),
        "dlrm_256.03M_params": {
            k: kt["adam_dlrm"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "library_ms")}})
    return rows


PHASES = ("build", "kernel", "ktimes", "slice", "train", "times",
          "generate", "llama", "mixtral", "moe", "zoo", "frontends",
          "resilience", "search", "serve")


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (times needs slice)")
    ap.add_argument("--ab-base", metavar="DIR",
                    help="time the flash kernels of the checkout at DIR "
                    "and of this one in turns, and nothing else")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    t_start = time.perf_counter()
    dev, smi = phase_device()
    if args.ab_base:
        phase_ab(args.ab_base, smi)
        print("chip_smoke: ran the A/B only; no result")
        return 1
    res = {}

    def run(name, fn, *a):
        if name not in phases:
            return None
        free_cuda()
        t0 = time.perf_counter()
        res[name] = fn(*a)
        print(f"[wall] phase {name}: {time.perf_counter() - t0:.1f} s "
              f"({time.perf_counter() - t_start:.1f} s since start)")
        return res[name]

    run("build", phase_build)
    run("kernel", phase_kernel)
    run("ktimes", phase_ktimes, smi)
    run("slice", phase_slice, (128, 512))
    run("train", phase_train)
    if "slice" in phases:   # the served models live on only for times
        models = res["slice"].pop("models")
        run("times", phase_times, models)
        del models
    run("generate", phase_generate, smi)
    run("llama", phase_llama, smi)
    run("mixtral", phase_mixtral, smi)
    run("moe", phase_moe)
    run("zoo", phase_zoo, smi)
    run("frontends", phase_frontends, smi)
    run("resilience", phase_resilience, smi)
    run("search", phase_search, smi)
    run("serve", phase_serve, smi)
    if phases != set(PHASES):
        print(f"chip_smoke: ran phases {sorted(phases)} only; no result")
        return 1
    print(json.dumps({"kernels": kernel_rows(
        res["kernel"], res["slice"], res["ktimes"], res["train"],
        res["generate"], res["llama"], res["mixtral"], res["moe"],
        res["zoo"], res["frontends"], res["resilience"], res["search"],
        res["serve"])}))
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
