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
               forward, dq and dk/dv over one case list at the head
               dims the kernels take (bf16 d <= 32 unpadded, the narrow
               kernels; dq also bit-identical over two launches), the
               narrow cases through the autograd Function (one dq and
               one dk/dv launch, no pad or slice), the fused Adam over
               BERT-base's and DLRM's leaves plus ragged and bf16 ones;
  4. ktimes  - device times (CUDA graph replay between CUDA events) of
               each kernel, its plain version and its PyTorch yardstick,
               at b8 h12 d64 bf16, s 128 and 512, without dropout and at
               BERT's training rate of 0.1, causal at GPT-2's prefill
               shape (s 1024), at LLaMA-7B's prefill (b4 h32 s1024 d128
               causal) and training shape (the causal backward at d 128),
               the causal backward at d 64, head dims 256, 320 and 512,
               NMT's attention (b64 h1 s128 d512), the Transformer's
               (b64 h8 s512 d8, unpadded: the narrow kernels, and the
               autograd Function's whole backward), the f32 forward
               at the search's calibration rows (b1 h8 d64 causal, s 128
               and 512: the split-precision TF32 kernel, its bound beside
               the FMA rate's), at d 128 and at d 192 ... 512 (the wide
               TF32 kernel), the f32 tensor-core dq and dk/dv at b1 h8
               s512 d 64 and 128 causal, at BERT-base's b8 h12 s512 (d
               64 and 128) and at d 192 ... 512, SDPA's backend named
               (its efficient backend's backward where its flash backend
               refuses the shape), Adam over BERT-base and over DLRM's
               256.03 M parameters, and each kernel's bound (bytes,
               flops or exponentials at the card's maximum SM clock);
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
               through plain attention and the unfused Adam; then
               BERT-base 8 x 512 under --f32-compute (use_bf16_compute =
               False: the f32 tensor-core flash kernels at d 64), fit
               with dropout 0.1 and 12 / 12 / 12 / 1 launches a step, at
               dropout 0 the first step's gradients leaf by leaf and a
               4-step loss history against plain attention + the unfused
               Adam, and its step time and peak memory beside the bf16
               step's;
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
               p90, tokens/s) at 1 and 8 rows, the decode step also with
               each product at the batch's own shape (no row chunk), the
               peak memory of a generate call, and profiles the decode
               step;
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
               (its CRC share) of the 1.31 GB state, a bf16 leaf saved
               and restored bit for bit, the disabled step
               wrapper's host cost (<= 3% of a step) and the step with
               tracing on and off;
 15. search  - the strategy search on the card: the calibration (the bf16
               matmul chain and mxu_eff, host dispatch, HBM streaming
               read, op_attention@xla / @flash at s 128 and 512, then
               both at 1024, 2048, 4096, b1 h8 d64 f32 causal, SDPA at
               every length (timed only), and the crossover; the flash
               forward must launch while
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
 16. dist    - BERT-base (hidden 768, 12 heads; 4 of its 12 layers) at
               8 x 512, bf16, trained by two rank processes sharing the
               card
               (gloo; the functional all-gather by c10d's) under
               --only-data-parallel (dp 2) and --tp 2, each against the
               one-rank run of the same weights and data: the forward
               (2e-2), the first step's gradients at dropout 0.1 leaf by
               leaf (ZOO_GRAD_TOL; the masks hashed at global b*h), the
               4-step dropout-0 history (TRAIN_TOL), a flash forward, dq
               and dk/dv a layer and one fused Adam launch a step on each
               rank, each rank's step time, peak memory and reshard bytes,
               the collectives' backend and route; then a one-rank NCCL
               world compiles the same model and steps once;
 17. pipe    - the same cut BERT-base trained pp 2 (GPipe, interleaved) by
               two ranks, and DLRM with its tables one bank over two,
               against the one-rank runs;
 18. seq     - ring and Ulysses attention over two ranks, and GPT-2 small
               (4 of its 12 layers) at 8 x 1024 trained sp 2, against one
               rank; the long-context MHA at seq 2;
 19. genworld - full-width GPT-2 small (12 layers) generating over two
               rank processes sharing the card: tp 2 (greedy 8 x 512 +
               64, ragged prompts with eos, sampling twice, a 4-beam
               search) and dp 2 (greedy) through InferenceSession, then a
               serving plan searched on a described 2-device mesh through
               build_serving_plan_session (floor guard on) behind rank
               0's request relay (serving/world.py), requests from client
               threads and a BatchScheduler: 12 flash launches a prefill
               and none a decode step on each rank, no KV fallback, both
               ranks' ids and decode steps equal, the first decode step
               within 2e-2 of the one-rank run's rows (the generate
               phase's), its greedy tokens up to its first near tie, the
               sampled runs equal; prefill, decode step, tokens/s, the
               relay's host time and each rank's peak memory; the flash
               forward at each rank's block of the prefill;
 20. world   - BERT-base at 8 x 128 (dropout 0.1, Adam 1e-4, flash +
               fused Adam, bf16) trained dp 2 under --zero by two rank
               processes sharing the card (gloo), each the member program
               tools/torch_dist_resilience_smoke.py --worker under a
               per-process Supervisor (a two-phase multi-host checkpoint
               every 2 steps), run by the port's WorldSupervisor: (a) a
               clean world of 6 steps; (b) rank_crash@3:1 in world epoch
               0: rank 0 exits 17 naming rank 1 within FF_HB_TIMEOUT_S
               plus a step, the relaunched world resumes from a committed
               step and ends bit-equal to (a) on both ranks; (c) the same
               fault shrunk to one rank, restored bit-equal to the step it
               adopted; (d) crash_after_stage@2:1: tmp-2 debris, rank 0
               out within the barrier bound, a fresh world quorum-restores
               step 1; 12 / 12 / 12 / 1 launches in every executed step of
               every rank; saves, shard bytes, restores, the detection
               latency, the recovery wall and each epoch's split; then the
               flash kernels and the fused Adam at this path's shapes;
 21. serve   - the serving stack on the card: (a) BERT-base
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
               against session.generate(row[None]) (all 32 bit-identical
               under both admissions), tokens/s, early evictions, and a
               probe of row independence (a row's logits, prefill cache
               and every decode product the oracle's way against the
               batcher's, at the executor's row chunk and without it;
               the forward; two GEMMs, LayerNorm and the softmax alone
               and inside 8 rows); (d) optimize_strategy(
               mode="serving") at buckets (1, 4, 8), verify_serving_plan
               (no findings), the plan file loaded by the repository's
               loader (ModelRepository._load_with_builder with
               serving_strategy_file: each bucket's model imports its
               sub-strategy) with its floor guard, outputs and flash
               launches equal to the plain session's, predicted against
               measured prefill and decode step; (e) two replica processes (python -m
               flexflow_tpu_torch.serving.fleet.replica --model
               gpt2-tiny, on the card) behind serve_fleet, one killed by
               FF_FAULT_PLAN=infer_crash@0 (its first call): 32 requests
               all answered through failover, Autoscaler.tick repairs the
               fleet, each replica's time to ready and the merged fleet
               metrics;
 22. kernels - one JSON line with each kernel's launches, error and times.

``--phases`` runs a subset while a kernel is brought up: ``--phases
build,kernel`` builds and checks every kernel, ``--phases
build,kernel,ktimes`` also times them, ``--phases build,kernel,generate``
drives generation, ``--phases build,kernel,llama`` the LLaMA family,
``--phases build,kernel,mixtral,moe`` Mixtral and the MoE example,
``--phases build,kernel,zoo`` the rest of the model zoo, ``--phases
build,kernel,frontends`` the frontends, ``--phases
build,kernel,resilience`` checkpointing, faults and telemetry,
``--phases build,kernel,search`` the strategy search, ``--phases
build,kernel,dist`` the world of two ranks, ``--phases
build,kernel,generate,genworld`` generation over two ranks against one,
``--phases build,world``
the supervised world that loses a rank, ``--phases
build,kernel,serve`` the serving stack; with
no arguments every phase runs, each phase's wall time printed and each
phase's models freed before the next. ``--ab-base DIR`` does nothing but time the
flash kernels of the checkout at DIR and of this one in turns (base,
change, change, base), the way to compare a kernel change on one card (a
head dim the base takes only padded is timed there as its wrapper ran
it: the forward's pad to 64, kernel and slice; dq and dk/dv at d 64, and
each backward shape's whole autograd Function backward, pads included).

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
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12
# the special-function units: 16 ex2 per SM per clock on 132 SMs, at the
# card's maximum SM clock, which phase_device reads from nvidia-smi
SMS, EX2_PER_SM_CLOCK = 132, 16
SM_CLOCK_HZ = 1.98e9

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
# the weights of every later step. The zoo holds every model's history to
# it, f32 NMT too: there the two attentions part only in f32's last bits,
# which its loss amplifies (ZOO_GRAD_TOL): 1.409e-2 at the third step on
# an H100
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


def exp_ms(n_exp: float) -> float:
    """Least time of ``n_exp`` exponentials on the special-function units
    (one MUFU ex2 each) at the card's maximum SM clock."""
    return n_exp / (SMS * EX2_PER_SM_CLOCK * SM_CLOCK_HZ) * 1e3


def attention_bound_ms(bh: int, sq: int, sk: int, d: int,
                       itemsize: int, causal: bool = False,
                       tf32_passes: int = 0) -> tuple:
    """Least time for one attention forward, the largest of three: q, k,
    v read once, o and the f32 lse written once; 4*d flops per (query,
    key) pair the mask keeps (sq*sk, or s*(s+1)/2 causal) per head on the
    bf16 tensor cores, or in f32 at the FMA rate, or (``tf32_passes``,
    the f32 kernel's split-precision products) that many times over at
    the TF32 tensor-core rate; one exponential per such pair (exp_ms).
    Flops and exponentials are both "operations"."""
    nbytes = (2 * bh * sq * d + 2 * bh * sk * d) * itemsize + bh * sq * 4
    pairs = sq * (sq + 1) / 2 if causal else sq * sk
    flops = 4.0 * bh * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    if tf32_passes:
        flops, peak = flops * tf32_passes, TF32_FLOP_PER_S
    t_ops = max(flops / peak * 1e3, exp_ms(bh * pairs))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> tuple:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0]) * 1e6
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{dev['kind']} x{dev['count']}, max SM clock "
          f"{SM_CLOCK_HZ / 1e6:.0f} MHz")
    print(smi)
    return dev, smi


def ptxas_report(log: str) -> list:
    """(kernel instantiation, registers, spill-store bytes, stack-frame
    bytes) of each entry function in ptxas's -v output, the names
    demangled by c++filt where it is installed."""
    rows, name, spills, frame = [], None, None, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln and name:
            spills = int(ln.split("bytes spill stores")[0].split(",")[-1])
            frame = int(ln.split("bytes stack frame")[0].split()[-1])
        elif "Used" in ln and "registers" in ln and name:
            regs = int(ln.split("Used")[1].split("registers")[0])
            rows.append([name, regs, spills, frame])
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
    spilled = []
    for lib, (_, log) in build.build_log.items():
        for name, regs, spills, frame in ptxas_report(log):
            print(f"[build] {lib}: {name}: {regs} registers, {spills} bytes "
                  f"spill stores, {frame} bytes stack frame")
            if spills and "wgmma" in name:
                spilled.append(f"{name} ({spills} bytes)")
        for ln in log.splitlines():
            # ptxas reports wgmma serialization (every product waited for
            # at once) as a performance note, not a warning
            if "warning" in ln.lower() or "Performance Loss" in ln:
                print(f"[build] {lib}: {ln.strip()}")
    # every instantiation printed first, then a wgmma kernel's spill fails
    check(not spilled, f"wgmma kernels spill: {spilled}")


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
    # Ulysses' launches (seq phase): b4 h12 s1024 d64 over two ranks
    # gives a rank 6 heads over the whole sequence, causal and not, in
    # both types; the long-context MHA under forced flash (B4 S2048 H8)
    (4, 6, 1024, 1024, 64, torch.bfloat16, False, 0.0),
    (4, 6, 1024, 1024, 64, torch.bfloat16, True, 0.0),
    (4, 6, 1024, 1024, 64, torch.float32, False, 0.0),
    (4, 6, 1024, 1024, 64, torch.float32, True, 0.0),
    (4, 8, 2048, 2048, 64, torch.bfloat16, False, 0.0),
    # a rank's block of BERT-base 8x128 under dp 2 (world phase)
    (4, 12, 128, 128, 64, torch.bfloat16, False, 0.1),
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
    # hidden / heads split over 8 heads, d 8 unpadded (the narrow kernel)
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
    # the narrow bf16 forward (d 8, 16, 24 and 32 unpadded, boxes of 16
    # or 32 columns; 64-row CTAs over 64-key tiles): every d causal and
    # not, with and without dropout, at a ragged s; sq != sk both ways;
    # one short tile; a causal s ending mid-tile; the Transformer's b*h =
    # 512 causal with dropout; d 12 (padded to 16) and 40 (to 64). The
    # backward kernels take the same head dims (kernel_head_dim)
    (4, 4, 200, 200, 8, torch.bfloat16, False, 0.0),
    (4, 4, 200, 200, 8, torch.bfloat16, True, 0.1),
    (4, 4, 200, 200, 16, torch.bfloat16, False, 0.1),
    (4, 4, 200, 200, 16, torch.bfloat16, True, 0.0),
    (4, 4, 200, 200, 24, torch.bfloat16, False, 0.0),
    (4, 4, 200, 200, 24, torch.bfloat16, True, 0.1),
    (4, 4, 200, 200, 32, torch.bfloat16, False, 0.1),
    (4, 4, 200, 200, 32, torch.bfloat16, True, 0.0),
    (4, 4, 96, 300, 8, torch.bfloat16, False, 0.1),
    (4, 4, 300, 96, 32, torch.bfloat16, False, 0.0),
    (4, 4, 40, 40, 16, torch.bfloat16, True, 0.1),
    (4, 4, 257, 257, 24, torch.bfloat16, True, 0.0),
    (64, 8, 512, 512, 8, torch.bfloat16, True, 0.1),
    (4, 4, 200, 200, 12, torch.bfloat16, True, 0.0),
    (4, 4, 200, 200, 40, torch.bfloat16, False, 0.1),
    # the narrow dq and dk/dv (the same tiles, unpadded too): sq != sk
    # both ways at both DPs
    (4, 4, 300, 96, 16, torch.bfloat16, False, 0.1),
    (4, 4, 96, 300, 24, torch.bfloat16, False, 0.0),
    # the bf16 forward at d 128: sq != sk both ways, without dropout at a
    # ragged s, non-causal at s 512
    (2, 4, 96, 200, 128, torch.bfloat16, False, 0.0),
    (2, 4, 200, 96, 128, torch.bfloat16, False, 0.1),
    (2, 4, 200, 200, 128, torch.bfloat16, True, 0.0),
    (8, 12, 512, 512, 128, torch.bfloat16, False, 0.0),
    # b*h = 65,600, past the 65,535 that gridDim.y allows (at d 256, 2.1
    # GB per tensor)
    (1640, 40, 64, 64, 64, torch.bfloat16, False, 0.0),
    (1640, 40, 64, 64, 64, torch.bfloat16, True, 0.0),
    (1640, 40, 64, 64, 256, torch.bfloat16, False, 0.0),
    # f32 at d 128 (the tensor-core f32 forward, 64-row CTAs over 32-key
    # tiles; the f32 dq and dk/dv): causal and not, with and without
    # dropout, a ragged s, sq != sk both ways, s below 64
    (2, 4, 200, 200, 128, torch.float32, False, 0.0),
    (2, 4, 200, 200, 128, torch.float32, True, 0.1),
    (2, 4, 128, 128, 128, torch.float32, True, 0.0),
    (2, 4, 96, 200, 128, torch.float32, False, 0.1),
    (2, 4, 200, 96, 128, torch.float32, False, 0.0),
    (2, 4, 40, 40, 128, torch.float32, True, 0.1),
    (8, 12, 512, 512, 128, torch.float32, False, 0.0),
    # f32 at d 64 (64-key tiles): s below 64, sq != sk both ways, a
    # causal s of five tiles with dropout; keys within one tile (the
    # second warpgroup idles, at both d) causal and not, with and without
    # dropout
    (8, 12, 40, 40, 64, torch.float32, True, 0.1),
    (8, 12, 40, 40, 64, torch.float32, False, 0.1),
    (8, 12, 64, 64, 64, torch.float32, False, 0.0),
    (8, 12, 64, 64, 64, torch.float32, True, 0.0),
    (2, 4, 32, 32, 128, torch.float32, False, 0.0),
    (2, 4, 32, 32, 128, torch.float32, True, 0.1),
    (2, 4, 20, 20, 128, torch.float32, False, 0.1),
    (2, 4, 20, 20, 128, torch.float32, True, 0.0),
    (2, 4, 96, 200, 64, torch.float32, False, 0.0),
    (2, 4, 200, 96, 64, torch.float32, False, 0.1),
    (2, 4, 320, 320, 64, torch.float32, True, 0.1),
    # the search's calibration rows (b1 h8 d64 f32 causal at s 128 and
    # 512) and the longest length its phase times: the longest sums
    (1, 8, 128, 128, 64, torch.float32, True, 0.0),
    (1, 8, 512, 512, 64, torch.float32, True, 0.0),
    (1, 8, 4096, 4096, 64, torch.float32, True, 0.0),
    # the f32 wide forward (d 192 ... 512, the split-precision TF32 wide
    # kernel; the f32 dq and dk/dv on its lse): with the cases above,
    # every d causal and not, each with and without dropout, keys within
    # one 64-key tile and past it; sq != sk both ways at d 256 and 512; a
    # causal s ending mid-tile at d 320; NMT's attention in f32 (the
    # --f32-compute path), self and ragged cross-attention
    (2, 4, 40, 40, 192, torch.float32, True, 0.1),
    (2, 4, 200, 200, 192, torch.float32, False, 0.1),
    (2, 4, 100, 100, 192, torch.float32, True, 0.0),
    (2, 4, 40, 40, 256, torch.float32, False, 0.0),
    (2, 4, 100, 100, 256, torch.float32, True, 0.1),
    (2, 4, 96, 200, 256, torch.float32, False, 0.1),
    (2, 4, 200, 96, 256, torch.float32, False, 0.0),
    (2, 4, 260, 260, 320, torch.float32, True, 0.0),
    (2, 4, 200, 200, 320, torch.float32, False, 0.1),
    (2, 4, 20, 20, 320, torch.float32, False, 0.1),
    (2, 4, 40, 40, 384, torch.float32, True, 0.1),
    (2, 4, 200, 200, 384, torch.float32, False, 0.0),
    (2, 4, 40, 40, 448, torch.float32, True, 0.1),
    (2, 4, 200, 200, 448, torch.float32, False, 0.1),
    (2, 4, 100, 100, 448, torch.float32, True, 0.0),
    (2, 4, 96, 200, 512, torch.float32, False, 0.1),
    (2, 4, 200, 96, 512, torch.float32, False, 0.0),
    (2, 4, 20, 20, 512, torch.float32, True, 0.1),
    (64, 1, 128, 128, 512, torch.float32, False, 0.0),
    (16, 1, 100, 37, 512, torch.float32, False, 0.0),
    # the f32 wide dq and dk/dv (blocks of 64 owned rows, streamed tiles
    # of 64 rows): a causal s ending just past a key block with dropout
    # at the smallest and the largest d, a query count below one query
    # tile over many keys, and NMT's ragged cross-attention the other way
    # round
    (2, 4, 260, 260, 192, torch.float32, True, 0.1),
    (2, 4, 260, 260, 512, torch.float32, True, 0.1),
    (2, 4, 20, 200, 256, torch.float32, False, 0.0),
    (16, 1, 37, 100, 512, torch.float32, False, 0.1),
    # the f32 dq and dk/dv at d 64 and 128 (the split-precision TF32
    # kernels: blocks of 128 owned rows, 64 a warpgroup, over streamed
    # tiles of 64): a causal s just past one 64-row block and just past a
    # 128-row one, with dropout, at both d; a query count below one tile
    # over many keys and the other way round at d 128; b*h above 1024 at d
    # 64, causal and not; BERT-base's grid at d 128 with dropout, causal
    # and not
    (2, 4, 72, 72, 64, torch.float32, True, 0.1),
    (2, 4, 72, 72, 128, torch.float32, True, 0.1),
    (2, 4, 130, 130, 64, torch.float32, True, 0.1),
    (2, 4, 130, 130, 128, torch.float32, True, 0.0),
    (2, 4, 20, 200, 128, torch.float32, False, 0.1),
    (2, 4, 200, 20, 128, torch.float32, False, 0.0),
    (33, 32, 64, 64, 64, torch.float32, False, 0.0),
    (40, 32, 100, 100, 64, torch.float32, True, 0.1),
    (8, 12, 200, 200, 128, torch.float32, True, 0.1),
    (8, 12, 512, 512, 128, torch.float32, False, 0.1),
    # f32 above d 512 keeps the wide FMA forward, as bf16 does
    (2, 4, 200, 200, 576, torch.float32, True, 0.1),
    (2, 4, 200, 200, 576, torch.float32, False, 0.0),
    # the genworld phase's prefills: GPT-2 small's block on a tp 2 rank
    # (6 of 12 heads), on a dp 2 rank (4 of 8 rows), and a one-row tp 2
    # prefill (a serving plan's bucket 1)
    (8, 6, 1024, 1024, 64, torch.bfloat16, True, 0.0),
    (4, 12, 1024, 1024, 64, torch.bfloat16, True, 0.0),
    (1, 6, 1024, 1024, 64, torch.bfloat16, True, 0.0),
]


# the f32 backward (the --f32-compute path) through the autograd Function
# in the kernel phase: d 300 (flash_attention pads q, k, v to 320 before
# the Function and slices o, and autograd slices the gradients), d 512
# causal with dropout, NMT's self-attention, BERT-base's d 64 with
# dropout and d 128 causal
FN_F32_CASES = [
    (2, 4, 200, 200, 300, torch.float32, False, 0.0),
    (2, 4, 260, 260, 512, torch.float32, True, 0.1),
    (64, 1, 128, 128, 512, torch.float32, False, 0.0),
    (8, 12, 200, 200, 64, torch.float32, False, 0.1),
    (2, 4, 200, 200, 128, torch.float32, True, 0.0),
]


# the flash kernels with the dropout hash placed in a global batch
# (bh_map = (h_total, b0, h0): this block is rows b0.. and heads h0.. of a
# batch of h_total heads, as a rank of a sharded run holds it), dropout
# 0.1: bf16 at d 8 (the narrow kernels), 64, 128 and 256 (the wide ones),
# f32 at d 64 and 128, the dist phase's rank blocks of BERT-base at
# 8 x 512 (dp 2: rows 4.. of 8; tp 2: heads 6.. of 12) and the pipe
# phase's microbatches (pp 2, 4 microbatches of 2 rows: rows 6.. and 2..
# of 8, bf16 and f32). Each against its plain version with the same map,
# forward, dq and dk/dv; the forward must also differ from the unmapped
# launch (the map reaches the hash)
BH_MAP_CASES = [  # (b, h, s, d, dtype, causal, (h_total, b0, h0))
    (2, 4, 128, 8, torch.bfloat16, False, (8, 3, 4)),
    (2, 4, 200, 64, torch.bfloat16, True, (12, 5, 8)),
    (2, 4, 128, 128, torch.bfloat16, False, (8, 1, 2)),
    (2, 4, 128, 256, torch.bfloat16, False, (8, 3, 4)),
    (2, 4, 200, 64, torch.float32, False, (12, 5, 8)),
    (2, 4, 128, 128, torch.float32, True, (8, 1, 2)),
    (4, 12, 512, 64, torch.bfloat16, False, (12, 4, 0)),
    (4, 12, 128, 64, torch.bfloat16, False, (12, 4, 0)),
    (8, 6, 512, 64, torch.bfloat16, False, (12, 0, 6)),
    (2, 12, 512, 64, torch.bfloat16, False, (12, 6, 0)),
    (2, 12, 512, 64, torch.float32, False, (12, 2, 0)),
    # the genworld phase's tp 2 prefill block with rank 1's heads
    (8, 6, 1024, 64, torch.bfloat16, True, (12, 0, 6)),
]


def phase_kernel_map(gen) -> float:
    """BH_MAP_CASES: each kernel with a dropout hash placed in a global
    batch against its plain version with the same map. Returns the worst
    forward error."""
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
        flash_attention_bwd_dq_plain, flash_attention_plain)
    worst = 0.0
    for b, h, s, d, dt, causal, bh_map in BH_MAP_CASES:
        d_k = kernel_head_dim(d, dt)
        q, k, v, do = (torch.randn(b, h, s, d_k, device="cuda", dtype=dt,
                                   generator=gen) for _ in range(4))
        kw = dict(causal=causal, sm_scale=1.0 / d_k ** 0.5,
                  dropout_rate=0.1, dropout_seed=4321, bh_map=bh_map)
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        po, plse = flash_attention_plain(q, k, v, **kw)
        unmapped = flash_attention(q, k, v, **dict(kw, bh_map=None))
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        pdq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
        pdk, pdv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                 **kw)
        torch.cuda.synchronize()
        err_o = (o.float() - po.float()).abs().max().item()
        rel = max((g.float() - w.float()).abs().max().item()
                  / max(w.float().abs().max().item(), 1e-30)
                  for g, w in ((dq, pdq), (dk, pdk), (dv, pdv)))
        moved = (unmapped.float() - o.float()).abs().max().item()
        ok = err_o <= TOL[dt]["o"] and rel <= BWD_TOL[dt] and moved > 0.0
        print(f"[kernel] flash kernels with bh_map {bh_map} b{b} h{h} s{s} "
              f"d{d} {str(dt)[6:]} causal={causal} dropout=0.1: "
              f"max|do|={err_o:.3e} (tol {TOL[dt]['o']:.0e}), backward "
              f"max rel {rel:.1e} (tol {BWD_TOL[dt]:.0e}), |o - unmapped "
              f"o| {moved:.3e} (> 0) {'ok' if ok else 'FAIL'}")
        check(ok, f"flash kernels with bh_map {bh_map} at b{b} h{h} s{s} "
                  f"d{d} {dt}")
        worst = max(worst, err_o)
    return worst


def kernel_head_dim(d: int, dtype) -> int:
    """The head dim the flash kernels take for d, forward and backward
    alike: what flash_attention pads to on the card (bf16 up to 32 to a
    multiple of 8, the narrow kernels; else to a multiple of 64)."""
    from flexflow_tpu_torch.kernels.flash_attention import _fwd_head_dim
    return _fwd_head_dim(d, dtype)


def aten_calls(fn, *prefixes) -> tuple:
    """``fn()``'s result and how many ATen calls it made of each name in
    ``prefixes`` (an op name before its overload: "constant_pad_nd"),
    counted by a dispatch mode (autograd carries it to its backward
    threads)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    counts = dict.fromkeys(prefixes, 0)

    class Calls(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if name in counts:
                counts[name] += 1
            return func(*args, **(kwargs or {}))

    with Calls():
        out = fn()
    return out, counts


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
    worst = max(worst, phase_kernel_map(gen))
    errs = phase_kernel_bwd(gen)
    errs["flash_attention_fwd"] = worst
    errs["adam_update"] = phase_kernel_adam(gen)
    return errs


def phase_kernel_bwd(gen) -> dict:
    """dq and dk/dv kernels against flash_attention_bwd_plain's parts on
    the forward kernel's o and lse, over the forward's cases at the head
    dim the kernels take (bf16 at d <= 32 the narrow kernels, unpadded);
    dq must also give the same bits on a second launch. Then the narrow
    cases and FN_F32_CASES through the autograd Function."""
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
        flash_attention_bwd_dq_plain, flash_attention_bwd_plain)
    worst = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0}
    bad = []
    for b, h, sq, sk, d, dt, causal, rate in CASES:
        d_k = kernel_head_dim(d, dt)   # narrow bf16 d stays as it is
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
    # the narrow backward and the f32 wide one through the autograd
    # Function: one dq and one dk/dv launch on the forward's tensors, no
    # pad or slice where the head dim is the kernels' (the dispatch mode's
    # count of the wrappers' three empty_like shows that it saw the
    # backward)
    narrow = [c for c in CASES if c[4] <= 32 and c[5] == torch.bfloat16]
    for b, h, sq, sk, d, dt, causal, rate in narrow + FN_F32_CASES:
        q, k, v, do = (torch.randn(b, h, s, d, device="cuda", dtype=dt,
                                   generator=gen)
                       for s in (sq, sk, sk, sq))
        kw = dict(causal=causal, dropout_rate=rate,
                  dropout_seed=99 if rate else None)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o, lse = flash_attention(*leaves, return_lse=True, **kw)
        n0 = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
        got, calls = aten_calls(lambda: torch.autograd.grad(o, leaves, do),
                                "constant_pad_nd", "slice", "empty_like")
        launches = (flash_attention_bwd_dq.launches - n0[0],
                    flash_attention_bwd_dkv.launches - n0[1])
        want = flash_attention_bwd_plain(q, k, v, o.detach(), lse, do, **kw)
        rel = max((g.float() - w.float()).abs().max().item()
                  / max(w.float().abs().max().item(), 1e-30)
                  for g, w in zip(got, want))
        # (d 12 runs at 16 and f32 d 300 at 320: flash_attention pads q,
        # k, v before the Function and slices o, and autograd
        # differentiates both)
        unpadded = kernel_head_dim(d, dt) == d
        ok = rel <= BWD_TOL[dt] and all(g.shape == t.shape
                                        for g, t in zip(got, (q, k, v))) \
            and launches == (1, 1) and calls["empty_like"] >= 3 \
            and (not unpadded or calls["constant_pad_nd"] == 0
                 == calls["slice"])
        kind = "narrow" if dt == torch.bfloat16 else "f32 TF32"
        print(f"[kernel] flash_attention backward through the Function b{b} "
              f"h{h} sq{sq} sk{sk} d{d} {str(dt)[6:]} causal={causal} "
              f"dropout={rate} ({kind} dq and dk/dv at d "
              f"{kernel_head_dim(d, dt)}): max rel {rel:.1e} (tol "
              f"{BWD_TOL[dt]:.0e}), launches dq {launches[0]} dk/dv "
              f"{launches[1]}, ATen calls {calls} {'ok' if ok else 'FAIL'}")
        check(ok, f"{kind} backward at b{b} h{h} s{sq}/{sk} d{d}")
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
    return {"launches": launches, "steps": steps, "f32": bert_f32_train()}


F32_SEQ = 512   # BERT-base's longest sequence, trained under --f32-compute


def bert_f32_train() -> dict:
    """BERT-base 8 x F32_SEQ under --f32-compute (use_bf16_compute =
    False: f32 operands everywhere, the f32 tensor-core flash forward, dq
    and dk/dv at d 64): fit with dropout 0.1 and every launch counted (12
    forward, 12 dq, 12 dk/dv and 1 Adam a step); then, at dropout 0 from
    the same weights against plain attention + the unfused Adam, the
    first step's gradients leaf by leaf (grad_check, ZOO_GRAD_TOL) and a
    4-step loss history (TRAIN_TOL); the step time and peak memory beside
    the bf16 run's."""
    kw = dict(use_bf16_compute=False)
    ff, bcfg = train_model(F32_SEQ, "attention:flash,opt_update:fused", **kw)
    x, y = dataset(bcfg, F32_SEQ, 16, 13)
    steps = 16 // 8
    torch.cuda.synchronize()
    fns = zero_counts()  # the main path: every count starts at 0
    history = ff.fit(x, y, epochs=1, verbose=False)
    launches = {name: fn.launches for name, fn in fns.items()}
    want = {"flash_attention_fwd": LAYERS * steps,
            "flash_attention_bwd_dq": LAYERS * steps,
            "flash_attention_bwd_dkv": LAYERS * steps,
            "adam_update": steps}
    print(f"[train] f32 path (--f32-compute): fit of BERT-base 8x{F32_SEQ}, "
          f"dropout 0.1, {steps} steps; launches {launches} (want {want}); "
          f"loss {[round(r['loss'], 5) for r in history]}")
    check(launches == want, f"f32 train launches {launches} != {want}")
    check(all(np.isfinite(r["loss"]) for r in history),
          f"f32 loss {history}")
    del ff
    free_cuda()

    # dropout 0: the first step's gradients and 4 steps of one batch from
    # the same weights, flash + fused Adam against plain attention + the
    # unfused Adam
    x1, y1 = dataset(bcfg, F32_SEQ, 8, 17)
    runs, init = {}, None
    for impl in ("attention:flash,opt_update:fused", "attention:xla"):
        m, _ = train_model(F32_SEQ, impl, dropout=0.0, **kw)
        if init is None:
            init = host_tree(m.params)
        else:
            m.params = device_tree(init)
        batch = {t.name: torch.from_numpy(a).cuda()
                 for t, a in zip(m.graph_inputs, x1)}
        batch["label"] = torch.from_numpy(y1).cuda()
        grads = host_tree(m.executor._grads(m.params, m.state, batch, 0)[0])
        runs[impl] = (grads, [r["loss"] for r in m.fit(x1, y1, epochs=4,
                                                       verbose=False)])
        del m, batch
        free_cuda()
    (g_flash, a), (g_plain, b) = runs.values()
    grad_diff = grad_check("bert_f32", True, g_flash, g_plain, "train")
    err = float(np.abs(np.array(a) - np.array(b)).max())
    ok = err <= TRAIN_TOL and np.all(np.isfinite(a))
    print(f"[train] f32 dropout 0, 4 steps from the same weights: loss flash "
          f"+ fused Adam {[round(v, 7) for v in a]}, plain attention + "
          f"unfused Adam {[round(v, 7) for v in b]}: max|diff| = {err:.3e} "
          f"(tol {TRAIN_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    check(ok, "f32 dropout-0 loss histories of the two paths disagree")
    times = {"bf16": step_times(F32_SEQ), "f32": step_times(F32_SEQ, **kw)}
    for name, t in times.items():
        print(f"[train] bert-base 8x{F32_SEQ} train step in {name} (flash + "
              f"fused Adam, dropout 0.1): median {t['step_ms']:.3f} ms, p90 "
              f"{t['step_p90_ms']:.3f} ms over {STEPS} steps (host clock, "
              f"ends in a device sync); peak device memory "
              f"{t['peak_mem_gb']:.3f} GB")
    return {"launches": launches, "steps": steps, "grad_diff": grad_diff,
            "loss_diff": err, "times": times}


def step_times(seq: int, **cfg_kw) -> dict:
    """Host-clock train-step time (each step ends in a device sync) and
    the step's peak device memory, BERT-base 8 x seq, flash + fused (the
    FFConfig's fields ``cfg_kw`` set)."""
    ff, bcfg = train_model(seq, "attention:flash,opt_update:fused",
                           **cfg_kw)
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
                 causal: bool = False, itemsize: int = 2,
                 tf32_passes: int = 0) -> tuple:
    """Least time of one backward kernel: q, k, v, do read once, lse and
    delta (f32) read once, dq (or dk and dv) written once, against 6 (dq)
    or 8 (dk/dv) * d flops per (query, key) pair the mask keeps (s*s, or
    s*(s+1)/2 causal) per head on the bf16 tensor cores, or in f32 at the
    FMA rate (the wide kernels above d 512), or (``tf32_passes``, the f32
    tensor-core kernels' split-precision products) that many times over
    at the TF32 tensor-core rate; and one exponential per such pair (each
    kernel rebuilds p)."""
    nbytes = 4 * bh * s * d * itemsize + 2 * bh * s * 4 \
        + (2 if dkv else 1) * bh * s * d * itemsize
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = (8.0 if dkv else 6.0) * bh * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    if tf32_passes:
        flops, peak = flops * tf32_passes, TF32_FLOP_PER_S
    t_ops = max(flops / peak * 1e3, exp_ms(bh * pairs))
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
              h: int = 12, d: int = 64, dtype=torch.bfloat16) -> dict:
    """The forward kernel, its plain version and SDPA (with the same
    dropout rate and mask, on the backend it picks, which is named) at b h
    s d in dtype. f32 up to d = 512 runs three TF32 passes on the tensor
    cores: its bound is theirs, with the FMA rate's beside it
    (``fma_bound_ms``)."""
    import torch.nn.functional as F
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    q, k, v = (torch.randn(b, h, seq, d, device="cuda", dtype=dtype,
                           generator=gen) for _ in range(3))
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=5 if rate else None)
    size = dtype.itemsize
    tf32 = 3 if size == 4 and d <= 512 else 0
    bound_ms, bound_by = attention_bound_ms(b * h, seq, seq, d, size, causal,
                                            tf32)
    extra = {"fma_bound_ms": attention_bound_ms(
        b * h, seq, seq, d, size, causal)[0]} if tf32 else {}
    return {**extra,
            "ms": cuda_time_ms(lambda: flash_attention(q, k, v, **kw)),
            "plain_ms": cuda_time_ms(
                lambda: flash_attention_plain(q, k, v, **kw)),
            "library_ms": cuda_time_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, dropout_p=rate, is_causal=causal)),
            "library_backend": sdpa_backend(q, k, v, rate, causal),
            "bound_ms": bound_ms, "bound_by": bound_by}


def bwd_times(seq: int, rate: float, gen, causal: bool = False, b: int = 8,
              h: int = 12, d: int = 64, dtype=torch.bfloat16) -> dict:
    """dq and dk/dv kernels, their plain versions, the autograd
    Function's whole backward (``fn_ms``: delta, then both kernels) and
    the backward of torch's SDPA (dq, dk, dv in one call, at the same
    dropout rate and mask) at b h s d in dtype: its flash backend's
    backward op where that takes the shape, else its efficient backend's
    (named in ``sdpa_bwd_backend``). f32 up to d 512 runs three TF32
    passes on the tensor cores: its bounds are theirs, with the FMA
    rate's beside them (``dq_fma_bound_ms``, ``dkv_fma_bound_ms``)."""
    from types import SimpleNamespace
    from flexflow_tpu_torch.kernels.flash_attention import (
        _FlashAttention, flash_attention, flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
        flash_attention_bwd_dq_plain)
    import torch.nn.functional as F
    q, k, v, do = (torch.randn(b, h, seq, d, device="cuda", dtype=dtype,
                               generator=gen)
                   for _ in range(4))
    kw = dict(causal=causal, sm_scale=1.0 / d ** 0.5, dropout_rate=rate,
              dropout_seed=5 if rate else None)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    # the kernels take the head dim that flash_attention pads to on the
    # card (bf16 d <= 32 unpadded), as the Function hands it to them; the
    # plain versions the model's d
    d_k = kernel_head_dim(d, dtype)
    kargs = args if d_k == d else tuple(
        F.pad(t, (0, d_k - d)) for t in (q, k, v, do)) + (lse, delta)
    ctx = SimpleNamespace(saved_tensors=kargs[:3] + (
        F.pad(o, (0, d_k - d)) if d_k != d else o, lse), cfg=kw)
    res = {"dq_ms": cuda_time_ms(
        lambda: flash_attention_bwd_dq(*kargs, **kw)),
           "dkv_ms": cuda_time_ms(
               lambda: flash_attention_bwd_dkv(*kargs, **kw)),
           "fn_ms": cuda_time_ms(
               lambda: _FlashAttention.backward(ctx, kargs[3], None)),
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
    tf32 = 3 if dtype.itemsize == 4 and d <= 512 else 0
    for key, dkv in (("dq", False), ("dkv", True)):
        res[key + "_bound"] = bwd_bound_ms(b * h, seq, d, dkv, causal,
                                           dtype.itemsize, tf32)
        if tf32:
            res[key + "_fma_bound_ms"] = bwd_bound_ms(
                b * h, seq, d, dkv, causal, dtype.itemsize)[0]
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
    tail = (96, 128, 128, 64, 1, 0, 0.125, 0, 0, 1.0, 0,
            *fa._map_args(8, 12, None), stream)
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


# further kernel timings: (key, kernel, b, h, s, d, causal, dtype, what)
KT_SHAPES = [
    ("fwd_d128_causal", "fwd", 4, 32, 1024, 128, True, torch.bfloat16,
     "LLaMA-7B's prefill, 32 launches per prefill"),
    ("fwd_d128", "fwd", 8, 12, 512, 128, False, torch.bfloat16,
     "head dim 128"),
    ("bwd_d64_causal", "bwd", 8, 12, 1024, 64, True, torch.bfloat16,
     "causal backward"),
    ("bwd_d128_causal", "bwd", 2, 32, 1024, 128, True, torch.bfloat16,
     "LLaMA-7B's training shape, 2 launches per step"),
    ("fwd_d256", "fwd", 4, 8, 512, 256, False, torch.bfloat16,
     "the wide kernel"),
    ("bwd_d256", "bwd", 4, 8, 512, 256, False, torch.bfloat16,
     "the wide kernels"),
    ("fwd_d320", "fwd", 4, 8, 512, 320, False, torch.bfloat16,
     "the wide kernel"),
    ("bwd_d320", "bwd", 4, 8, 512, 320, False, torch.bfloat16,
     "the wide kernels"),
    ("fwd_d512", "fwd", 4, 8, 512, 512, False, torch.bfloat16,
     "the wide kernel"),
    ("bwd_d512", "bwd", 4, 8, 512, 512, False, torch.bfloat16,
     "the wide kernels"),
    ("fwd_nmt", "fwd", 64, 1, 128, 512, False, torch.bfloat16,
     "NMT's attention: NMTConfig's hidden 512 in one head, a 128-token "
     "sentence"),
    ("bwd_nmt", "bwd", 64, 1, 128, 512, False, torch.bfloat16,
     "NMT's attention"),
    ("fwd_transformer", "fwd", 64, 8, 512, 8, False, torch.bfloat16,
     "the Transformer's attention: TransformerConfig's kdim = hidden / "
     "heads = 64 split over 8 heads, d 8 unpadded: the narrow kernel"),
    ("bwd_transformer", "bwd", 64, 8, 512, 8, False, torch.bfloat16,
     "the Transformer's attention, d 8 unpadded: the narrow kernels"),
    # f32: the search's calibration rows (op_attention@flash, b1 h8 d64
    # causal at s 128 and 512), the tensor-core kernel at d 128, the f32
    # tensor-core dq and dk/dv at the calibration shape, at d 128 and at
    # BERT-base's b8 h12 s512 d64 (and the same at d 128), the wide
    # tensor-core forward, dq and dk/dv at d 192 ... 512 and NMT's shape
    # (the --f32-compute path)
    ("fwd_f32_calib_s128", "fwd", 1, 8, 128, 64, True, torch.float32,
     "the search's calibration row at s128, 5 launches per calibration"),
    ("fwd_f32_calib_s512", "fwd", 1, 8, 512, 64, True, torch.float32,
     "the search's calibration row at s512, 5 launches per calibration"),
    ("fwd_f32_d128", "fwd", 1, 8, 512, 128, True, torch.float32,
     "the f32 tensor-core kernel at d 128"),
    ("bwd_f32_calib", "bwd", 1, 8, 512, 64, True, torch.float32,
     "the f32 tensor-core dq and dk/dv at the calibration shape"),
    ("bwd_f32_d128", "bwd", 1, 8, 512, 128, True, torch.float32,
     "the f32 tensor-core dq and dk/dv at d 128"),
    ("bwd_f32_bert", "bwd", 8, 12, 512, 64, False, torch.float32,
     "BERT-base under --f32-compute, 12 launches each per train step"),
    ("bwd_f32_bert_d128", "bwd", 8, 12, 512, 128, False, torch.float32,
     "BERT-base's shape at d 128"),
    ("fwd_f32_d192", "fwd", 4, 8, 512, 192, False, torch.float32,
     "the f32 wide tensor-core kernel"),
    ("fwd_f32_d256", "fwd", 4, 8, 512, 256, False, torch.float32,
     "the f32 wide tensor-core kernel"),
    ("fwd_f32_d256_causal", "fwd", 4, 8, 512, 256, True, torch.float32,
     "the f32 wide tensor-core kernel, causal"),
    ("fwd_f32_d320", "fwd", 4, 8, 512, 320, False, torch.float32,
     "the f32 wide tensor-core kernel"),
    ("fwd_f32_d512", "fwd", 4, 8, 512, 512, False, torch.float32,
     "the f32 wide tensor-core kernel"),
    ("fwd_f32_nmt", "fwd", 64, 1, 128, 512, False, torch.float32,
     "NMT's attention under --f32-compute, 1 launch per NMT train step"),
    ("bwd_f32_d192", "bwd", 4, 8, 512, 192, False, torch.float32,
     "the f32 wide tensor-core dq and dk/dv"),
    ("bwd_f32_d256", "bwd", 4, 8, 512, 256, False, torch.float32,
     "the f32 wide tensor-core dq and dk/dv"),
    ("bwd_f32_d256_causal", "bwd", 4, 8, 512, 256, True, torch.float32,
     "the f32 wide tensor-core dq and dk/dv, causal"),
    ("bwd_f32_d320", "bwd", 4, 8, 512, 320, False, torch.float32,
     "the f32 wide tensor-core dq and dk/dv"),
    ("bwd_f32_d512", "bwd", 4, 8, 512, 512, False, torch.float32,
     "the f32 wide tensor-core dq and dk/dv"),
    ("bwd_f32_nmt", "bwd", 64, 1, 128, 512, False, torch.float32,
     "NMT's attention under --f32-compute, 1 launch each per NMT train "
     "step"),
]


def phase_ktimes(smi: str) -> dict:
    """Every kernel's device time beside its plain version, its PyTorch
    yardstick and its bound: the flash kernels at s 128 and 512, without
    dropout and at 0.1, causal at GPT-2's prefill, at KT_SHAPES (LLaMA's
    and Mixtral's head dim 128, the causal backward, head dims 256, 320
    and 512, NMT's b64 h1 s128 d512, the Transformer's d 8, the f32
    calibration rows, the f32 forward, dq and dk/dv at d 192, 256 (and
    causal), 320, 512 and NMT's shape, the f32 forward at d 128 and the
    f32 backward at the calibration shape and d 128), and Adam over
    BERT-base and DLRM."""
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
    for key, kind, b, hh, seq, d, causal, dt, what in KT_SHAPES:
        shape = (f"b{b} h{hh} s{seq} d{d} {str(dt)[6:]}"
                 f"{' causal' if causal else ''}")
        if kind == "fwd":
            f = res[key] = fwd_times(seq, 0.0, gen, causal, b, hh, d, dt)
            fma = (f", FMA-rate bound {f['fma_bound_ms'] * 1e3:.2f} us"
                   if "fma_bound_ms" in f else "")
            print(f"[ktimes] flash_attention_fwd {shape} ({what}): kernel "
                  f"{f['ms'] * 1e3:.2f} us, plain {f['plain_ms'] * 1e3:.2f} "
                  f"us, sdpa ({f['library_backend']}) "
                  f"{f['library_ms'] * 1e3:.2f} us, bound "
                  f"{f['bound_ms'] * 1e3:.2f} us ({f['bound_by']}){fma}; "
                  f"kernel/sdpa {f['ms'] / f['library_ms']:.2f}, "
                  f"kernel/bound {f['ms'] / f['bound_ms']:.2f}; {smi}")
            continue
        t = res[key] = bwd_times(seq, 0.0, gen, causal, b, hh, d, dt)
        lib = t["sdpa_bwd_ms"]
        for k_, name in (("dq", "flash_attention_bwd_dq"),
                         ("dkv", "flash_attention_bwd_dkv")):
            bound, by = t[k_ + "_bound"]
            fma = (f", FMA-rate bound {t[k_ + '_fma_bound_ms'] * 1e3:.2f} us"
                   if k_ + "_fma_bound_ms" in t else "")
            print(f"[ktimes] {name} {shape} ({what}): kernel "
                  f"{t[k_ + '_ms'] * 1e3:.2f} us, plain "
                  f"{t[k_ + '_plain_ms'] * 1e3:.2f} us, bound "
                  f"{bound * 1e3:.2f} us ({by}){fma}; kernel/bound "
                  f"{t[k_ + '_ms'] / bound:.2f}; {smi}")
        print(f"[ktimes] sdpa backward ({t['sdpa_bwd_backend']}; dq, dk, "
              f"dv in one call) {shape}: {lib * 1e3:.2f} us vs dq + dk/dv "
              f"{(t['dq_ms'] + t['dkv_ms']) * 1e3:.2f} us, the Function's "
              f"whole backward (delta, dq, dk/dv) {t['fn_ms'] * 1e3:.2f} us;"
              f" {smi}")
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


# the A/B's shapes: (kernel, b, h, s, d, causal, dtype), KT_SHAPES's
# among them (the f32 calibration rows and the f32 wide rows too)
AB_SHAPES = [(*s, torch.bfloat16) for s in
             [("fwd", 8, 12, 128, 64, False), ("fwd", 8, 12, 512, 64, False),
              ("fwd", 8, 12, GPT_SEQ, 64, True)]] + [
    s[1:8] for s in KT_SHAPES]


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
    base: how a kernel change is compared within one call. A head dim
    the base takes only padded to 64 is timed as its wrapper ran it
    (the forward: pad, kernel, slice; dq and dk/dv: the kernel on
    pre-padded tensors); any other shape the base refuses is skipped.
    Each backward shape also times the autograd Function's whole
    backward as each tree's wrapper runs it: delta, the pads of q, k, v
    and dO where the base pads, both kernels, the slices of the
    gradients (views). Prints a line per kernel and shape, then a JSON
    line."""
    import torch.nn.functional as F
    fa = importlib.import_module("flexflow_tpu_torch.kernels.flash_attention")
    t0 = time.perf_counter()
    trees = {"base": os.path.abspath(base),
             "change": os.path.dirname(os.path.abspath(__file__))}
    libs = ab_build(trees)
    print(f"[ab] built both trees in {time.perf_counter() - t0:.1f} s")
    # a tree whose C entries take the dropout key's bh map (h_local,
    # h_total, b0, h0 after the seed); an older base's do not
    keyed = {tag: "seed_u32" in open(os.path.join(
        root, "flexflow_tpu_torch", "csrc", "flash_attention_fwd.cu")).read()
        for tag, root in trees.items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []

    def entry(tag, src, sym):
        fn = getattr(libs[tag][src], sym)
        types = fa._ARGTYPES[(src, sym)]
        if not keyed[tag]:
            types = types[:-4] + types[-1:]
        fn.argtypes, fn.restype = types, ctypes.c_int
        return fn

    for kind, b, h, s, d, causal, dt in AB_SHAPES:
        shape = (f"b{b} h{h} s{s} d{d} {str(dt)[6:]}"
                 f"{' causal' if causal else ''}")
        q, k, v, do = (torch.randn(b, h, s, d, device="cuda", dtype=dt,
                                   generator=gen) for _ in range(4))
        o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        lse, delta = (torch.empty(b, h, s, device="cuda") for _ in range(2))
        dp = -(-d // 64) * 64

        def tail(dd, tag):
            return (b * h, s, s, dd, int(dt == torch.bfloat16), int(causal),
                    d ** -0.5, 0, 0, 1.0, 0) + (fa._map_args(b, h, None)
                                                 if keyed[tag] else ())

        def call(tag, src, sym, ts, dd):
            # pointers and the stream read at each call, so a graph
            # capture records this call's tensors and stream
            return entry(tag, src, sym)(
                *[t.data_ptr() for t in ts], *tail(dd, tag),
                torch.cuda.current_stream().cuda_stream)

        def launch(tag, src, sym, ts, dd=d):
            return lambda: call(tag, src, sym, ts, dd)

        def padded_fwd(q, k, v, lse):
            def run():
                qp, kp, vp = (F.pad(t, (0, dp - d)) for t in (q, k, v))
                op = torch.empty_like(qp)
                err = call("base", "flash_attention_fwd",
                           "ff_flash_attention_fwd", (qp, kp, vp, op, lse),
                           dp)
                check(err == 0, f"padded base launch at {shape}")
                op[..., :d]
            return run

        fwd = ("flash_attention_fwd", "ff_flash_attention_fwd",
               (q, k, v, o, lse))
        check(launch("change", *fwd)() == 0, f"forward launch at {shape}")
        delta.copy_((do.float() * o.float()).sum(-1))
        # the base's kernels at the padded head dim, where it refuses d
        qp, kp, vp, dop = (F.pad(t, (0, dp - d)) for t in (q, k, v, do))
        dqp, dkp, dvp = (torch.empty_like(qp) for _ in range(3))
        bwd = [("flash_attention_bwd", "ff_flash_attention_bwd_dq",
                (q, k, v, do, lse, delta, dq),
                (qp, kp, vp, dop, lse, delta, dqp)),
               ("flash_attention_bwd", "ff_flash_attention_bwd_dkv",
                (q, k, v, do, lse, delta, dk, dv),
                (qp, kp, vp, dop, lse, delta, dkp, dvp))]
        base_pads = False
        for src, sym, ts, pts in [fwd + (None,)] if kind == "fwd" else bwd:
            fns = {tag: launch(tag, src, sym, ts) for tag in libs}
            label = shape
            if d % 64 and fns["base"]() != 0:
                # an older tree takes d only padded to 64: time what its
                # wrapper ran (the forward's pad and slice included; the
                # backward's pads are in the Function row below)
                if kind == "fwd":
                    fns["base"] = padded_fwd(q, k, v, lse)
                    label += " (base: pad to 64, kernel, slice)"
                else:
                    fns["base"] = launch("base", src, sym, pts, dp)
                    check(fns["base"]() == 0, f"padded base {sym} {shape}")
                    label += f" (base: the kernel at d {dp})"
                    base_pads = True
            elif fns["base"]() != 0:
                print(f"[ab] {sym} {shape}: the base tree refuses it")
                continue
            us = [cuda_time_ms(fns[t]) * 1e3
                  for t in ("base", "change", "change", "base")]
            row = {"kernel": sym, "shape": label, "base_us": us[::3],
                   "change_us": us[1:3]}
            if kind == "fwd":
                row["sdpa_us"] = cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal)) * 1e3
            rows.append(row)
            print(f"[ab] {sym} {label}: base {np.mean(us[::3]):.2f} us "
                  f"({us[0]:.2f}, {us[3]:.2f}), change "
                  f"{np.mean(us[1:3]):.2f} us ({us[1]:.2f}, {us[2]:.2f})"
                  + (f", sdpa {row['sdpa_us']:.2f} us" if "sdpa_us" in row
                     else "") + f"; {smi}")
        if kind != "bwd" or len(rows) < 2 or rows[-1]["kernel"] != \
                "ff_flash_attention_bwd_dkv":
            continue

        def function_bwd(tag, pads):
            def run():
                dl = (do.float() * o.float()).sum(-1)
                ts, dd = (q, k, v, do), d
                if pads:
                    ts, dd = tuple(F.pad(t, (0, dp - d)) for t in ts), dp
                g = [torch.empty_like(ts[0]) for _ in range(3)]
                e1 = call(tag, "flash_attention_bwd",
                          "ff_flash_attention_bwd_dq",
                          ts + (lse, dl, g[0]), dd)
                e2 = call(tag, "flash_attention_bwd",
                          "ff_flash_attention_bwd_dkv",
                          ts + (lse, dl, g[1], g[2]), dd)
                check(e1 == 0 and e2 == 0, f"{tag} backward at {shape}")
                return [t[..., :d] for t in g]
            return run
        fns = {"base": function_bwd("base", base_pads),
               "change": function_bwd("change", False)}
        us = [cuda_time_ms(fns[t]) * 1e3
              for t in ("base", "change", "change", "base")]
        label = shape + (" (base: delta, 4 pads to 64, dq, dk/dv, 3 slice "
                         "views; change: delta, dq, dk/dv)" if base_pads
                         else " (delta, dq, dk/dv)")
        rows.append({"kernel": "_FlashAttention.backward", "shape": label,
                     "base_us": us[::3], "change_us": us[1:3]})
        print(f"[ab] _FlashAttention.backward {label}: base "
              f"{np.mean(us[::3]):.2f} us ({us[0]:.2f}, {us[3]:.2f}), change "
              f"{np.mean(us[1:3]):.2f} us ({us[1]:.2f}, {us[2]:.2f}); {smi}")
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
        res = {"tokens": ids[:, plen:plen + steps].cpu().numpy(),
               "first_rows": kv_rows[:, 0].cpu()}
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


@contextlib.contextmanager
def decode_ctx(ex, row_chunk=None, log=None):
    """Every decode context ``ex._kv_ctx`` builds inside takes
    ``row_chunk`` (None: the step's own) and ``log()``'s list as its
    product log. Row chunk 0 runs each product and norm at the batch's
    own rows, how the decode step ran before the chunk."""
    make_ctx = ex._kv_ctx

    def wrapped(mode, state):
        ctx = make_ctx(mode, state)
        if mode == "decode":
            if row_chunk is not None:
                ctx.row_chunk = row_chunk
            if log is not None:
                ctx.product_log = log()
        return ctx

    ex._kv_ctx = wrapped
    try:
        yield
    finally:
        del ex._kv_ctx


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
    res = {"launches": launches, "prefills": prefills, "rows": rows,
           "world_ref": one_rank_ref(ff, outs["greedy8"],
                                     rows.pop("first_rows"), 512,
                                     GEN_TOKENS)}
    res.update(generate_times(ff, sess, p8, smi))
    return res


def one_rank_ref(ff, ids: np.ndarray, first_rows, plen: int, n: int,
                 device: str = "cuda") -> dict:
    """What the genworld phase holds the world's runs against, from a
    one-rank greedy run: its ids, its first decode step's score rows,
    and the top-2 margin of each row's every greedy step as a share of
    the row's logit range (the re-forward rows over the final ids)."""
    with torch.inference_mode():
        scores = ff.executor.scored_forward(
            ff.params, ff.state, genworld_batch(ids, device))[
                :, plen - 1:plen - 1 + n].float()
        top2 = scores.topk(2, dim=-1).values
        span = scores.amax(dim=-1) - scores.amin(dim=-1)
        margins = ((top2[..., 0] - top2[..., 1]) / span).cpu().numpy()
        del scores
    return {"ids": ids, "first_rows": first_rows, "margins": margins}


def generate_times(ff, sess, prompts, smi: str, name: str = "gpt2-small",
                   plen: int = 512, tokens: int = GEN_TOKENS,
                   rows=(1, 8), profile: bool = True) -> dict:
    """Prefill and decode-step latencies, tokens/s, the peak memory of a
    generate call and (``profile``) a profile of the decode step, for the
    LM ``ff`` on ``prompts`` (all rows, ``plen`` tokens each)."""
    from flexflow_tpu_torch import OperatorType
    from flexflow_tpu_torch.executor import DECODE_ROW_CHUNK
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
        # the step with every product and norm on blocks of the row chunk
        # and with each at the batch's own shape (as the decode step ran
        # before the chunk), in turns: chunk, none, none, chunk
        lat, lat0 = [], []
        for chunked in (True, False, False, True):
            with decode_ctx(ff.executor, None if chunked else 0):
                (lat if chunked else lat0).extend(
                    decode_step_times(ff, b, plen, tokens // 2)[0])
        ff._decode_measured = {}
        ff.generate(prompts[:b], plen, tokens, kv_cache=True)
        no_fallback(ff, f"timed generate at {b} rows")
        m = ff._decode_measured[b]
        res[b] = {"step_ms": float(np.median(lat)),
                  "step_p90_ms": float(np.percentile(lat, 90)),
                  "step_ms_unchunked": float(np.median(lat0)),
                  "gen_step_ms": m["decode_step_s"] * 1e3,
                  "gen_prefill_ms": m["prefill_s"] * 1e3,
                  "tokens_per_s": b / m["decode_step_s"]}
        print(f"[times] {name} decode step at {b} rows (cache of {seq}): "
              f"median {res[b]['step_ms']:.3f} ms, p90 "
              f"{res[b]['step_p90_ms']:.3f} ms over {tokens} steps (host "
              f"clock, each ends in a device sync; products and norms on "
              f"blocks of {DECODE_ROW_CHUNK} rows; each at the "
              f"batch's own shape, the step before the chunk, timed in "
              f"turns with it: median {res[b]['step_ms_unchunked']:.3f} "
              f"ms); one FFModel.generate "
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
# the first step's gradients of the two plans from the same weights, leaf
# by leaf: ||g_flash - g_plain|| over max(||g_plain||, GRAD_FLOOR of the
# whole gradient's norm; the floor holds a leaf whose true gradient is 0,
# MHA's key bias, to the sums' rounding). Checked in f32 (NMT under
# --f32-compute), where on an H100 both attentions are within 7.7e-7 of
# float64 on the step's own tensors and the leaves part by <= 1.3e-4.
# NMT's graph ends in a dense layer, so its sparse CE takes log(clamp(out,
# 1e-10, 1)), and the target outputs just inside the clamp, cancellation
# residues of the last projection, carry gradients of -1 / (N out): noise
# of 1e-7 of max|o| moves every leaf by ~6e-4
# (tools/torch_nmt_f32_sensitivity.py). Printed, not checked, in bf16,
# whose rounding of the operands moves the Transformer's bias gradients
# by up to 15%; the loss history is the check there.
ZOO_GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-6
# the steps profiled: NMT's LSTM recurrence (launch-bound) and ResNet-50's
ZOO_PROFILED = ("nmt", "resnet50")


class ZooSpec:
    """One model of the zoo phase: ``build(ff, batch)`` returns its
    output tensor, ``data(rows, seed)`` seeded inputs (in graph-input
    order) and labels; ``flash`` is its attention layers (flash launches
    per step of each kernel), ``served`` whether it also answers requests
    through InferenceSession.infer."""

    def __init__(self, tag, what, batch, build, data, loss, flash=0,
                 served=False, f32=False):
        self.tag, self.what, self.batch = tag, what, batch
        self.build, self.data, self.loss = build, data, loss
        self.flash, self.served = flash, served
        # f32: use_bf16_compute = False (--f32-compute)
        self.f32 = f32


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
                f"heads, split over the heads: the narrow kernel), "
                f"{tc.num_layers} layers, seq {tc.sequence_length}, MSE)",
                64, lambda ff, b: zoo.build_transformer(ff, b, tc),
                transformer_data, "mean_squared_error", tc.num_layers, True),
        *(ZooSpec(tag, f"NMT (NMTConfig(): vocab {nc.src_vocab} / "
                  f"{nc.tgt_vocab}, embed {nc.embed_dim}, LSTM hidden "
                  f"{nc.hidden_size} x {nc.num_layers} layers each side, "
                  f"{nc.num_heads} attention head of {nc.hidden_size}; src "
                  f"= tgt = {ZOO_SEQ}, sparse CE{what})", 64,
                  lambda ff, b: zoo.build_nmt(ff, b, ZOO_SEQ, ZOO_SEQ, nc),
                  nmt_data, sce, 1, f32=f32)
          for tag, what, f32 in (
              ("nmt", "", False),
              # --f32-compute: the f32 wide forward, dq and dk/dv
              ("nmt_f32", "; f32 compute, use_bf16_compute = False",
               True))),
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
    operands (f32 ones for an f32 spec), seeded random weights, Adam
    (alpha 1e-4, epsilon 1e-4: the conv biases under BatchNorm and MHA's
    key bias have a true gradient of 0, whose f32 noise Adam at 1e-8
    turns into +-alpha steps)."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    cfg = FFConfig()
    cfg.batch_size = spec.batch
    cfg.only_data_parallel = True
    cfg.kernel_impls = impl
    cfg.use_bf16_compute = not spec.f32
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
    device time (on the CPU, a rehearsal: no kernel is seen)."""
    from collections import defaultdict
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + [ProfilerActivity.CUDA] * cuda) as prof:
        t0 = time.perf_counter()
        ff._run_train_step(step_fn, batch)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(float)
    kernels = collectives = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            collectives += "nccl" in e.name.lower()
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    family = defaultdict(float)
    for name, ms in by_name.items():
        low = name.lower()
        family["collective" if "nccl" in low
               else "conv / GEMM" if any(w in low for w in (
            "conv", "gemm", "xmma", "cudnn", "cutlass", "implicit"))
            else "flash" if "flash" in low
            else "elementwise / reduce" if any(w in low for w in (
                "elementwise", "reduce")) else "other"] += ms
    return {"launches": kernels, "device_ms": dev_ms, "wall_ms": wall,
            "busy": dev_ms / wall, "top": [(n[:60], ms) for n, ms in top],
            "family_ms": dict(family), "collective_launches": collectives}


def grad_check(tag: str, f32: bool, flash: dict, plain: dict,
               phase: str = "zoo") -> float:
    """The first step's gradients of the flash plan (``flash``, on the
    host) against the plain plan's, leaf by leaf, within ZOO_GRAD_TOL for
    an f32 model; prints the worst three leaves."""
    plain = host_tree(plain)
    whole = sum(float(t.double().norm()) ** 2
                for d in plain.values() for t in d.values()) ** 0.5
    errs = sorted(((float((flash[ln][n].double() - t.double()).norm())
                    / max(float(t.double().norm()), GRAD_FLOOR * whole),
                    f"{ln}.{n}") for ln, d in plain.items()
                   for n, t in d.items()), reverse=True)
    ok = errs[0][0] <= ZOO_GRAD_TOL or not f32
    print(f"[{phase}] {tag} first step's gradients, flash against plain "
          f"attention from the same weights, {len(errs)} "
          f"leaves: ||diff|| / max(||g||, {GRAD_FLOOR:.0e} ||whole g||) "
          "worst " + ", ".join(f"{n} {e:.3e}" for e, n in errs[:3])
          + (f" (tol {ZOO_GRAD_TOL:.0e}) {'ok' if ok else 'FAIL'}"
             if f32 else " (bf16: not checked)"))
    check(ok, f"{tag}: first-step gradients of the two plans differ")
    return errs[0][0]


def zoo_run(spec, smi: str) -> dict:
    """One model of the zoo: fit for ZOO_STEPS steps (one batch, so the
    history is the per-step loss) through flash and the fused Adam with
    every launch counted, the timed steps and their peak memory, the
    served requests; then the same weights, state and batch through plain
    attention and the unfused Adam. Before the fit, the first step's
    gradients of both plans from the same weights, leaf by leaf
    (``grad_check``)."""
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
    batch = {t.name: torch.from_numpy(a).cuda()
             for t, a in zip(ff.graph_inputs, xs)}
    batch["label"] = torch.from_numpy(y).cuda()
    grads = host_tree(ff.executor._grads(ff.params, ff.state, batch, 0)[0])
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
    del ff, step_fn
    free_cuda()

    # the same weights, state and batch through plain attention and the
    # unfused Adam
    ref = zoo_model(spec, "attention:xla")
    ref.params, ref.state = device_tree(init), device_tree(init_state)
    res["grad_diff"] = grad_check(
        spec.tag, spec.f32, grads,
        ref.executor._grads(ref.params, ref.state, batch, 0)[0])
    del batch
    plain = [r["loss"] for r in ref.fit(xs, y, epochs=ZOO_STEPS,
                                        verbose=False)]
    err = float(np.abs(np.array(losses) - np.array(plain)).max())
    ok = err <= TRAIN_TOL
    print(f"[zoo] {spec.tag}, {ZOO_STEPS} steps from the same weights: "
          f"loss flash + fused Adam {[round(v, 7) for v in losses]}, plain "
          f"attention + unfused Adam {[round(v, 7) for v in plain]}: "
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


def bf16_checkpoint_check(tmp: str, smi: str) -> dict:
    """bf16 leaves through the port's save and restore on the card: a
    bf16 matrix and an f32 vector on the device, saved, restored (the
    manifest verified) and copied into zeroed live tensors bit for bit.
    The step's pickle names its dtype "bfloat16" and never ml_dtypes
    (the form the JAX package unpickles through ml_dtypes; the port
    reads it without ml_dtypes, whether or not this machine has it,
    which the line prints)."""
    import importlib.util
    from flexflow_tpu_torch.runtime import checkpoint as ck
    gen = torch.Generator(device="cuda").manual_seed(11)
    leaves = {"w": torch.randn(768, 768, device="cuda",
                               generator=gen).to(torch.bfloat16),
              "b": torch.randn(768, device="cuda", generator=gen)}
    d = os.path.join(tmp, "bf16")
    mgr = ck.CheckpointManager(d)
    mgr.save(1, {"params": {"l": leaves}})
    saved, _ = mgr.restore(1)
    live = {"l": {k: torch.zeros_like(t) for k, t in leaves.items()}}
    ck._copy_into(live, saved["params"], "params")
    same = all(torch.equal(live["l"][k], t) for k, t in leaves.items())
    with open(os.path.join(d, "1", "manifest.json")) as f:
        dtypes = {k: r["dtype"] for k, r in json.load(f)["leaves"].items()}
    with open(os.path.join(d, "1", "state.pkl"), "rb") as f:
        raw = f.read()
    form = b"bfloat16" in raw and b"ml_dtypes" not in raw
    ml = importlib.util.find_spec("ml_dtypes") is not None
    print(f"[resilience] bf16 checkpoint leaf (768 x 768 bf16 + 768 f32 on "
          f"the card): saved, restored with its manifest verified, copied "
          f"into live tensors bit for bit: {same}; manifest dtypes "
          f"{dtypes}; pickled as numpy dtype 'bfloat16' without ml_dtypes: "
          f"{form}; ml_dtypes installed here: {ml}; {smi}")
    check(same and form and dtypes["['params']['l']['w']"] == "bfloat16"
          and dtypes["['params']['l']['b']"] == "float32",
          "bf16 checkpoint round trip")
    shutil.rmtree(d, ignore_errors=True)
    return {"bit_identical": same, "ml_dtypes_installed": ml}


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
    and metrics, the save / restore / overhead numbers and a bf16 leaf's
    round trip."""
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
        times["bf16_checkpoint"] = bf16_checkpoint_check(tmp, smi)
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
        # the library call at every measured length (timed only): SDPA
        # on the backend it picks for b1 h8 d64 f32 causal
        for s in (128, 512) + SEARCH_EXTRA_SEQS:
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
          + ", ".join(f"{dev_ms[('sdpa', s)] * 1e3:.2f} us at s{s}"
                      for s in seqs) + " (graph replay)")
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
# the first infer / generate call of one replica kills it. Its first
# call is certain: the router sends each request to the replica with the
# least estimated wait and rotates ties, and both replicas start idle
# (wait 0), so one of the first two requests reaches it. A later call is
# not: its scheduler batches concurrent requests into one call and the
# router may keep preferring the other replica, so a replica told to die
# at its 7th call could serve all of a short run without reaching it
FLEET_CRASH = "infer_crash@0"
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
    differing position d (else the last), the KV path as the oracle runs
    it (the row alone, prefilled with its prompt length, decoded with an
    int index) against the KV path as the batcher runs it (the row as
    row 0 of an 8-row batch, a full-cache prefill, decoded with a per-row
    index), from the start of d's decode segment with the oracle's
    tokens fed to the steps up to d: the logits at d, the prefill's
    cache of the row, and each product of the step at d (the executor's
    product log) at the executor's row chunk and at none (each product at
    the batch's own shape, how the step ran before the chunk); the full
    forward (scored_forward) alone and in 8; and the port's bf16 GEMM
    (mm_f32) of one row alone against the same row inside 8, at GPT-2's
    LM-head and MLP shapes, with no chunk."""
    import torch.nn.functional as F
    from flexflow_tpu_torch.executor import DECODE_ROW_CHUNK
    from flexflow_tpu_torch.ops.registry import mm_f32
    parted = np.flatnonzero((want != got).any(axis=1))
    k = int(parted[0]) if parted.size else 0
    diff = np.flatnonzero(want[k] != got[k])
    d = int(diff[0]) if diff.size else int(ends[k]) - 1
    s0 = int(plens[k]) + CB_SEG * ((d - int(plens[k])) // CB_SEG)
    others = [(k + j) % want.shape[0] for j in range(8)]
    ex, dev = ff.executor, ff.device

    def kv_run(ids, batcher, chunk=None, log=None):
        """Row 0's logits at d, its prefill cache and (``log``) the
        products of the step at d, the oracle's way or the batcher's."""
        cur = None
        with decode_ctx(ex, chunk, None if log is None
                        else lambda: log.setdefault(cur, [])), \
                torch.inference_mode():
            batch = gpt_batch(ids)
            n = ids.shape[0]
            cache = ex.kv_prefill(ff.params, ff.state, batch,
                                  prefill_len=None if batcher else s0)
            seeded = {(name, kk): t[:1].clone()
                      for name, c in cache.items()
                      for kk, t in c.items()}
            for cur in range(s0, d + 1):
                sb = {kk: v[:, cur - 1:cur] for kk, v in batch.items()}
                idx = torch.full((n,), cur - 1, dtype=torch.int64,
                                 device=dev) if batcher else cur - 1
                row, cache = ex.kv_decode_step(ff.params, ff.state, sb,
                                               cache, idx)
        return row[0].float(), seeded

    def row0(x, y):
        """Row 0's entries of an operand or output: x of the one-row run,
        y of the 8-row run. A tensor of the step's padded stream has the
        same rows in both, row 0 first; a batched attention product's
        holds the row's heads first (a weight operand is the same tensor
        in both)."""
        return 1 if x.shape[0] == y.shape[0] else x.shape[0]

    def same(x, y):
        n = row0(x, y)
        return x.shape[1:] == y.shape[1:] and torch.equal(x[:n], y[:n])

    def compare_products(chunk):
        """The step at d's products alone and in 8, and, over every step
        from s0, the first product whose output differs (its step, index
        and whether its operands were the same)."""
        logs = ({}, {}, {})
        for (ids, batcher), log in zip(((want[k:k + 1], False),
                                        (want[others], True),
                                        (want[k:k + 1], False)), logs):
            kv_run(ids, batcher, chunk, log)
        one, eight, again = (log[d] for log in logs)
        check(len(one) == len(eight) == len(again) > 0,
              "decode-step product logs")
        differ, first = [], None
        for i, (a, b) in enumerate(zip(one, eight)):
            if not same(a["out"], b["out"]):
                differ.append(f"#{i} {a['issued'][0][0]}@"
                              f"{a['issued'][0][1]}")
        for cur in range(s0, d + 1):
            for i, (a, b) in enumerate(zip(logs[0][cur], logs[1][cur])):
                if first is None and not same(a["out"], b["out"]):
                    n = row0(a["out"], b["out"])
                    dd = (a["out"][:n].float() - b["out"][:n].float()).abs()
                    first = {"step": cur, "index": i,
                             "issued": a["issued"][0],
                             "operands_equal": [same(a["a"], b["a"]),
                                                same(a["b"], b["b"])],
                             "elements_differ": int((dd > 0).sum()),
                             "max_abs": dd.max().item(),
                             "where": [int(x) for x in
                                       (dd > 0).nonzero()[0].tolist()]}
        repeat = sum(torch.equal(a["out"], b["out"])
                     for a, b in zip(one, again))
        return {"chunk": chunk, "products": len(one),
                "bit_equal": len(one) - len(differ), "differ": differ,
                "first": first, "repeat_bit_equal": repeat,
                "issued_1": sorted({str(x) for p in one
                                    for x in p["issued"]})[:4]}

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

    chunk = DECODE_ROW_CHUNK
    (one, seed1), (eight, seed8) = (kv_run(want[k:k + 1], False),
                                    kv_run(want[others], True))
    res = {"row": k, "parted": bool(parted.size), "position": d,
           "segment_start": s0, "kv": compare(one, eight),
           "prefill_cache": {
               "bit_equal": all(torch.equal(seed1[key], seed8[key])
                                for key in seed1),
               "max_abs": max((seed1[key].float() - seed8[key].float())
                              .abs().max().item() for key in seed1),
               "range": max(seed1[key].float().abs().max().item()
                            for key in seed1)},
           "forward": compare(fwd_logits(want[k:k + 1]),
                              fwd_logits(want[others])),
           "products": {c: compare_products(c) for c in (chunk, 0)}}
    gen = torch.Generator(device=dev).manual_seed(14)
    for name, (kin, nout) in (("lm_head", (768, vocab_of(ff))),
                              ("mlp", (768, 3072))):
        h = torch.randn(8, kin, generator=gen, device=dev) \
            .to(torch.bfloat16)
        w = torch.randn(kin, nout, generator=gen, device=dev) \
            .to(torch.bfloat16)
        res[f"gemm_{name}"] = compare(mm_f32(h[:1], w)[0],
                                      mm_f32(h, w)[0], tokens=False)
    # the decode step's other row-wise ops: LayerNorm over 768 and the
    # attention softmax over the 1024 cached positions
    x = torch.randn(8, 1, 768, generator=gen, device=dev)
    wln, bln = (torch.randn(768, generator=gen, device=dev) for _ in "wb")
    res["layer_norm"] = compare(
        F.layer_norm(x[:1], (768,), wln, bln)[0, 0],
        F.layer_norm(x, (768,), wln, bln)[0, 0], tokens=False)
    z = torch.randn(8, 12, 1, GPT_SEQ, generator=gen, device=dev)
    res["softmax"] = compare(torch.softmax(z[:1], -1)[0].flatten(),
                             torch.softmax(z, -1)[0].flatten(),
                             tokens=False)
    print(f"[serve] row-independence probe, row {k} "
          f"({'parted from its oracle' if parted.size else 'no row parted'}"
          f") at position {d} (decode segment from {s0}): the row alone "
          f"(the oracle's prefill and int index) against row 0 of an 8-row "
          f"batch (the batcher's full-cache prefill and per-row index): "
          + "; ".join(f"{n} " + ("bit-equal" if r["bit_equal"] else
                                  f"max|diff| {r['max_abs']:.3e} of range "
                                  f"{r['range']:.3e}")
                      + (f", the two tokens' gap {r['gap_alone']:.3e} "
                         f"alone / {r['gap_in_8']:.3e} in 8"
                         if "gap_alone" in r else "")
                      for n, r in res.items()
                      if isinstance(r, dict) and n != "products")
          + f" ({smi})")
    for c, r in res["products"].items():
        print(f"[serve] row-independence probe, the decode step's products "
              f"at row chunk {c} ({'each at the batch' + chr(39) + 's own '
              'shape' if not c else 'issued as ' + ', '.join(r['issued_1'])})"
              f": {r['bit_equal']} of {r['products']} bit-equal alone and "
              f"in 8, {r['repeat_bit_equal']} bit-equal over two runs alone"
              + (f"; differ: {', '.join(r['differ'][:12])}; the first: "
                 f"{r['first']}" if r["differ"] else "") + f" ({smi})")
    return res


def serve_generate(smi: str) -> dict:
    """GPT-2 small behind POST /generate, then the continuous batcher
    under continuous and static admission against per-sequence
    session.generate."""
    from flexflow_tpu_torch.executor import DECODE_ROW_CHUNK
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
              f"bit-identical to session.generate(row[None]) (want all), "
              f"the others part at a score gap <= {gap:.3e} of the row's "
              f"range ({smi})")
        if admission == "continuous":
            probe_rows = (a, b)
        res[admission] = {"iterations": st["iterations"],
                          "evicted_early": st["evicted_early"],
                          "launches": launches, "tokens": toks,
                          "wall_s": wall, "tokens_per_s": toks / wall,
                          "equal_rows": equal, "worst_gap": gap}
    res["row_probe"] = p = row_probe(ff, *probe_rows, plens,
                                     plens + budgets, smi)
    check(p["kv"]["bit_equal"], "the KV decode step's logits differ "
                                "between the oracle's and the batcher's way")
    r = p["products"][DECODE_ROW_CHUNK]
    check(r["bit_equal"] == r["products"], f"decode-step products differ "
                                           f"alone and in 8: {r['differ']}")
    for admission in ("continuous", "static"):
        equal = res[admission]["equal_rows"]
        check(equal == CB_SEQS, f"{admission}: {CB_SEQS - equal} rows "
                                f"parted from session.generate(row[None])")
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
                zoo, fe, resil, search, srv, dist, pipe, seq,
                genworld) -> list:
    """The kernels' JSON rows: times at b8 h12 s128 d64 bf16 without
    dropout, with s512, dropout 0.1, the causal shapes, head dims 128,
    256, 320 and 512, NMT's and the Transformer's attention, Adam over
    DLRM, and the LLaMA, Mixtral, MoE, zoo, frontends, resilience,
    search, serving-stack, dist, pipe, seq and genworld launches beside
    them."""
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

    def dist_row(name):
        """The dist phase's launches on each rank in its history: BERT-base
        8x512 trained by two ranks under dp 2 and tp 2, and under the
        serial dp 2 at dropout 0.1, ZeRO, the overlap schedule under ZeRO
        and the int8 quantized sync; the fused Adam's times at the launch
        shapes the last three give it."""
        row = {"dist_train_launches_per_rank": {
            cfg: dist[cfg]["launches_per_rank"][name]
            for cfg, _ in DIST_RUNS}}
        row["dist_train_launches_per_rank"].update({
            cfg: dist["sync"][cfg]["launches_per_rank"][name]
            for cfg, _ in DIST_SYNC_RUNS})
        if name == "adam_update" and "adam_sync_shapes" in dist:
            row["dist_launch_shapes"] = {
                k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "numel", "leaves")}
                for k, v in dist["adam_sync_shapes"].items()}
        return row

    def pipe_row(name):
        """The pipe phase's launches on each rank in its history:
        BERT-base 8x512 trained pp 2 by two ranks under GPipe and the
        interleaved schedule, and DLRM with its tables banked over two;
        the kernels' times at the shapes these paths give them."""
        row = {"pipe_train_launches_per_rank": {
            cfg: pipe[cfg]["launches_per_rank"][name]
            for cfg in ("gpipe", "interleaved", "dlrm")}}
        if name == "adam_update":
            row["pipe_launch_shapes"] = {
                k: {f: pipe[k][f] for f in ("ms", "plain_ms", "bound_ms",
                                            "library_ms", "numel",
                                            "leaves")}
                for k in ("adam_pp_rank", "adam_bank_rank")}
        elif name == "flash_attention_fwd":
            row["pipe_b2_h12_s512_d64"] = dict(pipe["fwd_b2"])
        else:
            row["pipe_b2_h12_s512_d64"] = bwd_row_t(
                "dq" if name.endswith("dq") else "dkv", pipe["bwd_b2"])
        return row

    def fwd_row(seq, rate):
        return dict(kt["fwd"][(seq, rate)])

    def bwd_row(key, seq, rate):
        return bwd_row_t(key, kt["bwd"][(seq, rate)])

    def seq_row(name):
        """The seq phase's launches on each rank: GPT-2 small 8x1024
        trained sp 2 under attention:ring (no flash launch; one fused Adam
        a step) in bf16 and f32, and Ulysses' flash kernels a call at b4
        h12 s1024 d64 over two ranks; the kernels' times at the shapes
        these paths give them."""
        row = {"seq_sp2_train_launches_per_rank": {
            k: [r[name] for r in seq["gpt_" + k]["launches"]]
            for k in ("bf16", "f32")}}
        if name == "adam_update":
            row["seq_launch_shape"] = {
                f: seq["adam_sp_rank"][f] for f in (
                    "ms", "plain_ms", "bound_ms", "library_ms", "numel",
                    "leaves")}
            return row
        row["seq_ulysses_launches_per_call_per_rank"] = {
            k: v["launches"][name] for k, v in seq["fns"].items()
            if k.startswith("ulysses")}
        row["seq_ulysses_b4_h6_s1024_d64_causal"] = \
            dict(seq["fwd_ulysses"]) if name == "flash_attention_fwd" \
            else bwd_row_t("dq" if name.endswith("dq") else "dkv",
                           seq["bwd_ulysses"])
        return row

    def bwd_row_t(key, t):
        return {"ms": t[key + "_ms"], "plain_ms": t[key + "_plain_ms"],
                "bound_ms": t[key + "_bound"][0],
                "bound_by": t[key + "_bound"][1],
                # one call computes dq, dk and dv together
                "library_ms": t["sdpa_bwd_ms"],
                "library_backend": t["sdpa_bwd_backend"],
                # the autograd Function's backward: delta, dq, dk/dv
                "function_backward_ms": t["fn_ms"],
                # the f32 wide kernels: the FMA rate's bound beside the
                # TF32 passes' one
                **({"fma_bound_ms": t[key + "_fma_bound_ms"]}
                   if key + "_fma_bound_ms" in t else {})}

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
        # f32: the search's calibration rows (b1 h8 d64 causal, 10
        # launches while calibrating) and d 128 on the split-precision
        # TF32 kernel, d 192 ... 512 and NMT's shape (the zoo's f32 NMT
        # step, one launch a step) on the wide one
        "f32_calibration_b1_h8_s128_d64_causal":
            dict(kt["fwd_f32_calib_s128"]),
        "f32_calibration_b1_h8_s512_d64_causal":
            dict(kt["fwd_f32_calib_s512"]),
        "f32_b1_h8_s512_d128_causal": dict(kt["fwd_f32_d128"]),
        "f32_b4_h8_s512_d192": dict(kt["fwd_f32_d192"]),
        "f32_b4_h8_s512_d256": dict(kt["fwd_f32_d256"]),
        "f32_b4_h8_s512_d256_causal": dict(kt["fwd_f32_d256_causal"]),
        "f32_b4_h8_s512_d320": dict(kt["fwd_f32_d320"]),
        "f32_b4_h8_s512_d512": dict(kt["fwd_f32_d512"]),
        "f32_nmt_b64_h1_s128_d512": dict(kt["fwd_f32_nmt"]),
        "f32_kernel": "flash_fwd_wgmma_tf32_kernel (f32, d 64 and 128; "
                      "three TF32 passes a product)",
        "f32_wide_kernel": "flash_fwd_wgmma_wide_tf32_kernel (f32, d "
                           "192-512; three TF32 passes a product)",
        # the Transformer's attention (zoo phase), d 8 unpadded through
        # the narrow kernel; the zoo's train launches (6 a step for the
        # Transformer, 1 for NMT) and the Transformer's served forwards
        "f32_train_launches": train["f32"]["launches"]["flash_attention_fwd"],
        "transformer_b64_h8_s512_d8": dict(kt["fwd_transformer"]),
        "narrow_bf16_kernel": "flash_fwd_wgmma_narrow_kernel (bf16, d 8, "
                              "16, 24, 32 unpadded; DP 16 or 32)",
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
        **dist_row("flash_attention_fwd"),
        **pipe_row("flash_attention_fwd"),
        **seq_row("flash_attention_fwd"),
        # the genworld phase: GPT-2 small's prefills on each of two ranks
        # (12 launches a prefill, none a decode step) under tp 2 and dp 2
        # and through the serving plan's relay, and the forward at each
        # rank's block of a prefill
        "genworld_launches_per_rank": {
            k: genworld[k]["launches"] for k in ("tp2", "dp2")},
        "genworld_prefills": {k: genworld[k]["prefills"]
                              for k in ("tp2", "dp2")},
        "genworld_plan_launches_per_rank": genworld["plan"]["launches"],
        "genworld_tp2_b8_h6_s1024_d64_causal": dict(genworld["fwd_tp"]),
        "genworld_dp2_b4_h12_s1024_d64_causal": dict(genworld["fwd_dp"]),
        "genworld_tp2_b1_h6_s1024_d64_causal": dict(genworld["fwd_tp1"]),
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
            "f32_b1_h8_s512_d64_causal": bwd_row_t(key,
                                                   kt["bwd_f32_calib"]),
            "f32_b1_h8_s512_d128_causal": bwd_row_t(key,
                                                    kt["bwd_f32_d128"]),
            "f32_b8_h12_s512_d64": bwd_row_t(key, kt["bwd_f32_bert"]),
            "f32_b8_h12_s512_d128": bwd_row_t(key, kt["bwd_f32_bert_d128"]),
            # BERT-base 8x512 under --f32-compute (train phase)
            "f32_train_launches": train["f32"]["launches"][name],
            "f32_b4_h8_s512_d192": bwd_row_t(key, kt["bwd_f32_d192"]),
            "f32_b4_h8_s512_d256": bwd_row_t(key, kt["bwd_f32_d256"]),
            "f32_b4_h8_s512_d256_causal": bwd_row_t(
                key, kt["bwd_f32_d256_causal"]),
            "f32_b4_h8_s512_d320": bwd_row_t(key, kt["bwd_f32_d320"]),
            "f32_b4_h8_s512_d512": bwd_row_t(key, kt["bwd_f32_d512"]),
            "f32_nmt_b64_h1_s128_d512": bwd_row_t(key, kt["bwd_f32_nmt"]),
            "zoo_train_launches": {t: n[name]
                                   for t, n in zoo_launches.items()},
            "frontends_train_launches": fe_row(name),
            "resilience_train_launches": resil["launches"][name],
            **search_row(name),
            **dist_row(name),
            **pipe_row(name),
            **seq_row(name),
            "wide_bf16_kernel": f"flash_bwd_{key}_wgmma_wide_kernel (d "
                                "192-512)",
            "f32_kernel": f"flash_bwd_{key}_wgmma_tf32_kernel (f32, d 64 "
                          "and 128; three TF32 passes a product)",
            "f32_wide_kernel": f"flash_bwd_{key}_wgmma_wide_tf32_kernel "
                               "(f32, d 192-512; three TF32 passes a "
                               "product)",
            "narrow_bf16_kernel": f"flash_bwd_{key}_wgmma_narrow_kernel "
                                  "(bf16, d 8, 16, 24, 32 unpadded; DP 16 "
                                  "or 32)"})
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
        "f32_train_launches": train["f32"]["launches"]["adam_update"],
        **search_row("adam_update"),
        **dist_row("adam_update"),
        **pipe_row("adam_update"),
        **seq_row("adam_update"),
        "dlrm_256.03M_params": {
            k: kt["adam_dlrm"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "library_ms")}})
    return rows


# --------------------------------------------------------------------------
# dist: BERT-base trained by a world of two ranks sharing the card
# --------------------------------------------------------------------------
# the configurations the two ranks run, each against the one-rank run of
# the same weights and data
DIST_RUNS = (("dp2", ("--only-data-parallel",)), ("tp2", ("--tp", "2")))
# the rank processes and the phase: each rank builds two BERT-base models
# per configuration and trains them; the rendezvous and every collective
# time out well inside it
DIST_TIMEOUT_S = 600
# the model and run: full-width BERT-base at 8 x 512 cut to 4 of its 12
# layers (the dist and pipe phases' worlds step on one card shared by two
# ranks: the depth is what the card check's time limit cuts), bf16
# compute, first-step gradients at dropout 0.1, a 4-step history at
# dropout 0, then 3 timed steps
DIST_SPEC = {"device": "cuda", "bert": "base", "layers": 4, "batch": 8,
             "seq": 512, "steps": 4, "timed": 3, "f32": False}
# the bf16 first-step gradients at dropout 0.1 against the one-rank run's,
# leaf by leaf (grad_errs), with the key biases left out: their true
# gradient is 0 (softmax ignores a shift common to a row's scores), so
# their reading is bf16 rounding over GRAD_FLOOR of the whole gradient.
# Sound ranks read up to 3.1e-3 (wq); the one-rank run against itself
# under another draw of every mask reads far above (the phase checks
# that it does, so a map that hashed the wrong masks would show)
DIST_BF16_GRAD_TOL = 2e-2


def dist_checked(k: str, errs: list) -> list:
    """The leaves of ``errs`` held to the first-step limit in ``k``: every
    one in f32, all but the key biases in bf16."""
    return errs if k == "f32" else [e for e in errs
                                    if not e[1].endswith(".bk")]


def dist_grad_tol(k: str) -> float:
    return ZOO_GRAD_TOL if k == "f32" else DIST_BF16_GRAD_TOL


# the train step's multi-device branches, each trained by the two ranks
# at dropout 0.1 from the same weights and batches as the serial dp-2 run
# (the first): ZeRO-1 and the overlap schedule under ZeRO must reproduce
# it bit for bit, the int8 quantized sync within QSYNC_LOSS_TOL
DIST_SYNC_RUNS = (
    ("dp2_serial", ("--only-data-parallel",)),
    ("zero", ("--only-data-parallel", "--zero")),
    ("overlap_zero", ("--only-data-parallel", "--zero",
                      "--overlap-schedule", "on", "--zero-prefetch", "1")),
    ("qsync_int8", ("--only-data-parallel", "--quantized-collectives",
                    "all", "--qsync-wire", "int8")))


def qsync_loss_ok(a: float, b: float) -> bool:
    """The quantized-sync loss bound of tests/test_quantized_collectives
    .py (and the port's CPU test): 5% of the full-precision loss or 2e-3,
    whichever is larger."""
    return abs(a - b) <= max(abs(b) * 0.05, 2e-3)


def dist_model(spec: dict, argv, dropout: float):
    """BERT of ``spec`` with the flash kernels and the fused Adam, compiled
    under ``argv`` (over the world when this process is a rank of one)."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models import BertConfig, build_bert
    cfg = FFConfig.parse_args(list(argv))
    cfg.batch_size, cfg.seed, cfg.device = spec["batch"], 0, spec["device"]
    # (the fused Adam's predicate refuses the CPU: a rehearsal there sets
    # the plan after the compile, and the kernel's plain version runs)
    cfg.kernel_impls = "attention:flash,opt_update:fused" \
        if spec["device"] == "cuda" else "attention:flash"
    cfg.use_bf16_compute = not spec["f32"]
    ff = FFModel(cfg)
    bcfg = getattr(BertConfig, spec["bert"])()
    bcfg.max_position, bcfg.dropout = spec["seq"], dropout
    # (a rehearsal's tiny BERT takes the layers the interleaved schedule
    # needs: 2 stages x 2 chunks)
    bcfg.num_layers = spec.get("layers", bcfg.num_layers)
    out = build_bert(ff, spec["batch"], spec["seq"], bcfg)
    ff.compile(AdamOptimizer(1e-4), "sparse_categorical_crossentropy",
               ["accuracy"], output_tensor=out)
    ff.executor._kernel_impls["opt_update"] = "fused"
    return ff, bcfg


def dist_data(spec: dict, bcfg) -> tuple:
    """Seeded ids, positions and labels of ``spec["steps"]`` batches."""
    rows = spec["batch"] * spec["steps"]
    rng = np.random.default_rng(21)
    ids = rng.integers(0, bcfg.vocab_size, (rows, spec["seq"])).astype(
        np.int32)
    pos = np.tile(np.arange(spec["seq"], dtype=np.int32), (rows, 1))
    y = rng.integers(0, bcfg.num_labels, (rows, 1)).astype(np.int32)
    return [ids, pos], y


def dist_run(spec: dict, argv, tag: str, control: bool = False) -> dict:
    """One configuration in this process's world (alone: the reference):
    the first step's gradients at dropout 0.1 (whole, on the host; with
    ``control``, those of another draw of every mask too), then
    at dropout 0 the forward's output on the first batch, a
    ``spec["steps"]``-step history through the loader that feeds each rank
    its rows, with every kernel launch and the reshard bytes counted, its
    peak memory, and ``spec["timed"]`` timed steps; where
    ``spec["profile"]`` names a directory, one more step profiled
    (:func:`profile_dist_step`) into ``<dir>/<tag>.txt``."""
    from flexflow_tpu_torch.parallel.reshard import STATS
    sync = torch.cuda.synchronize if spec["device"] == "cuda" \
        else (lambda: None)

    def first_grads(f32: bool, draws) -> list:
        ff, bcfg = dist_model(dict(spec, f32=f32), argv, 0.1)
        xs, y = dist_data(spec, bcfg)
        batch = next(iter(ff._combined_loader(xs, y, shuffle=False)))
        outs = []
        for draw in draws:      # the step index seeds every mask
            grads, _, _ = ff.executor._grads(ff.params, ff.state, batch,
                                             draw)
            outs.append({ln: {n: ff.executor._unplace(t).detach().float()
                              .cpu() for n, t in d.items()}
                         for ln, d in grads.items()})
            del grads
        del ff, batch
        free_cuda()
        return outs

    # the first step's gradients at dropout 0.1 in f32 (the f32 flash
    # kernels hash the masks too) and, where the run is bf16, in bf16
    kinds = ("f32",) if spec["f32"] else ("f32", "bf16")
    grads, other = {}, {}
    for k in kinds:
        got = first_grads(k == "f32", (0, 1) if control else (0,))
        grads[k] = got[0]
        if control:
            other[k] = got[1]
    ff, bcfg = dist_model(spec, argv, 0.0)
    xs, y = dist_data(spec, bcfg)
    first = {"input_ids": xs[0][:spec["batch"]],
             "position_ids": xs[1][:spec["batch"]]}
    out = ff.executor.make_forward()(ff.params, ff.state, first)
    forward = out.float().cpu()
    loader = ff._combined_loader(xs, y, shuffle=False)
    step_fn = ff.executor.make_train_step()
    batches = list(loader)
    sync()
    if spec["device"] == "cuda":
        torch.cuda.reset_peak_memory_stats()
    STATS.reset()
    fns = zero_counts()      # the main path: every count starts at 0 here
    plain = {n: f.plain_calls for n, f in fns.items()}
    losses = [float(ff._run_train_step(step_fn, b)["loss"])
              for b in batches]
    # (a rehearsal on the CPU counts the wrappers' plain-version calls)
    launches = {n: f.launches if spec["device"] == "cuda"
                else f.plain_calls - plain[n] for n, f in fns.items()}
    reshard = {"bytes": STATS.bytes_total,
               "redistribute": STATS.executed_redistribute,
               "searched": STATS.executed_searched,
               "naive": STATS.executed_naive}
    peak = torch.cuda.max_memory_allocated() \
        if spec["device"] == "cuda" else 0
    times = []
    for i in range(spec["timed"]):
        sync()
        t0 = time.perf_counter()
        float(ff._run_train_step(step_fn, batches[i % len(batches)])
              ["loss"])
        sync()
        times.append(time.perf_counter() - t0)
    prof = None
    if spec.get("profile"):
        os.makedirs(spec["profile"], exist_ok=True)
        prof = profile_dist_step(ff, step_fn, batches[0],
                                 os.path.join(spec["profile"], tag + ".txt"))
    leaves = sum(len(d) for d in ff.params.values())
    return {"grads": grads, "other": other, "forward": forward,
            "losses": losses, "launches": launches, "reshard": reshard,
            "peak_bytes": peak, "step_ms": [t * 1e3 for t in times],
            "leaves": leaves, "mesh": dict(ff.dmesh.axis_sizes),
            "profile": prof}


# host layers of a rank's step, by the file or the C function a profiled
# call's own time is spent in (the first match names it; the rest is
# "other Python"). The functional collectives are torch.library ops:
# their waits run in torch/_ops.py's redispatch. DTensor's entry points
# pass through the dynamo-disable and export wrappers and its layouts
# through _pycute. The one-rank step reaches none of these
HOST_LAYERS = (
    ("collectives", ("distributed_c10d", "_functional_collectives",
                     "c10d", "torch/_library/", "torch/_ops.py:redispatch")),
    ("DTensor (sharding rules, redistribute, dispatch)", (
        "torch/distributed/tensor", "torch/distributed/_pycute",
        "torch/_dynamo/", "torch/_compile.py", "torch/_export/wrappers")),
    ("the port (executor, ops, kernel wrappers)", ("flexflow_tpu_torch",)),
    ("autograd (backward on the engine's threads)", (
        "run_backward", "torch/autograd", "torch/_functorch/",
        "built-in method apply")),
    ("aten ops and launches (C++)", ("torch/_ops.py", "torch._ops",
                                    "torch._C", "TensorBase",
                                    "built-in method torch.")),
)


def host_layers(stats) -> dict:
    """A cProfile ``pstats.Stats``'s own time (ms) by HOST_LAYERS."""
    from collections import defaultdict
    layers = defaultdict(float)
    for (fname, _, func), (_, _, tt, _, _) in stats.stats.items():
        where = f"{fname}:{func}"
        layers[next((name for name, keys in HOST_LAYERS
                     if any(k in where for k in keys)),
                    "other Python")] += tt * 1e3
    return dict(layers)


def dist_step_stages(ff, step_fn, batch) -> dict:
    """One train step with the host's time (ms) in each stage of the
    executor: the forward, the backward, the outputs gathered for the
    loss, the gradients brought to their leaves' layouts (``_sync_serial``
    over a world) and the optimizer update (the rest of the step). Each
    stage's function is wrapped for that step only. (cProfile's
    cumulative times lose the frames that enter DTensor's dispatch.)"""
    from collections import defaultdict
    ex = ff.executor
    spent = defaultdict(float)

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] += (time.perf_counter() - t0) * 1e3
        return run
    grad = torch.autograd.grad
    ex._forward = timed("forward", ex._forward)
    ex._replicate_for_loss = timed("outputs gathered for the loss",
                                   ex._replicate_for_loss)
    ex._backward = timed("_backward", ex._backward)
    ex._sync_serial = timed("gradients to their leaves' layouts",
                            ex._sync_serial)
    torch.autograd.grad = timed("backward (autograd.grad)", grad)
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    try:
        sync()
        t0 = time.perf_counter()
        float(ff._run_train_step(step_fn, batch)["loss"])
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        torch.autograd.grad = grad
        for k in ("_forward", "_replicate_for_loss", "_backward",
                  "_sync_serial"):
            del ex.__dict__[k]
    bwd = spent.pop("_backward")
    layouts = spent.setdefault("gradients to their leaves' layouts", 0.0)
    spent["optimizer update and the rest"] = wall - bwd - layouts
    spent["step (synchronized)"] = wall
    return dict(spent)


def profile_dist_step(ff, step_fn, batch, path: str) -> dict:
    """One train step under torch.profiler (the device's side: busy
    share, collective kernels and their device time), one under cProfile
    (the host's side: the step's host time split by HOST_LAYERS, by each
    call's own time) and one split by the executor's stages
    (:func:`dist_step_stages`); the tables go to ``path``, the cProfile
    stats beside it (``.prof``)."""
    import cProfile
    import io
    import pstats
    dev = profile_train_step(ff, step_fn, batch)
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    float(ff._run_train_step(step_fn, batch)["loss"])
    sync()
    prof.disable()
    host_wall = (time.perf_counter() - t0) * 1e3
    layers = host_layers(pstats.Stats(prof))
    stages = dist_step_stages(ff, step_fn, batch)
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(60)
    prof.dump_stats(os.path.splitext(path)[0] + ".prof")
    with open(path, "w") as f:
        f.write(f"device: {json.dumps(dev)}\nhost wall under cProfile "
                f"{host_wall:.1f} ms, own time by layer "
                f"{json.dumps(layers)}, by stage (host clock) "
                f"{json.dumps(stages)}\n\n{buf.getvalue()}")
    return {"device": dev, "host_wall_ms": host_wall,
            "host_layers_ms": layers, "host_stages_ms": stages}


def grad_errs(got: dict, want: dict) -> list:
    """Leaf by leaf ||got - want|| / max(||want||, GRAD_FLOOR ||whole
    want||), worst first (``grad_check``'s measure)."""
    whole = sum(float(t.double().norm()) ** 2
                for d in want.values() for t in d.values()) ** 0.5
    return sorted(((float((got[ln][n].double() - t.double()).norm())
                    / max(float(t.double().norm()), GRAD_FLOOR * whole),
                    f"{ln}.{n}") for ln, d in want.items()
                   for n, t in d.items()), reverse=True)


def dist_sync_run(spec: dict, argv) -> tuple:
    """One of DIST_SYNC_RUNS in this rank: BERT of ``spec`` at dropout 0.1
    trained ``spec["steps"]`` steps through the loader with every kernel
    launch counted (the counts set to 0 just before), the sync
    collectives' calls and bytes, peak memory, then ``spec["timed"]``
    timed steps. Returns (results, the weights after the history on the
    host, whole)."""
    from flexflow_tpu_torch.ops.quantized_collectives import RESIDUAL_SLOT
    from flexflow_tpu_torch.parallel.distributed import SYNC_STATS
    sync = torch.cuda.synchronize if spec["device"] == "cuda" \
        else (lambda: None)
    ff, bcfg = dist_model(spec, argv, 0.1)
    xs, y = dist_data(spec, bcfg)
    batches = list(ff._combined_loader(xs, y, shuffle=False))
    step_fn = ff.executor.make_train_step()
    sync()
    if spec["device"] == "cuda":
        torch.cuda.reset_peak_memory_stats()
    SYNC_STATS.reset()
    fns = zero_counts()      # the main path: every count starts at 0 here
    plain = {n: f.plain_calls for n, f in fns.items()}
    losses = [float(ff._run_train_step(step_fn, b)["loss"])
              for b in batches]
    launches = {n: f.launches if spec["device"] == "cuda"
                else f.plain_calls - plain[n] for n, f in fns.items()}
    steps = len(batches)
    calls, wire = SYNC_STATS.calls / steps, SYNC_STATS.bytes / steps
    peak = torch.cuda.max_memory_allocated() \
        if spec["device"] == "cuda" else 0
    weights = {f"{ln}.{wn}": ff.executor._unplace(t).detach().cpu()
               for ln, ws in ff.params.items() for wn, t in ws.items()}
    out = {"losses": losses, "launches": launches, "sync_calls": calls,
           "wire_bytes": wire, "peak_bytes": peak,
           "leaves": len(weights),
           "buckets": None if ff.executor._overlap_schedule is None
           else len(ff.executor._overlap_schedule.buckets),
           "qsync": ff.executor._qsync is not None,
           "residual_abs": float(sum(
               float(t.to_local().abs().sum())
               for ws in ff.opt_state.get(RESIDUAL_SLOT, {}).values()
               for t in ws.values())),
           "moments_local_numel": sum(
               t.to_local().numel() for ws in ff.opt_state["m"].values()
               for t in ws.values())}
    times = []
    for i in range(spec["timed"]):
        sync()
        t0 = time.perf_counter()
        float(ff._run_train_step(step_fn, batches[i % steps])["loss"])
        sync()
        times.append(time.perf_counter() - t0)
    out["step_ms"] = [t * 1e3 for t in times]
    del ff, step_fn, batches
    free_cuda()
    return out, weights


def qsync_mass(spec: dict, n: int = 768 * 3072) -> dict:
    """One int8 quantized all-reduce over the world on a tensor the size
    of BERT-base's FFN kernel (seeded by rank), its error-feedback mass in
    f64: the output plus every rank's residual against the inputs' sum,
    beside the f32 rounding bound of the reduce leg's adds (two ulps of
    each rank's |x|)."""
    import torch.distributed as dist
    from flexflow_tpu_torch.ops.quantized_collectives import \
        quantized_all_reduce
    rank, world = dist.get_rank(), dist.get_world_size()
    gen = torch.Generator(device="cpu").manual_seed(50 + rank)
    x = (torch.randn(n, generator=gen) * 1e-3).to(spec["device"])
    out, res = quantized_all_reduce(x, None, "int8", world, rank)
    tot = x.double().cpu()
    absx = x.double().abs().cpu()
    resd = res.double().cpu()
    for t in (tot, absx, resd):
        dist.all_reduce(t)
    err = (out.double().cpu() + resd - tot).abs()
    bound = 2 * world * float(torch.finfo(torch.float32).eps) * absx
    return {"max_err": float(err.max()), "max_bound": float(bound.max()),
            "within": bool((err <= bound + 1e-30).all()),
            "sum_abs_residual": float(resd.abs().sum())}


def dist_rank_main(workdir: str) -> int:
    """A rank of the dist phase (``--dist-rank``): joins the world the
    environment names, runs each of DIST_RUNS and holds it against the
    one-rank reference the parent saved, then writes its results."""
    import torch.distributed as dist
    from flexflow_tpu_torch.parallel.distributed import (ROUTES,
                                                         maybe_initialize)
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize(device_type=spec["device"])
    rank = dist.get_rank()
    ref = torch.load(os.path.join(workdir, "ref.pt"))
    out = {"backend": dist.get_backend(), "routes": dict(ROUTES)}
    for name, argv in DIST_RUNS:
        r = dist_run(spec, argv, f"{name}_rank{rank}")
        grads = r.pop("grads")
        r["grad_errs"] = {k: grad_errs(g, ref["grads"][k])
                          for k, g in grads.items()}
        r["forward_err"] = float((r.pop("forward")
                                  - ref["forward"]).abs().max())
        r["loss_err"] = max(abs(a - b) for a, b in zip(r["losses"],
                                                       ref["losses"]))
        out[name] = r
        free_cuda()
    base = None
    for name, argv in DIST_SYNC_RUNS:
        r, weights = dist_sync_run(spec, argv)
        if base is None:
            base = (r["losses"], weights)
        else:
            r["weights_max_abs_diff"] = max(
                float((weights[k] - base[1][k]).abs().max())
                for k in base[1])
            r["losses_equal"] = r["losses"] == base[0]
            r["loss_max_abs_diff"] = max(abs(a - b) for a, b in
                                         zip(r["losses"], base[0]))
        del weights
        out["sync_" + name] = r
    out["qsync_mass"] = qsync_mass(spec)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def dist_nccl_main(workdir: str) -> int:
    """The one-rank NCCL world (``--dist-nccl``): the deployment's backend
    with one rank per card initializes, and the same compile takes one
    step."""
    import torch.distributed as dist
    from flexflow_tpu_torch.parallel.distributed import maybe_initialize
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    maybe_initialize(device_type="cuda")
    ff, bcfg = dist_model(spec, ("--only-data-parallel",), 0.1)
    xs, y = dist_data(spec, bcfg)
    batch = next(iter(ff._combined_loader(xs, y, shuffle=False)))
    loss = float(ff._run_train_step(ff.executor.make_train_step(), batch)
                 ["loss"])
    with open(os.path.join(workdir, "nccl.json"), "w") as f:
        json.dump({"backend": dist.get_backend(),
                   "world": dist.get_world_size(), "loss": loss}, f)
    dist.destroy_process_group()
    return 0


def spawn_world(workdir: str, flag: str, world: int) -> list:
    """``world`` rank processes of this script (``flag`` names their part)
    joined at a free local port; waits for all of them within
    DIST_TIMEOUT_S, kills every one on a failure or a timeout, and raises
    with each rank's last output."""
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, FF_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   FF_NUM_PROCESSES=str(world), FF_PROCESS_ID=str(r),
                   FF_DIST_TIMEOUT_S=str(DIST_TIMEOUT_S // 2),
                   # each line reaches the log as it is printed, so a
                   # rank killed at the time limit shows where it was
                   PYTHONUNBUFFERED="1",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        logs.append(os.path.join(workdir, f"{flag}{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, workdir],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    end = time.monotonic() + DIST_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > end or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    tails = []
    for r, lg in enumerate(logs):
        with open(lg) as f:
            tails.append(f"--- {flag} rank {r} (exit {codes[r]}) ---\n"
                         + f.read()[-4000:])
    check(all(c == 0 for c in codes),
          f"{flag} world of {world} failed: exit codes {codes}\n"
          + "\n".join(tails))
    return codes


def dist_adam_times(spec: dict, smi: str) -> dict:
    """The fused Adam kernel at the launch shapes the new paths give it on
    BERT-base of ``spec`` over two ranks: a rank's ZeRO blocks of every
    leaf (one launch), and the largest and the smallest bucket of the
    overlap schedule under ZeRO (one launch a bucket), each against its
    plain version, torch._fused_adam_ and the bound (28 bytes a
    parameter at HBM_BYTES_PER_S)."""
    import types
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.executor import GraphProgram
    from flexflow_tpu_torch.models import BertConfig, build_bert
    from flexflow_tpu_torch.ops import ensure_weight_specs
    from flexflow_tpu_torch.runtime.overlap import build_overlap_schedule
    from flexflow_tpu_torch.runtime.zero import zero_spec
    ff = FFModel(FFConfig())
    o = build_bert(ff, spec["batch"], spec["seq"],
                   getattr(BertConfig, spec["bert"])())
    prog = GraphProgram(ff.layers, ff.input_tensors, [o])

    def block(shape):
        sp = zero_spec(shape, None, {"x0": 2})
        return tuple(n // 2 if sp is not None and d < len(sp)
                     and sp[d] is not None else n
                     for d, n in enumerate(shape))
    shapes = {l.name: [block(tuple(w.shape))
                       for w in ensure_weight_specs(l)] for l in ff.layers}
    sched = build_overlap_schedule(prog, types.SimpleNamespace(
        pipeline=None, banks=None, place_groups=None, overlap=None),
        types.SimpleNamespace(overlap="on", overlap_bucket_mb=4.0,
                              zero_prefetch=1))
    sizes = [(b.nbytes, [s for m in b.members for s in shapes[m]])
             for b in sched.buckets]
    gen = torch.Generator(device="cuda").manual_seed(9)
    res = {}
    for key, what, leaves in (
            ("zero_shard", "a rank's ZeRO blocks of every leaf",
             [s for ss in shapes.values() for s in ss]),
            ("bucket_largest", "the largest overlap bucket's ZeRO blocks",
             max(sizes)[1]),
            ("bucket_smallest", "the smallest overlap bucket's ZeRO blocks",
             min(sizes)[1])):
        a = res[key] = adam_times(gen, leaves)
        a["leaves"] = len(leaves)
        print(f"[dist] adam_update over {what} ({a['numel']} f32 "
              f"parameters in {len(leaves)} leaves, one launch): kernel "
              f"{a['ms']:.4f} ms, plain {a['plain_ms']:.4f} ms, "
              f"torch._fused_adam_ {a['library_ms']:.4f} ms, bound "
              f"{a['bound_ms']:.4f} ms (bytes); kernel/bound "
              f"{a['ms'] / a['bound_ms']:.2f}; {len(sched.buckets)} "
              f"buckets in all; {smi}")
        free_cuda()
    return res


def dist_sync_report(ranks: list, want: dict, steps: int, smi: str) -> dict:
    """Print and check DIST_SYNC_RUNS on every rank: the flash launches
    of the serial run a step, the fused Adam's ceil(leaves / 384) (ZeRO,
    the quantized sync) or one a bucket (the overlap schedule); ZeRO and
    the overlap schedule bit-equal to the serial dp-2 run (weights after
    the history, losses), the int8 quantized sync within
    ``qsync_loss_ok`` of it; the quantized all-reduce's error-feedback
    mass within its f32 rounding bound."""
    out = {}
    for name, _ in DIST_SYNC_RUNS:
        for r, res in enumerate(ranks):
            x = res["sync_" + name]
            adam = x["buckets"] if x["buckets"] else -(-x["leaves"] // 384)
            need = dict(want, adam_update=adam * steps)
            base = res["sync_" + DIST_SYNC_RUNS[0][0]]
            print(f"[dist] {name} rank {r}: step "
                  f"{np.median(x['step_ms']):.1f} ms (median of "
                  f"{len(x['step_ms'])}), peak "
                  f"{x['peak_bytes'] / 2**30:.2f} GiB, moments "
                  f"{x['moments_local_numel'] * 4 / 2**20:.1f} MiB of m "
                  f"here, {x['sync_calls']:.1f} sync collectives and "
                  f"{x['wire_bytes'] / 2**20:.2f} MiB on the wire a step, "
                  f"launches in {steps} steps {x['launches']}"
                  + (f", {x['buckets']} buckets" if x["buckets"] else "")
                  + f", losses {[round(v, 6) for v in x['losses']]}"
                  + ("" if name == DIST_SYNC_RUNS[0][0] else
                     f", against the serial run: weights max |diff| "
                     f"{x['weights_max_abs_diff']:.3e}, losses max |diff| "
                     f"{x['loss_max_abs_diff']:.3e}")
                  + (f", residual sum |r| {x['residual_abs']:.4e}"
                     if x["qsync"] else "") + f" ({smi})")
            check(x["launches"] == need,
                  f"{name} rank {r} launches {x['launches']} != {need}")
            if name in ("zero", "overlap_zero"):
                check(x["losses_equal"] and x["weights_max_abs_diff"] == 0,
                      f"{name} rank {r} is not the serial dp-2 run bit "
                      f"for bit")
            if name == "qsync_int8":
                check(x["qsync"] and x["residual_abs"] > 0,
                      f"rank {r}: the quantized sync did not run")
                check(all(qsync_loss_ok(a, b) for a, b in
                          zip(x["losses"], base["losses"])),
                      f"rank {r}: int8 losses {x['losses']} leave "
                      f"{base['losses']}'s bound")
        out[name] = {k: [res["sync_" + name][k] for res in ranks]
                     for k in ("step_ms", "peak_bytes", "sync_calls",
                               "wire_bytes", "losses")}
        out[name]["launches_per_rank"] = ranks[0]["sync_" + name]["launches"]
        out[name]["buckets"] = ranks[0]["sync_" + name]["buckets"]
    mass = [res["qsync_mass"] for res in ranks]
    for r, m in enumerate(mass):
        print(f"[dist] int8 quantized all-reduce of 2,359,296 values, rank "
              f"{r}: error-feedback mass off by {m['max_err']:.3e} at most,"
              f" f32 rounding bound {m['max_bound']:.3e}, residual sum "
              f"|r| {m['sum_abs_residual']:.4e} ({smi})")
        check(m["within"], f"rank {r}: quantized all-reduce mass {m}")
    out["qsync_mass"] = mass
    return out


def phase_dist(smi: str, spec: dict = None) -> dict:
    """BERT-base trained by two ranks sharing the card, under data
    parallelism (dp 2) and Megatron tensor parallelism (tp 2), each
    against the one-rank run of the same weights and data: the forward's
    output within SLICE_TOL, the first step's gradients at dropout 0.1
    leaf by leaf within ZOO_GRAD_TOL in f32 and DIST_BF16_GRAD_TOL in bf16
    (the ranks' dropout masks, the flash kernels' hashed at the global
    b*h, must be the one-rank run's; another draw of every mask must
    read above those limits), the
    dropout-0 loss history within TRAIN_TOL; each rank launches 12 flash
    forwards, dqs and dk/dvs and ceil(leaves / 384) fused Adams a step.
    Prints each rank's step time, peak memory and reshard bytes, and the
    backend and route of each collective. Then a one-rank NCCL world runs
    the same compile and one step."""
    import tempfile
    spec = dict(spec or DIST_SPEC)
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        with open(os.path.join(workdir, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        ref = dist_run(spec, ("--only-data-parallel",), "one_rank",
                       control=True)
        torch.save({k: ref[k] for k in ("grads", "forward", "losses")},
                   os.path.join(workdir, "ref.pt"))
        ref_s = time.perf_counter() - t0
        # what the first-step check reads where every mask is another
        # draw: it must fail there
        control = {k: dist_checked(k, grad_errs(ref["other"][k], g))
                   for k, g in ref["grads"].items()}
        for k, errs in control.items():
            print(f"[dist] first-step gradients in {k}, the one-rank run "
                  f"under another draw of every mask against itself: "
                  f"worst {errs[0][1]} {errs[0][0]:.3e}, median "
                  f"{errs[len(errs) // 2][0]:.3e} (tol "
                  f"{dist_grad_tol(k):.0e})")
            check(errs[0][0] > dist_grad_tol(k),
                  f"the {k} first-step check does not see other masks")
        out["control"] = {k: (errs[0][0], errs[len(errs) // 2][0])
                          for k, errs in control.items()}
        out["profile"] = {"one_rank": ref["profile"]}
        _ONE_RANK_REF.clear()
        _ONE_RANK_REF[json.dumps({k: v for k, v in spec.items()
                                  if k != "profile"}, sort_keys=True)] = {
            k: ref[k] for k in ("grads", "other", "forward", "losses",
                                "step_ms", "peak_bytes")}
        steps, leaves = spec["steps"], ref["leaves"]
        adam = -(-leaves // 384)
        print(f"[dist] one-rank reference: BERT-{spec['bert']} "
              f"{spec['batch']}x{spec['seq']}, {leaves} leaves, losses "
              f"{[round(v, 5) for v in ref['losses']]}, step "
              f"{np.median(ref['step_ms']):.1f} ms, peak "
              f"{ref['peak_bytes'] / 2**30:.2f} GiB, launches "
              f"{ref['launches']} ({ref_s:.1f} s) ({smi})")
        if ref["profile"]:
            p = ref["profile"]
            print(f"[dist] one-rank profile: device "
                  f"{p['device']['device_ms']:.1f} ms of "
                  f"{p['device']['wall_ms']:.1f} ms wall (busy "
                  f"{p['device']['busy']:.3f}), by family "
                  f"{p['device']['family_ms']}; host under cProfile "
                  f"{p['host_wall_ms']:.1f} ms, own time by layer "
                  f"{p['host_layers_ms']}, by stage {p['host_stages_ms']} "
                  f"({smi})")
        del ref
        free_cuda()
        t0 = time.perf_counter()
        spawn_world(workdir, "--dist-rank", 2)
        world_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        where = "on the CPU" if spec["device"] != "cuda" else \
            "sharing one card" if torch.cuda.device_count() < 2 \
            else "on a card each"
        print(f"[dist] two ranks {where}: backend {ranks[0]['backend']}, "
              f"routes {ranks[0]['routes']} ({world_s:.1f} s)")
        n_layers = spec.get("layers", 12 if spec["bert"] == "base" else 2)
        want = {"flash_attention_fwd": n_layers * steps,
                "flash_attention_bwd_dq": n_layers * steps,
                "flash_attention_bwd_dkv": n_layers * steps,
                "adam_update": adam * steps}
        for name, _ in DIST_RUNS:
            for r, res in enumerate(ranks):
                x = res[name]
                print(f"[dist] {name} rank {r}: mesh {x['mesh']}, launches "
                      f"in {steps} steps {x['launches']}, step "
                      f"{np.median(x['step_ms']):.1f} ms (median of "
                      f"{len(x['step_ms'])}), peak "
                      f"{x['peak_bytes'] / 2**30:.2f} GiB, reshard "
                      f"{x['reshard']['bytes'] / 2**20:.1f} MiB in "
                      f"{x['reshard']['redistribute']} redistributions, "
                      f"{x['reshard']['searched']} planned; against one "
                      f"rank: forward {x['forward_err']:.3e} (tol "
                      f"{SLICE_TOL:.0e}), losses {x['loss_err']:.3e} (tol "
                      f"{TRAIN_TOL:.0e})" + "".join(
                          f", first-step gradients in {k} worst " + ", ".join(
                              f"{n} {e:.3e}" for e, n in errs[:3])
                          + ("" if k == "f32" else ", checked worst "
                             + ", ".join(f"{n} {e:.3e}" for e, n in
                                         dist_checked(k, errs)[:3]))
                          + f" (tol {dist_grad_tol(k):.0e})"
                          for k, errs in x["grad_errs"].items()
                          if r == 0) + f" ({smi})")
                check(x["launches"] == want,
                      f"{name} rank {r} launches {x['launches']} != {want}")
                check(x["forward_err"] <= SLICE_TOL,
                      f"{name} rank {r} forward")
                check(x["loss_err"] <= TRAIN_TOL, f"{name} rank {r} losses")
                if r == 0:
                    for k, errs in x["grad_errs"].items():
                        check(dist_checked(k, errs)[0][0]
                              <= dist_grad_tol(k),
                              f"{name} first-step gradients in {k}")
                if x["profile"]:
                    p = x["profile"]
                    print(f"[dist] {name} rank {r} profile: device "
                          f"{p['device']['device_ms']:.1f} ms of "
                          f"{p['device']['wall_ms']:.1f} ms wall (busy "
                          f"{p['device']['busy']:.3f}), by family "
                          f"{p['device']['family_ms']}, "
                          f"{p['device']['launches']} kernels, "
                          f"{p['device']['collective_launches']} of them "
                          f"collectives; host under "
                          f"cProfile {p['host_wall_ms']:.1f} ms, own time "
                          f"by layer {p['host_layers_ms']}, by stage "
                          f"{p['host_stages_ms']} ({smi})")
            out[name] = {"launches_per_rank": ranks[0][name]["launches"],
                         "step_ms": [r[name]["step_ms"] for r in ranks],
                         "peak_bytes": [r[name]["peak_bytes"]
                                        for r in ranks],
                         "reshard_bytes": [r[name]["reshard"]["bytes"]
                                           for r in ranks],
                         "grad_worst": {
                             k: v[0][0] for k, v in
                             ranks[0][name]["grad_errs"].items()},
                         "grad_checked": {
                             k: dist_checked(k, v)[0][0] for k, v in
                             ranks[0][name]["grad_errs"].items()},
                         "profile": [r[name]["profile"] for r in ranks],
                         "forward_err": max(r[name]["forward_err"]
                                            for r in ranks),
                         "loss_err": max(r[name]["loss_err"]
                                         for r in ranks)}
        out["sync"] = dist_sync_report(ranks, want, steps, smi)
        if spec["device"] == "cuda":
            out["adam_sync_shapes"] = dist_adam_times(spec, smi)
        out["routes"] = ranks[0]["routes"]
        out["backend"] = ranks[0]["backend"]
        out["world_s"] = world_s
        if spec["device"] == "cuda":
            t0 = time.perf_counter()
            spawn_world(workdir, "--dist-nccl", 1)
            with open(os.path.join(workdir, "nccl.json")) as f:
                nccl = json.load(f)
            check(nccl["backend"] == "nccl" and np.isfinite(nccl["loss"]),
                  f"one-rank NCCL world: {nccl}")
            print(f"[dist] one-rank NCCL world: backend {nccl['backend']}, "
                  f"world {nccl['world']}, one step's loss "
                  f"{nccl['loss']:.5f} ({time.perf_counter() - t0:.1f} s)")
            out["nccl"] = nccl
    return out


# --------------------------------------------------------------------------
# pipe: BERT-base trained pp 2 by two ranks, DLRM's tables one bank over two
# --------------------------------------------------------------------------
# the pipeline schedules the two ranks run (pp 2, 4 microbatches of 2 rows),
# each against the one-rank run of the same weights and data (the dist
# phase's, where it ran in this process)
PIPE_RUNS = (("gpipe", ("--pp", "2", "--pipeline-microbatches", "4")),
             ("interleaved", ("--pp", "2", "--pipeline-microbatches", "4",
                              "--pipeline-chunks", "2")))
PIPE_MICRO = 4
# DLRM at DLRMConfig()'s width, f32, a batch of 64 (the zoo's), its four
# tables one bank over the two ranks
PIPE_DLRM_BATCH = 64
PIPE_DLRM_STEPS = 3
# the dist phase's one-rank reference, kept for the pipe phase when both
# run in one process (the same spec, weights, data and masks)
_ONE_RANK_REF: dict = {}


def plain_params(ff) -> dict:
    """The weights the one-rank (unpipelined, unbanked) model of ``ff``'s
    program starts from, on the host: each layer's WeightSpecs drawn from
    the keys (seed, 1, layer index, weight index), as
    ``Executor.init_params_and_state`` draws them on one device."""
    from flexflow_tpu_torch.dtypes import to_torch
    from flexflow_tpu_torch.ops import ensure_weight_specs
    from flexflow_tpu_torch.runtime.initializers import initialize
    ex = ff.executor
    out = {}
    for li, layer in enumerate(ex.program.layers):
        specs = ensure_weight_specs(layer)
        if specs:
            out[layer.name] = {
                sp.name: initialize(sp, (ex.seed, 1, li, wi),
                                    to_torch(sp.dtype), ex.device)
                .float().cpu().numpy() for wi, sp in enumerate(specs)}
    return out


def load_plain(ff) -> None:
    """``ff`` (pipelined or banked) from the one-rank model's weights."""
    from flexflow_tpu_torch.interop import load_reference_params
    layers = [(l.name, l.op_type) for l in ff.executor.program.layers]
    load_reference_params(ff, plain_params(ff), layers)


def per_layer_grads(ff, grads) -> dict:
    """A model's gradients on the host by the one-rank model's leaves: a
    pipeline's stacked leaves cut into their blocks' layers
    (``PipelineRegion.unstack_blocks``), a bank's into its members
    (``banks.unstack_members``)."""
    from flexflow_tpu_torch.parallel.banks import unstack_members
    ex = ff.executor
    pipe = ex.pipe
    by_name = {l.name: l for l in ex.program.layers}
    banks = {b.param_name: b for b in ex.strategy.banks} \
        if ex.strategy is not None else {}
    out = {}
    for ln, d in grads.items():
        for wn, g in d.items():
            g = ex._unplace(g).detach().float().cpu()
            if pipe is not None and ln.startswith("pp::"):
                j = [pipe.param_name(t) for t in pipe.template].index(ln)
                for names, gb in zip(pipe.stage_layer_names,
                                     pipe.unstack_blocks(g)):
                    out.setdefault(names[j], {})[wn] = gb
            elif ln in banks:
                members = banks[ln].members
                shapes = [next(w.shape for w in by_name[m].weights
                               if w.name == wn) for m in members]
                for m, gm in zip(members, unstack_members(g, shapes)):
                    out.setdefault(m, {})[wn] = gm
            else:
                out.setdefault(ln, {})[wn] = g
    return out


def pipe_bert_run(spec: dict, argv, tag: str) -> dict:
    """One pipeline schedule of PIPE_RUNS in this rank, from the one-rank
    model's weights: the first step's gradients at dropout 0.1 (f32,
    and bf16 where the run is), then at dropout 0 the forward's output on
    the first batch and a ``spec["steps"]``-step history with every
    kernel launch and the hand-off's calls and bytes counted, the peak
    memory and ``spec["timed"]`` timed steps."""
    from flexflow_tpu_torch.parallel.reshard import STATS
    cuda = spec["device"] == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    grads = {}
    for k in (("f32",) if spec["f32"] else ("f32", "bf16")):
        ff, bcfg = dist_model(dict(spec, f32=k == "f32"), argv, 0.1)
        load_plain(ff)
        xs, y = dist_data(spec, bcfg)
        batch = next(iter(ff._combined_loader(xs, y, shuffle=False)))
        g, _, _ = ff.executor._grads(ff.params, ff.state, batch, 0)
        grads[k] = per_layer_grads(ff, g)
        del ff, g, batch
        free_cuda()
    ff, bcfg = dist_model(spec, argv, 0.0)
    load_plain(ff)
    pipe = ff.executor.pipe
    xs, y = dist_data(spec, bcfg)
    first = {"input_ids": xs[0][:spec["batch"]],
             "position_ids": xs[1][:spec["batch"]]}
    forward = ff.executor.make_forward()(ff.params, ff.state, first) \
        .float().cpu()
    step_fn = ff.executor.make_train_step()
    batches = list(ff._combined_loader(xs, y, shuffle=False))
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    STATS.reset()
    hand = ff.executor._handoff
    calls0, bytes0 = hand.calls, hand.bytes
    fns = zero_counts()      # the main path: every count starts at 0 here
    plain = {n: f.plain_calls for n, f in fns.items()}
    losses = [float(ff._run_train_step(step_fn, b)["loss"])
              for b in batches]
    # (a rehearsal on the CPU counts the wrappers' plain-version calls)
    launches = {n: f.launches if cuda else f.plain_calls - plain[n]
                for n, f in fns.items()}
    p2p = {"calls": (hand.calls - calls0) / len(batches),
           "bytes": (hand.bytes - bytes0) / len(batches),
           "route": hand.route}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    times = []
    for i in range(spec["timed"]):
        sync()
        t0 = time.perf_counter()
        float(ff._run_train_step(step_fn, batches[i % len(batches)])
              ["loss"])
        sync()
        times.append(time.perf_counter() - t0)
    shapes = [tuple(t.to_local().shape) for d in ff.params.values()
              for t in d.values()]
    keys = [ln for ln, d in ff.params.items() for _ in d]
    return {"grads": grads, "forward": forward, "losses": losses,
            "launches": launches, "p2p": p2p, "peak_bytes": peak,
            "step_ms": [t * 1e3 for t in times],
            "mesh": dict(ff.dmesh.axis_sizes),
            "region": [pipe.start, pipe.end, pipe.n_stages, pipe.n_chunks,
                       pipe.n_microbatches],
            "leaf_shapes": shapes, "leaf_keys": keys,
            "reshard_bytes": STATS.bytes_total}


def published_depth(run: dict, spec: dict) -> list:
    """A pp rank's leaf shapes (``run``'s) as they are at the model's
    published depth: the region's leaves (keys ``pp::``), one set a block,
    repeated by the published layers over the run's, the others as
    they are."""
    from flexflow_tpu_torch.models import BertConfig
    full = getattr(BertConfig, spec["bert"])().num_layers
    layers = spec.get("layers", full)
    times = full // layers if full > layers and full % layers == 0 else 1
    pairs = list(zip(run["leaf_keys"], run["leaf_shapes"]))
    return [tuple(s) for k, s in pairs if not k.startswith("pp::")] + [
        tuple(s) for k, s in pairs if k.startswith("pp::")] * times


def pipe_dlrm_model(banked: bool, spec: dict):
    """DLRM at DLRMConfig()'s width (``spec["dlrm"]``: keyword overrides,
    for a rehearsal's small tables) in f32 with the fused Adam, compiled
    data parallel over this process's world and, ``banked``, with its
    tables one bank over the whole mesh (``parallel/banks.py``)."""
    device = spec["device"]
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models import DLRMConfig, build_dlrm
    from flexflow_tpu_torch.parallel.banks import (BankSpec,
                                                   choose_bank_axes,
                                                   find_bank_groups)
    from flexflow_tpu_torch.parallel.strategy import ShardingStrategy
    cfg = FFConfig()
    cfg.batch_size, cfg.seed, cfg.device = PIPE_DLRM_BATCH, 0, device
    cfg.only_data_parallel, cfg.use_bf16_compute = True, False
    cfg.kernel_impls = "opt_update:fused" if device == "cuda" else "off"
    ff = FFModel(cfg)
    dc = DLRMConfig(**spec.get("dlrm", {}))
    out = build_dlrm(ff, PIPE_DLRM_BATCH, dc)
    opt = AdamOptimizer(1e-4, epsilon=1e-4)
    ff.compile(opt, "sparse_categorical_crossentropy", [],
               output_tensor=out)
    if banked:
        # the data-parallel strategy over the compiled mesh with the
        # tables one bank (the members leave the ops' placement to it)
        st = ShardingStrategy.data_parallel(ff.layers, ff.graph_inputs,
                                            ff.dmesh)
        members = [l.name for l in find_bank_groups(ff.layers)[0]]
        bank_axes, batch_axes = choose_bank_axes(ff.dmesh, len(members))
        st.banks = [BankSpec(members, bank_axes, batch_axes=batch_axes,
                             param_name="__bank0__EMB")]
        ff.params = ff.opt_state = None
        free_cuda()
        ff.compile(opt, "sparse_categorical_crossentropy", [],
                   output_tensor=out, strategy=st)
    ff.executor._kernel_impls["opt_update"] = "fused"
    return ff, dc


def pipe_dlrm_data(dc, steps: int) -> tuple:
    rng = np.random.default_rng(23)
    rows = PIPE_DLRM_BATCH * steps
    xs = [rng.integers(0, n, (rows, dc.embedding_bag_size)).astype(np.int32)
          for n in dc.embedding_size]
    xs.append(rng.standard_normal((rows, dc.mlp_bot[0]), dtype=np.float32))
    return xs, rng.integers(0, 2, (rows, 1)).astype(np.int32)


def memory_story(snap: dict, base: int, since: int, dev: int,
                 top: int = 5) -> dict:
    """Where a process's CUDA memory on card ``dev`` went, from a snapshot
    (``torch.cuda.memory._snapshot()``) whose trace was recorded from a
    point at which ``base`` bytes were allocated: the allocations alive
    at the trace's highest point from its entry ``since`` on, and at its
    end, the largest first, each with its size and the innermost frames
    of this checkout that made it (the trace's allocations and frees
    replayed in order)."""
    live, cur, peak, at_peak = {}, 0, -1, {}
    for i, e in enumerate(snap["device_traces"][dev]):
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
        elif e["action"] in ("free_requested", "free_completed") \
                and e["addr"] in live:
            # (a block freed while another stream may still read it, as a
            # collective's is, completes its free later: dead from here)
            cur -= live.pop(e["addr"])["size"]
        if i + 1 >= since and cur > peak:
            peak, at_peak = cur, dict(live)

    def where(e) -> str:
        fr = [f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}"
              for f in e.get("frames", ())
              if f["filename"].startswith(ROOT)]
        return " <- ".join(fr[:3]) or "?"

    def largest(blocks) -> list:
        return [(e["size"], where(e)) for e in sorted(
            blocks.values(), key=lambda e: -e["size"])[:top]]
    return {"base": base, "peak": base + peak, "at_peak": largest(at_peak),
            "end": base + cur, "at_end": largest(live)}


def pipe_dlrm_run(banked: bool, spec: dict) -> dict:
    """DLRM's forward on the first batch, first-step gradients, a
    PIPE_DLRM_STEPS-step history with every launch counted and the peak
    memory, one rank's table leaves and leaf shapes. A bank's members
    start from the unbanked run's weights: their keys are the same."""
    cuda = spec["device"] == "cuda"
    # a bank rank's memory traced from before its model is built: what
    # its peak and what stays between steps are made of
    trace = cuda and banked
    if trace:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.memory._record_memory_history(max_entries=200000,
                                                 stacks="python")
    ff, dc = pipe_dlrm_model(banked, spec)
    xs, y = pipe_dlrm_data(dc, PIPE_DLRM_STEPS)
    batches = list(ff._combined_loader(xs, y, shuffle=False))
    first = {t.name: x[:PIPE_DLRM_BATCH]
             for t, x in zip(ff.graph_inputs, xs)}
    forward = ff.executor._unplace(ff.executor.make_forward()(
        ff.params, ff.state, first)).float().cpu()
    g, _, _ = ff.executor._grads(ff.params, ff.state, batches[0], 0)
    grads = per_layer_grads(ff, g)
    del g
    step_fn = ff.executor.make_train_step()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # what stays between steps (weights, Adam's moments): the peak's
    # rest is the step's own (gradients and what makes them)
    state = torch.cuda.memory_allocated() if cuda else 0
    if trace:
        dev = torch.cuda.current_device()
        since = len(torch.cuda.memory._snapshot()["device_traces"][dev])
    fns = zero_counts()      # the main path: every count starts at 0 here
    plain = {n: f.plain_calls for n, f in fns.items()}
    losses = [float(ff._run_train_step(step_fn, b)["loss"])
              for b in batches]
    launches = {n: f.launches if cuda else f.plain_calls - plain[n]
                for n, f in fns.items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    story = None
    if trace:
        torch.cuda.synchronize()
        story = memory_story(torch.cuda.memory._snapshot(), base, since,
                             dev)
        torch.cuda.memory._record_memory_history(enabled=None)
    # the tables this rank holds: its block of the bank's stacked leaf
    tables = sum(int(d["kernel"].to_local().shape[0])
                 for ln, d in ff.params.items() if ln.startswith("__bank"))
    shapes = [tuple((t.to_local() if hasattr(t, "to_local") else t).shape)
              for d in ff.params.values() for t in d.values()]
    return {"forward": forward, "grads": grads, "losses": losses,
            "launches": launches, "peak_bytes": peak, "tables": tables,
            "state_bytes": state, "memory": story,
            "leaf_shapes": shapes,
            "numel": int(sum(np.prod(s) for s in shapes))}


def pipe_rank_main(workdir: str) -> int:
    """A rank of the pipe phase (``--pipe-rank``): joins the world the
    environment names, runs each of PIPE_RUNS and the banked DLRM, holds
    each against the one-rank reference the parent saved, and writes its
    results."""
    import torch.distributed as dist
    from flexflow_tpu_torch.parallel.distributed import (ROUTES,
                                                         maybe_initialize)
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize(device_type=spec["device"])
    rank = dist.get_rank()
    ref = torch.load(os.path.join(workdir, "ref.pt"))
    out = {"backend": dist.get_backend(), "routes": dict(ROUTES)}
    for name, argv in PIPE_RUNS:
        r = pipe_bert_run(spec, argv, name)
        grads = r.pop("grads")
        r["grad_errs"] = {k: grad_errs(g, ref["grads"][k])
                          for k, g in grads.items()}
        r["forward_err"] = float((r.pop("forward")
                                  - ref["forward"]).abs().max())
        r["loss_err"] = max(abs(a - b) for a, b in zip(r["losses"],
                                                       ref["losses"]))
        out[name] = r
        free_cuda()
    d = pipe_dlrm_run(True, spec)
    dref = torch.load(os.path.join(workdir, "dlrm_ref.pt"))
    d["grad_errs"] = grad_errs(d.pop("grads"), dref["grads"])
    d["forward_err"] = float((d.pop("forward") - dref["forward"])
                             .abs().max())
    d["loss_err"] = max(abs(a - b) for a, b in zip(d["losses"],
                                                   dref["losses"]))
    out["dlrm"] = d
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_pipe(smi: str, spec: dict = None) -> dict:
    """BERT-base trained pp 2 by two ranks sharing the card, under GPipe
    and the interleaved schedule (4 microbatches of 2 rows), each against
    the one-rank run of the same weights and data (the dist phase's when
    it ran): the forward within SLICE_TOL, the first step's gradients at
    dropout 0.1 leaf by leaf within ZOO_GRAD_TOL in f32 and
    DIST_BF16_GRAD_TOL in bf16 (the key biases out; another draw of
    every mask must read above them), the dropout-0 history within
    TRAIN_TOL; each rank launches 24 flash forwards, dqs and dk/dvs (its
    6 blocks x 4 microbatches, no bubble slot) and one fused Adam a step.
    Then DLRM at DLRMConfig()'s width, its four tables one bank over the
    two ranks, against the one-rank unbanked run: forward and first-step
    gradients within the zoo's tolerances, 2 of 4 tables a rank, one
    fused Adam a step. Prints each rank's step time, peak memory and
    point-to-point calls and bytes a step, and times the kernels at the
    shapes these paths give them."""
    import tempfile
    spec = dict(spec or DIST_SPEC)
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        with open(os.path.join(workdir, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        ref = _ONE_RANK_REF.get(json.dumps(spec, sort_keys=True))
        if ref is None:
            ref = dist_run(spec, ("--only-data-parallel",), "one_rank",
                           control=True)
            ref = {k: ref[k] for k in ("grads", "other", "forward",
                                       "losses", "step_ms", "peak_bytes")}
            print(f"[pipe] one-rank reference run here "
                  f"({time.perf_counter() - t0:.1f} s)")
        else:
            print("[pipe] one-rank reference: the dist phase's")
        torch.save({k: ref[k] for k in ("grads", "forward", "losses")},
                   os.path.join(workdir, "ref.pt"))
        control = {k: dist_checked(k, grad_errs(ref["other"][k], g))
                   for k, g in ref["grads"].items()}
        for k, errs in control.items():
            check(errs[0][0] > dist_grad_tol(k),
                  f"the {k} first-step check does not see other masks")
        out["control"] = {k: errs[0][0] for k, errs in control.items()}
        one_rank_ms = float(np.median(ref["step_ms"]))
        one_rank_peak = ref["peak_bytes"]
        del ref
        free_cuda()
        t0 = time.perf_counter()
        d = pipe_dlrm_run(False, spec)
        torch.save({k: d[k] for k in ("grads", "forward", "losses")},
                   os.path.join(workdir, "dlrm_ref.pt"))
        dlrm_ref = {k: d[k] for k in ("peak_bytes", "numel", "losses",
                                      "state_bytes")}
        print(f"[pipe] DLRM one-rank reference: {d['numel']} parameters, "
              f"losses {[round(v, 5) for v in d['losses']]}, peak "
              f"{d['peak_bytes'] / 2**30:.3f} GiB (between steps "
              f"{d['state_bytes'] / 2**30:.3f}), launches "
              f"{d['launches']} ({time.perf_counter() - t0:.1f} s) "
              f"({smi})")
        del d
        free_cuda()
        t0 = time.perf_counter()
        spawn_world(workdir, "--pipe-rank", 2)
        world_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    steps = spec["steps"]
    n_layers = spec.get("layers", 12 if spec["bert"] == "base" else 2)
    per_rank = n_layers // 2 * PIPE_MICRO
    want = {"flash_attention_fwd": per_rank * steps,
            "flash_attention_bwd_dq": per_rank * steps,
            "flash_attention_bwd_dkv": per_rank * steps,
            "adam_update": steps}
    where = "on the CPU" if spec["device"] != "cuda" else \
        "sharing one card" if torch.cuda.device_count() < 2 \
        else "on a card each"
    print(f"[pipe] two ranks {where}: backend "
          f"{ranks[0]['backend']}, hand-off route "
          f"{ranks[0]['gpipe']['p2p']['route']} ({world_s:.1f} s)")
    for name, _ in PIPE_RUNS:
        for r, res in enumerate(ranks):
            x = res[name]
            print(f"[pipe] {name} rank {r}: mesh {x['mesh']}, region "
                  f"{x['region']}, launches in {steps} steps "
                  f"{x['launches']}, step {np.median(x['step_ms']):.1f} ms "
                  f"(median of {len(x['step_ms'])}; one rank alone "
                  f"{one_rank_ms:.1f} ms), peak "
                  f"{x['peak_bytes'] / 2**30:.2f} GiB (one rank "
                  f"{one_rank_peak / 2**30:.2f} GiB), point-to-point "
                  f"{x['p2p']['calls']:.0f} sends, "
                  f"{x['p2p']['bytes'] / 1e6:.2f} MB a step, reshard "
                  f"{x['reshard_bytes'] / 2**20:.1f} MiB; against one rank: "
                  f"forward {x['forward_err']:.3e} (tol {SLICE_TOL:.0e}), "
                  f"losses {x['loss_err']:.3e} (tol {TRAIN_TOL:.0e})"
                  + "".join(
                      f", first-step gradients in {k} worst " + ", ".join(
                          f"{n} {e:.3e}" for e, n in errs[:3])
                      + ("" if k == "f32" else ", checked worst "
                         + ", ".join(f"{n} {e:.3e}" for e, n in
                                     dist_checked(k, errs)[:3]))
                      + f" (tol {dist_grad_tol(k):.0e})"
                      for k, errs in x["grad_errs"].items())
                  + f" ({smi})")
            check(x["launches"] == want,
                  f"{name} rank {r} launches {x['launches']} != {want}")
            check(x["forward_err"] <= SLICE_TOL, f"{name} rank {r} forward")
            check(x["loss_err"] <= TRAIN_TOL, f"{name} rank {r} losses")
            for k, errs in x["grad_errs"].items():
                check(dist_checked(k, errs)[0][0] <= dist_grad_tol(k),
                      f"{name} rank {r} first-step gradients in {k}")
        out[name] = {"launches_per_rank": ranks[0][name]["launches"],
                     "step_ms": [r[name]["step_ms"] for r in ranks],
                     "peak_bytes": [r[name]["peak_bytes"] for r in ranks],
                     "p2p": [r[name]["p2p"] for r in ranks],
                     "forward_err": max(r[name]["forward_err"]
                                        for r in ranks),
                     "loss_err": max(r[name]["loss_err"] for r in ranks),
                     "grad_checked": {
                         k: max(dist_checked(k, r[name]["grad_errs"][k])
                                [0][0] for r in ranks)
                         for k in ranks[0][name]["grad_errs"]}}
    for r, res in enumerate(ranks):
        x = res["dlrm"]
        print(f"[pipe] DLRM banked, rank {r}: {x['tables']} of 4 tables, "
              f"{x['numel']} parameters (one rank {dlrm_ref['numel']}), "
              f"launches in {PIPE_DLRM_STEPS} steps {x['launches']}, peak "
              f"{x['peak_bytes'] / 2**30:.3f} GiB, between steps "
              f"{x['state_bytes'] / 2**30:.3f} (one rank "
              f"{dlrm_ref['peak_bytes'] / 2**30:.3f} GiB, between steps "
              f"{dlrm_ref['state_bytes'] / 2**30:.3f}); against one "
              f"rank: forward {x['forward_err']:.3e} (tol "
              f"{SLICE_TOL:.0e}), losses {x['loss_err']:.3e} (tol "
              f"{TRAIN_TOL:.0e}), first-step gradients worst "
              + ", ".join(f"{n} {e:.3e}" for e, n in x["grad_errs"][:3])
              + f" (tol {ZOO_GRAD_TOL:.0e}) ({smi})")
        m = x["memory"]
        if m is not None:
            for when, key in (("at its peak", "at_peak"),
                              ("between steps", "at_end")):
                print(f"[pipe] DLRM banked, rank {r}, {when} "
                      f"({m['peak' if key == 'at_peak' else 'end'] / 2**30:.3f}"
                      f" GiB; {m['base'] / 2**30:.3f} before the model), "
                      f"the largest allocations: " + "; ".join(
                          f"{n / 2**20:.1f} MiB {w}" for n, w in m[key]))
        check(x["tables"] == 2, f"DLRM rank {r} holds {x['tables']} tables")
        check(x["launches"]["adam_update"] == PIPE_DLRM_STEPS,
              f"DLRM rank {r} launches {x['launches']}")
        check(x["forward_err"] <= SLICE_TOL, f"DLRM rank {r} forward")
        check(x["loss_err"] <= TRAIN_TOL, f"DLRM rank {r} losses")
        check(x["grad_errs"][0][0] <= ZOO_GRAD_TOL,
              f"DLRM rank {r} first-step gradients")
    out["dlrm"] = {"launches_per_rank": ranks[0]["dlrm"]["launches"],
                   "peak_bytes": [r["dlrm"]["peak_bytes"] for r in ranks],
                   "state_bytes": [r["dlrm"]["state_bytes"] for r in ranks],
                   "one_rank_peak_bytes": dlrm_ref["peak_bytes"],
                   "one_rank_state_bytes": dlrm_ref["state_bytes"],
                   "numel": [r["dlrm"]["numel"] for r in ranks],
                   "grad_worst": max(r["dlrm"]["grad_errs"][0][0]
                                     for r in ranks)}
    out["world_s"] = world_s
    if spec["device"] != "cuda":
        return out
    # the kernels at the shapes these paths give them
    gen = torch.Generator(device="cuda").manual_seed(11)
    out["fwd_b2"] = fwd_times(spec["seq"], 0.0, gen, b=2)
    out["bwd_b2"] = bwd_times(spec["seq"], 0.0, gen, b=2)
    f, bw = out["fwd_b2"], out["bwd_b2"]
    print(f"[pipe] flash at a microbatch, b2 h12 s{spec['seq']} d64 bf16: "
          f"forward {f['ms']:.4f} ms (plain {f['plain_ms']:.4f}, SDPA "
          f"{f['library_ms']:.4f} on {f['library_backend']}, bound "
          f"{f['bound_ms']:.4f} "
          f"{f['bound_by']}), dq {bw['dq_ms']:.4f} ms (plain "
          f"{bw['dq_plain_ms']:.4f}, bound {bw['dq_bound'][0]:.4f}), dk/dv "
          f"{bw['dkv_ms']:.4f} ms (plain {bw['dkv_plain_ms']:.4f}, bound "
          f"{bw['dkv_bound'][0]:.4f}), SDPA's whole backward "
          f"{bw['sdpa_bwd_ms']:.4f} ms ({smi})")
    free_cuda()
    for key, what, shapes in (
            ("adam_pp_rank", "a pp 2 rank's leaves of BERT-base (stage 0) "
             "at its published depth", published_depth(
                 ranks[0]["gpipe"], spec)),
            ("adam_bank_rank", "a bank rank's DLRM leaves (2 of 4 tables "
             "and the MLPs)", ranks[0]["dlrm"]["leaf_shapes"])):
        a = out[key] = adam_times(gen, [tuple(s) for s in shapes])
        a["leaves"] = len(shapes)
        print(f"[pipe] adam_update over {what}: {a['numel']} f32 "
              f"parameters in {len(shapes)} leaves, one launch: kernel "
              f"{a['ms']:.4f} ms, plain {a['plain_ms']:.4f} ms, "
              f"torch._fused_adam_ {a['library_ms']:.4f} ms, bound "
              f"{a['bound_ms']:.4f} ms (bytes) ({smi})")
        free_cuda()
    return out


# --------------------------------------------------------------------------
# seq: sequence parallelism over two ranks sharing the card
# --------------------------------------------------------------------------
# (a) the functions: ring and Ulysses attention of a whole (b, h, s, d)
# sequence, each of the two ranks holding s / 2, against the plain
# attention of the whole sequence on one rank, as a share of the
# reference's largest magnitude (the dist phase's bounds)
SEQ_FN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (b) full-width GPT-2 small (GPTConfig(): 12 layers, hidden 768, 12
# heads, vocab 50257, 1024 positions, dropout 0) at 8 x 1024, trained sp
# 2 under attention:ring with the fused Adam, bf16 and --f32-compute,
# first-step gradients and a 3-step history against the one-rank run of
# the same weights under attention:xla, then 2 timed steps; (c) the JAX
# bench's long-context geometry (bench.py stage_long_context: one MHA,
# B4 S2048 E512 H8) at seq 2 under the kernel tier
SEQ_SPEC = {"device": "cuda", "fn_shape": (4, 12, 1024, 64), "batch": 8,
            "seq": 1024, "steps": 3, "timed": 2, "gpt": {"num_layers": 4},
            "long": {"batch": 4, "seq": 2048, "embed": 512, "heads": 8,
                     "steps": 3}}


def seq_checked(errs: list) -> list:
    """The leaves of ``errs`` held to the sp 2 run's first-step limit: all
    but the key biases, in either type. Their true gradient is 0 (softmax
    ignores a shift common to a row's scores), so their reading is each
    path's rounding noise over GRAD_FLOOR of the whole gradient, and the
    ring's noise is not the plain attention's (another order of sums)."""
    return [e for e in errs if not e[1].endswith(".bk")]


def seq_mesh(spec: dict):
    """The (1, 2) mesh of this world's two ranks whose trailing dim is
    ``seq``, as ``--seq-parallel 2`` builds it."""
    from flexflow_tpu_torch.parallel.distributed import rank_device
    from flexflow_tpu_torch.parallel.machine import DeviceMesh, MachineSpec
    dev = rank_device(spec["device"])
    gen = "h100" if spec["device"] == "cuda" else "cpu-sim"
    return DeviceMesh(MachineSpec(num_devices=2, generation=gen),
                      devices=[dev, dev], seq=2)


def seq_fn_checks(spec: dict) -> dict:
    """(a) in this rank: ring_attention and ulysses_attention on its half
    of a seeded whole sequence (the same on every rank), causal and not,
    f32 and bf16: the output and the q, k, v gradients of a seeded
    cotangent against mha_reference of the whole sequence with autograd,
    the flash launches (plain-version calls on the CPU) and the ring's
    hops and bytes of each call, and the median of 3 timed forward +
    backward calls."""
    from flexflow_tpu_torch.kernels.flash_attention import mha_reference
    from flexflow_tpu_torch.kernels.ring_attention import (
        ring_attention, ulysses_attention)
    cuda = spec["device"] == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    seq = seq_mesh(spec).seq_group()
    b, h, s, d = spec["fn_shape"]
    c = s // seq.size
    cut = slice(seq.index * c, (seq.index + 1) * c)
    gen = torch.Generator(device=dev).manual_seed(31)
    flash = {n: f for n, f in counters().items() if n != "adam_update"}
    out = {}
    for name, fn in (("ring", ring_attention),
                     ("ulysses", ulysses_attention)):
        for causal in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                q, k, v, do = (torch.randn(b, h, s, d, device=dev,
                                           generator=gen).to(dt)
                               for _ in range(4))
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                ref = mha_reference(*leaves, causal=causal)
                want = [ref] + list(torch.autograd.grad(ref, leaves, do))
                loc = [t[:, :, cut].contiguous().requires_grad_()
                       for t in (q, k, v)]
                dloc = do[:, :, cut].contiguous()
                n0 = {n: f.launches if cuda else f.plain_calls
                      for n, f in flash.items()}
                h0, b0 = seq.hops, seq.bytes
                o = fn(*loc, seq, causal=causal)
                got = [o] + list(torch.autograd.grad(o, loc, dloc))
                sync()
                launches = {n: (f.launches if cuda else f.plain_calls)
                            - n0[n] for n, f in flash.items()}
                hops = (seq.hops - h0, seq.bytes - b0)
                errs = {}
                for key, g, w in zip(("o", "dq", "dk", "dv"), got, want):
                    w = w[:, :, cut].float()
                    errs[key] = (g.float() - w).abs().max().item() / max(
                        w.abs().max().item(), 1e-30)
                times = []
                for _ in range(3):
                    sync()
                    t0 = time.perf_counter()
                    o = fn(*loc, seq, causal=causal)
                    torch.autograd.grad(o, loc, dloc)
                    sync()
                    times.append((time.perf_counter() - t0) * 1e3)
                key = f"{name}_{'causal' if causal else 'full'}_" \
                    f"{str(dt)[6:]}"
                out[key] = {"errs": errs, "launches": launches,
                            "hops": hops, "ms": float(np.median(times)),
                            "tol": SEQ_FN_TOL[str(dt)[6:]]}
                del q, k, v, do, leaves, ref, want, loc, dloc, o, got
    return out


def seq_gpt_model(spec: dict, f32: bool, impl: str, argv=()):
    """GPT-2 of ``spec["gpt"]`` (GPTConfig overrides; none: GPT-2 small)
    at spec's batch and sequence under ``attention:<impl>`` with the
    fused Adam, data parallel over this process's world (none where it
    has a seq axis only), compiled under ``argv``."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models import GPTConfig, build_gpt2
    cfg = FFConfig.parse_args(list(argv))
    cfg.batch_size, cfg.seed, cfg.device = spec["batch"], 0, spec["device"]
    cfg.only_data_parallel = True
    # (the fused Adam's predicate refuses the CPU: a rehearsal there sets
    # the plan after the compile, and the kernel's plain version runs)
    cfg.kernel_impls = f"attention:{impl}" + (
        ",opt_update:fused" if spec["device"] == "cuda" else "")
    cfg.use_bf16_compute = not f32
    ff = FFModel(cfg)
    g = GPTConfig(**spec["gpt"])
    out = build_gpt2(ff, spec["batch"], spec["seq"], g)
    ff.compile(AdamOptimizer(1e-4), "sparse_categorical_crossentropy", [],
               output_tensor=out)
    ff.executor._kernel_impls["opt_update"] = "fused"
    return ff, g


def seq_gpt_batches(spec: dict, vocab: int) -> list:
    """``spec["steps"]`` seeded batches of ids, positions and next-token
    labels (the ids)."""
    rng = np.random.default_rng(23)
    b, s = spec["batch"], spec["seq"]
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    out = []
    for _ in range(spec["steps"]):
        ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
        out.append({"input_ids": ids, "position_ids": pos, "label": ids})
    return out


def seq_gpt_run(spec: dict, f32: bool, impl: str, argv=(),
                grads: bool = True) -> dict:
    """GPT-2 of ``spec`` in this process's world: the first step's
    gradients (whole, on the host), then a ``spec["steps"]``-step history
    with every kernel launch counted (the counts set to 0 just before)
    and the ring's hops and bytes, the peak memory and ``spec["timed"]``
    timed steps."""
    cuda = spec["device"] == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ff, g = seq_gpt_model(spec, f32, impl, argv)
    ex = ff.executor
    batches = seq_gpt_batches(spec, g.vocab_size)
    host = None
    if grads:
        gr, _, _ = ex._grads(ff.params, ff.state, batches[0], 0)
        host = {ln: {n: ex._unplace(t).detach().float().cpu()
                     for n, t in d.items()} for ln, d in gr.items()}
        del gr
    step_fn = ex.make_train_step()
    ring = ex._seq_ring
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    h0, b0 = (ring.hops, ring.bytes) if ring is not None else (0, 0)
    fns = zero_counts()      # the main path: every count starts at 0 here
    plain = {n: f.plain_calls for n, f in fns.items()}
    losses = [float(ff._run_train_step(step_fn, b)["loss"])
              for b in batches]
    # (a rehearsal on the CPU counts the wrappers' plain-version calls)
    launches = {n: f.launches if cuda else f.plain_calls - plain[n]
                for n, f in fns.items()}
    n = len(batches)
    hops = None if ring is None else {
        "hops": (ring.hops - h0) / n, "bytes": (ring.bytes - b0) / n,
        "route": ring.handoff.route}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    times = []
    for i in range(spec["timed"]):
        sync()
        t0 = time.perf_counter()
        float(ff._run_train_step(step_fn, batches[i % n])["loss"])
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    shapes = [tuple(ex._unplace(t).shape) for d in ff.params.values()
              for t in d.values()]
    res = {"grads": host, "losses": losses, "launches": launches,
           "hops": hops, "peak_bytes": peak, "step_ms": times,
           "mesh": dict(ff.dmesh.axis_sizes), "leaf_shapes": shapes,
           "plan": sorted(set(ex._kernel_impls.values()))}
    del ff, ex, step_fn
    free_cuda()
    return res


def seq_long_context(spec: dict) -> dict:
    """(c) in this rank: the long-context MHA of ``spec["long"]`` compiled
    at seq 2 with the measured kernel tier (``calibration_v2``: the
    collective and hop rows over the world and the impl rows, ring's
    over the seq group, measured or read from the table), the tier's
    choice, then under forced ring and forced flash: each one's
    predicted step of the attention op (the kernel record) and its
    measured train step (min of ``steps`` after a warm-up)."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.search.calibration import CalibrationTable
    L = spec["long"]
    cuda = spec["device"] == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rng = np.random.default_rng(0)
    shape = (L["batch"], L["seq"], L["embed"])
    batch = {"q": rng.standard_normal(shape).astype(np.float32),
             "label": rng.standard_normal(shape).astype(np.float32)}
    out = {}
    for tag, impls in (("tier", "auto"), ("ring", "attention:ring"),
                       ("flash", "attention:flash")):
        cfg = FFConfig.parse_args(["--seq-parallel", "2"])
        cfg.batch_size, cfg.seed, cfg.device = L["batch"], 0, \
            spec["device"]
        cfg.only_data_parallel, cfg.calibration_v2 = True, "true"
        cfg.kernel_impls = impls
        ff = FFModel(cfg)
        q = ff.create_tensor(shape, name="q")
        ff.multihead_attention(q, q, q, embed_dim=L["embed"],
                               num_heads=L["heads"])
        t0 = time.perf_counter()
        ff.compile(SGDOptimizer(0.01), "mean_squared_error", [])
        compile_s = time.perf_counter() - t0
        op = next(o for o in ff._kernel_record["ops"]
                  if o["op"] == "attention")
        step_fn = ff.executor.make_train_step()
        float(ff._run_train_step(step_fn, batch)["loss"])
        times = []
        for _ in range(L["steps"]):
            sync()
            t0 = time.perf_counter()
            float(ff._run_train_step(step_fn, batch)["loss"])
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        out[tag] = {"impl": op["impl"], "predicted_ms":
                    op["predicted_s"] * 1e3, "step_ms": min(times),
                    "compile_s": compile_s}
        del ff, step_fn
        free_cuda()
    rows = CalibrationTable()._load()
    out["rows"] = {k: v for k, v in sorted(rows.items())
                   if "@ring" in k or "ppermute" in k}
    return out


def seq_rank_main(workdir: str) -> int:
    """A rank of the seq phase (``--seq-rank``): joins the world the
    environment names, runs (a), (b) against the one-rank references the
    parent saved, and (c), and writes its results."""
    import torch.distributed as dist
    from flexflow_tpu_torch.parallel.distributed import (ROUTES,
                                                         maybe_initialize)
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize(device_type=spec["device"])
    rank = dist.get_rank()
    out = {"backend": dist.get_backend(), "routes": dict(ROUTES)}
    t0 = time.perf_counter()
    out["fns"] = seq_fn_checks(spec)
    out["fns_s"] = time.perf_counter() - t0
    ref = torch.load(os.path.join(workdir, "ref.pt"))
    for k in ("f32", "bf16"):
        t0 = time.perf_counter()
        r = seq_gpt_run(spec, k == "f32", "ring", ("--seq-parallel", "2"))
        r["grad_errs"] = grad_errs(r.pop("grads"), ref[k]["grads"])
        r["loss_err"] = max(abs(a - b) for a, b in zip(r["losses"],
                                                       ref[k]["losses"]))
        r["wall_s"] = time.perf_counter() - t0
        out["gpt_" + k] = r
    del ref
    t0 = time.perf_counter()
    out["long"] = seq_long_context(spec)
    out["long_s"] = time.perf_counter() - t0
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def adam_identical(gen, shapes) -> int:
    """The fused Adam kernel against its plain version over f32 leaves of
    ``shapes`` in one launch: the count of elements of w, m and v that
    differ (0: bit-identical, as both round every f32 op once)."""
    from flexflow_tpu_torch.kernels.opt_update import (
        fused_adam_update, fused_adam_update_plain)
    leaves = adam_leaves(gen, shapes, [torch.float32] * len(shapes))
    alpha_t = torch.tensor(1e-4, device="cuda")
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=0.0)
    want = [fused_adam_update_plain(w, g, m, v, alpha_t, **kw)
            for w, g, m, v in leaves]
    fused_adam_update(*([x[i] for x in leaves] for i in range(4)),
                      alpha_t, **kw)
    torch.cuda.synchronize()
    return sum(int((got != ref).sum().item())
               for (w, _, m, v), refs in zip(leaves, want)
               for got, ref in zip((w, m, v), refs))


def phase_seq(smi: str, spec: dict = None) -> dict:
    """Sequence parallelism by two ranks sharing the card (gloo; a card
    each and NCCL on a host with four cards): (a) ring and Ulysses
    attention at ``spec["fn_shape"]`` (b4 h12 s1024 d64), causal and
    not, f32 and bf16, each rank holding s / 2, against the plain
    attention of the whole sequence within SEQ_FN_TOL, Ulysses launching
    one flash forward, dq and dk/dv a call a rank and the ring none, with
    N - 1 = 1 hop of (k, v) forward and N = 2 hops backward; (b)
    full-width GPT-2 small at 8 x 1024 trained sp 2 under attention:ring
    in bf16 and f32, every leaf's first-step gradient (the key biases out,
    ``seq_checked``) within DIST_BF16_GRAD_TOL (bf16) or ZOO_GRAD_TOL
    (f32) and the 3-step history within TRAIN_TOL of the one-rank run of the
    same weights under attention:xla, one fused Adam a step a rank, 3
    hops a layer a step; one rank's step under flash and under xla
    beside it; (c) the long-context MHA at seq 2 under the kernel tier:
    the ring and hop rows, the adopted impl, ring's and forced flash's
    predicted and measured steps (not gated). Then the kernels at the
    shapes these paths give them."""
    import tempfile
    spec = dict(spec or SEQ_SPEC)
    cuda = spec["device"] == "cuda"
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        with open(os.path.join(workdir, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        ref = {}
        for k in ("f32", "bf16"):
            ref[k] = seq_gpt_run(spec, k == "f32", "xla")
            out["one_rank_xla_" + k] = {
                key: ref[k][key] for key in ("step_ms", "peak_bytes",
                                             "launches", "losses")}
            out["one_rank_flash_" + k] = {
                key: v for key, v in seq_gpt_run(
                    spec, k == "f32", "flash", grads=False).items()
                if key in ("step_ms", "peak_bytes", "launches", "losses")}
        torch.save({k: {"grads": r["grads"], "losses": r["losses"]}
                    for k, r in ref.items()},
                   os.path.join(workdir, "ref.pt"))
        del ref
        free_cuda()
        out["one_rank_s"] = time.perf_counter() - t0
        print(f"[seq] one-rank GPT-2 runs under xla and flash "
              f"({out['one_rank_s']:.1f} s)")
        # the cache of the ranks' calibration table: (c) measures every
        # row once, then reads it warm
        os.environ["FF_CACHE_DIR"] = os.path.join(workdir, "cache")
        t0 = time.perf_counter()
        try:
            spawn_world(workdir, "--seq-rank", 2)
        finally:
            del os.environ["FF_CACHE_DIR"]
        out["world_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    where = "on the CPU" if not cuda else \
        "sharing one card" if torch.cuda.device_count() < 2 \
        else "on a card each"
    print(f"[seq] two ranks {where}: backend {ranks[0]['backend']} "
          f"({out['world_s']:.1f} s; functions {ranks[0]['fns_s']:.1f} s, "
          f"long context {ranks[0]['long_s']:.1f} s)")
    b, h, s, d = spec["fn_shape"]
    chunk = b * h * (s // 2) * d
    for r, res in enumerate(ranks):
        for key, x in res["fns"].items():
            fn, _, dt = key.split("_")
            isz = 4 if dt == "float32" else 2
            if fn == "ring":
                want_l = {n: 0 for n in x["launches"]}
                want_h = [1 + 2, 2 * chunk * isz + 2 * chunk * isz
                          + 4 * chunk * 4]
            else:
                want_l = {n: 1 for n in x["launches"]}
                want_h = [0, 0]
            worst = max(x["errs"].values())
            print(f"[seq] {key} rank {r}: b{b} h{h} s{s} (s/2 a rank) d{d}"
                  f": worst of o, dq, dk, dv against the whole sequence's "
                  f"plain attention " + ", ".join(
                      f"{n} {e:.2e}" for n, e in x["errs"].items())
                  + f" of max (tol {x['tol']:.0e}), flash launches "
                  f"{x['launches']}, ring hops {x['hops'][0]} carrying "
                  f"{x['hops'][1] / 2**20:.2f} MiB, forward + backward "
                  f"{x['ms']:.2f} ms ({smi})")
            check(worst <= x["tol"], f"seq {key} rank {r}: {x['errs']}")
            check(x["launches"] == want_l,
                  f"seq {key} rank {r} launches {x['launches']}")
            check(list(x["hops"]) == want_h,
                  f"seq {key} rank {r} hops {x['hops']} != {want_h}")
    g = spec["gpt"]
    layers = g.get("num_layers", 12)
    for k in ("f32", "bf16"):
        one = out["one_rank_xla_" + k]
        fl = out["one_rank_flash_" + k]
        tol = dist_grad_tol(k)
        for r, res in enumerate(ranks):
            x = res["gpt_" + k]
            checked = seq_checked([tuple(e) for e in x["grad_errs"]])
            print(f"[seq] GPT-2 sp 2 {k} rank {r}: mesh {x['mesh']}, plan "
                  f"{x['plan']}, launches in {spec['steps']} steps "
                  f"{x['launches']}, ring hops {x['hops']['hops']:.0f} and "
                  f"{x['hops']['bytes'] / 2**20:.1f} MiB a step (route "
                  f"{x['hops']['route']}), step "
                  f"{np.median(x['step_ms']):.1f} ms (median of "
                  f"{len(x['step_ms'])}; one rank alone: xla "
                  f"{np.median(one['step_ms']):.1f} ms, flash "
                  f"{np.median(fl['step_ms']):.1f} ms), peak "
                  f"{x['peak_bytes'] / 2**30:.2f} GiB (one rank xla "
                  f"{one['peak_bytes'] / 2**30:.2f}, flash "
                  f"{fl['peak_bytes'] / 2**30:.2f} GiB); against the "
                  f"one-rank xla run: losses {x['loss_err']:.3e} (tol "
                  f"{TRAIN_TOL:.0e}), first-step gradients worst "
                  + ", ".join(f"{n} {e:.3e}" for e, n in x["grad_errs"][:3])
                  + ", checked worst " + ", ".join(
                      f"{n} {e:.3e}" for e, n in checked[:3])
                  + f" (tol {tol:.0e}) ({x['wall_s']:.1f} s) ({smi})")
            want = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                    "flash_attention_bwd_dkv": 0,
                    "adam_update": spec["steps"]}
            check(x["launches"] == want,
                  f"seq GPT-2 {k} rank {r} launches {x['launches']}")
            check(x["hops"]["hops"] == 3 * layers,
                  f"seq GPT-2 {k} rank {r} hops {x['hops']}")
            check(x["loss_err"] <= TRAIN_TOL, f"seq GPT-2 {k} rank {r} "
                  f"losses")
            check(checked[0][0] <= tol,
                  f"seq GPT-2 {k} rank {r} first-step gradients")
            check(all(np.isfinite(x["losses"])), "seq GPT-2 losses")
        out["gpt_" + k] = {
            key: [rk["gpt_" + k][key] for rk in ranks]
            for key in ("launches", "hops", "step_ms", "peak_bytes",
                        "loss_err", "losses")}
        out["gpt_" + k]["grad_checked"] = max(
            seq_checked([tuple(e) for e in rk["gpt_" + k]["grad_errs"]])
            [0][0] for rk in ranks)
    long = ranks[0]["long"]
    print(f"[seq] long-context MHA B{spec['long']['batch']} "
          f"S{spec['long']['seq']} E{spec['long']['embed']} "
          f"H{spec['long']['heads']} at seq 2: the kernel tier adopts "
          f"{long['tier']['impl']}; ring predicted "
          f"{long['ring']['predicted_ms']:.3f} ms, measured step "
          f"{long['ring']['step_ms']:.1f} ms; forced flash predicted "
          f"{long['flash']['predicted_ms']:.3f} ms, measured step "
          f"{long['flash']['step_ms']:.1f} ms (rank 0, min of "
          f"{spec['long']['steps']}; rank 1: ring "
          f"{ranks[1]['long']['ring']['step_ms']:.1f}, flash "
          f"{ranks[1]['long']['flash']['step_ms']:.1f} ms) ({smi})")
    print("[seq] ring calibration rows: " + ", ".join(
        f"{k} = {v:.3e}" for k, v in long["rows"].items()))
    check(any("op_attention@ring" in k for k in long["rows"])
          and any("coll_ppermute" in k for k in long["rows"]),
          f"seq: no ring or hop rows in {sorted(long['rows'])}")
    out["long"] = long
    out["fns"] = {key: {"ms": [rk["fns"][key]["ms"] for rk in ranks],
                        "launches": ranks[0]["fns"][key]["launches"],
                        "errs": ranks[0]["fns"][key]["errs"]}
                  for key in ranks[0]["fns"]}
    if not cuda:
        return out
    # the kernels at the shapes these paths give them: Ulysses' launches
    # (h / 2 heads over the whole sequence) and the fused Adam over a
    # rank's leaves (GPT-2 small, all of them: nothing shards over seq)
    gen = torch.Generator(device="cuda").manual_seed(13)
    out["fwd_ulysses"] = fwd_times(s, 0.0, gen, causal=True, b=b, h=h // 2,
                                   d=d)
    out["bwd_ulysses"] = bwd_times(s, 0.0, gen, causal=True, b=b, h=h // 2,
                                   d=d)
    f, bw = out["fwd_ulysses"], out["bwd_ulysses"]
    print(f"[seq] flash at Ulysses' launch, b{b} h{h // 2} s{s} d{d} bf16 "
          f"causal: forward {f['ms']:.4f} ms (plain {f['plain_ms']:.4f}, "
          f"SDPA {f['library_ms']:.4f} on {f['library_backend']}, bound "
          f"{f['bound_ms']:.4f} {f['bound_by']}), dq {bw['dq_ms']:.4f} ms "
          f"(plain {bw['dq_plain_ms']:.4f}, bound {bw['dq_bound'][0]:.4f}),"
          f" dk/dv {bw['dkv_ms']:.4f} ms (plain {bw['dkv_plain_ms']:.4f}, "
          f"bound {bw['dkv_bound'][0]:.4f}), SDPA's whole backward "
          f"{bw['sdpa_bwd_ms']:.4f} ms ({smi})")
    free_cuda()
    # every leaf of GPT-2 small at its published depth (an sp rank holds
    # every leaf whole; the runs above cut the depth)
    from flexflow_tpu_torch.models import GPTConfig, build_gpt2
    shapes = leaf_shapes(lambda f: build_gpt2(f, spec["batch"], spec["seq"],
                                              GPTConfig(**dict(
                                                  spec["gpt"],
                                                  num_layers=GPT_LAYERS))))
    differing = adam_identical(gen, shapes)
    print(f"[seq] adam_update over an sp 2 rank's GPT-2 small leaves "
          f"({len(shapes)} leaves, one launch): {differing} elements "
          f"differ from the plain version (want bit-identical)")
    check(differing == 0, "seq: fused Adam over GPT-2's leaves")
    free_cuda()
    a = out["adam_sp_rank"] = adam_times(gen, shapes)
    a["leaves"] = len(shapes)
    print(f"[seq] adam_update over an sp 2 rank's GPT-2 small leaves: "
          f"{a['numel']} f32 parameters in {len(shapes)} leaves, one "
          f"launch: kernel {a['ms']:.4f} ms, plain {a['plain_ms']:.4f} ms, "
          f"torch._fused_adam_ {a['library_ms']:.4f} ms, bound "
          f"{a['bound_ms']:.4f} ms (bytes) ({smi})")
    free_cuda()
    return out


# --------------------------------------------------------------------------
# genworld: GPT-2 small generating over two ranks sharing the card
# --------------------------------------------------------------------------
# full-width GPT-2 small (GPTConfig(): 12 layers, hidden 768, 12 heads,
# vocab 50257, 1024 positions) at 8 x 1024, bf16, attention:flash, the
# generate phase's seeded weights and prompts: under the tp 2 preset
# greedy 8 x 512 + 64, ragged 100 / 517 / 900 with and without eos,
# sampling (T 0.8, top-k 50, top-p 0.95, seed 7) twice and a 4-beam
# search; under dp 2 greedy 8 x 512 + 64; then a serving plan the port
# searched for buckets (1, 8) on a described 2-device mesh, loaded
# through build_serving_plan_session over the two ranks with the floor
# guard on, its requests sent through rank 0's relay from two client
# threads and a BatchScheduler's worker
GENWORLD_SPEC = {"device": "cuda", "batch": 8, "seq": GPT_SEQ, "plen": 512,
                 "tokens": GEN_TOKENS, "sample_tokens": 32,
                 "ragged": [100, 517, 900], "beam": [256, 16, 4],
                 "buckets": [1, 8], "plan_budget": 16, "plan_plen": 300,
                 "relay_tokens": 16, "timed_tokens": 16, "gpt": {}}
GENWORLD_RUNS = (("tp2", ("--tp", "2")), ("dp2", ("--only-data-parallel",)))
GENWORLD_STACKS_S = 240


def genworld_model(spec: dict, argv=(), sf: str = None):
    """GPT-2 at ``spec``'s widths under ``argv`` (or the bucket strategy
    file ``sf``), compiled over the world, with the generate phase's
    seed."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import GPTConfig, build_gpt2
    cfg = FFConfig.parse_args(list(argv))
    cfg.batch_size, cfg.seed, cfg.device = spec["batch"], 0, spec["device"]
    cfg.kernel_impls = "attention:flash"
    if sf:
        cfg.import_strategy_file, cfg.only_data_parallel = sf, False
    ff = FFModel(cfg)
    out = build_gpt2(ff, spec["batch"], spec["seq"],
                     GPTConfig(**spec["gpt"]))
    ff.compile(SGDOptimizer(0.01), "sparse_categorical_crossentropy", [],
               output_tensor=out)
    return ff


def counted_steps(ff) -> dict:
    """Count ``ff``'s KV decode steps (``n``) and keep the score rows of
    the next step taken while ``keep`` is set (``rows``)."""
    ex = ff.executor
    step = ex.kv_decode_step
    rec = {"n": 0, "keep": False, "rows": None}

    def counted(*a, **kw):
        row, cache = step(*a, **kw)
        rec["n"] += 1
        if rec["keep"]:
            rec["rows"], rec["keep"] = row.float().cpu(), False
        return row, cache
    ex.kv_decode_step = counted
    return rec


_T0 = time.perf_counter()


def progress(what: str) -> None:
    """A rank's progress line, with its seconds since the process began."""
    print(f"[rank {os.environ.get('FF_PROCESS_ID', '0')} "
          f"{time.perf_counter() - _T0:.1f} s] {what}", flush=True)


def world_sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def flash_fwd_count(dev: str):
    """Set the flash forward's count to 0 and return what reads it: its
    launches on the card, its plain-version calls on the CPU (where the
    wrapper runs the plain version)."""
    f = zero_counts()["flash_attention_fwd"]
    base = f.plain_calls
    return lambda: f.launches if dev == "cuda" else f.plain_calls - base


def genworld_run(spec: dict, name: str, argv) -> dict:
    """One rank's generation under ``argv`` through
    InferenceSession.generate, every count at 0 first: the outputs, the
    first decode step's score rows of the greedy run, the flash launches
    and prefills, the decode steps, the KV fallbacks; then the prefill
    and decode-step times at 1 and 8 rows and the rank's peak memory."""
    from flexflow_tpu_torch.serving import InferenceSession
    dev = spec["device"]
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ff = genworld_model(spec, argv)
    progress(f"{name}: compiled over {dict(ff.dmesh.axis_sizes)}")
    V, seq, plen, n = vocab_of(ff), spec["seq"], spec["plen"], spec["tokens"]
    sess = InferenceSession(ff, batch_buckets=(1, spec["batch"]),
                            decode_segment=0)
    rec = counted_steps(ff)
    p8 = gpt_prompts(spec["batch"], plen, V, 1, seq)
    outs = {}
    world_sync(dev)
    fwd = flash_fwd_count(dev)
    t0 = time.perf_counter()
    rec["keep"] = True
    outs["greedy"] = sess.generate(p8, plen, n)
    progress(f"{name}: greedy {p8.shape[0]} x {plen} + {n}, "
             f"{rec['n']} decode steps")
    if name == "tp2":
        rl = np.array(spec["ragged"], np.int32)
        p3 = gpt_prompts(3, rl, V, 2, seq)
        outs["ragged"] = sess.generate(p3, rl, n)
        outs["eos"] = np.array(int(outs["ragged"][0, rl[0] + 3]))
        outs["ragged_eos"] = sess.generate(p3, rl, n,
                                           eos_token_id=int(outs["eos"]))
        samp = dict(temperature=0.8, top_k=50, top_p=0.95, seed=7)
        for k in ("sample_a", "sample_b"):
            outs[k] = sess.generate(p8, plen, spec["sample_tokens"], **samp)
        progress(f"{name}: ragged, eos, sampled twice, {rec['n']} decode "
                 f"steps")
        bp, bn, bk = spec["beam"]
        outs["beam"] = sess.generate(gpt_prompts(1, bp, V, 3, seq), bp, bn,
                                     num_beams=bk)
        progress(f"{name}: beam {bk}, {rec['n']} decode steps")
    world_sync(dev)
    main_s = time.perf_counter() - t0
    res = {"launches": fwd(), "prefills": len(outs) - ("eos" in outs),
           "steps": rec["n"], "main_s": main_s,
           "fallback": getattr(ff, "_kv_fallback_count", 0),
           "first_rows": rec["rows"], "outs": outs,
           "mesh": dict(ff.dmesh.axis_sizes),
           "heads_local": int(ff.params[next(
               l.name for l in ff.executor.program.layers
               if l.op_type.name == "OP_MULTIHEAD_ATTENTION")]["wq"]
               .to_local().shape[1])}
    # prefill and decode-step time at one row a block (1 row under tp,
    # one a rank under dp) and at 8 rows: one generate each, timed apart
    # by FFModel._generate_kv (each part ends in a device sync), on every
    # rank in step
    res["times"] = {}
    for b in (ff.executor.row_blocks(), spec["batch"]):
        ff._decode_measured = {}
        ff.generate(p8[:b], plen, spec["timed_tokens"], kv_cache=True)
        m = ff._decode_measured[b]
        res["times"][b] = {"prefill_ms": m["prefill_s"] * 1e3,
                           "step_ms": m["decode_step_s"] * 1e3,
                           "tokens_per_s": b / m["decode_step_s"]}
        progress(f"{name}: timed at {b} rows {res['times'][b]}")
    res["fallback"] = getattr(ff, "_kv_fallback_count", 0)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 \
        if dev == "cuda" else 0.0
    return res


def genworld_plan(spec: dict, plan: str) -> dict:
    """The serving plan over the world: build_serving_plan_session with
    the floor guard on (rank 0's times decide), then requests through
    rank 0's relay (serving/world.py) from two client threads (greedy at
    1 and 8 rows) and two scheduler requests (a BatchScheduler's worker
    runs the forwards); the other rank follows. Each rank: its relayed
    calls and their digests, decode steps, flash launches, fallbacks and
    the relay's host time."""
    import threading
    from flexflow_tpu_torch.serving import InferenceSession
    from flexflow_tpu_torch.serving.session import (
        build_serving_plan_session)
    from flexflow_tpu_torch.serving.world import WorldRelay

    def build(sf, buckets):
        argv = ("--only-data-parallel",) if sf is None else ()
        return InferenceSession(genworld_model(spec, argv, sf), buckets,
                                decode_segment=0)

    t0 = time.perf_counter()
    ps = build_serving_plan_session(plan, build, floor_guard="true")
    load_s = time.perf_counter() - t0
    progress(f"plan: loaded with the floor guard {ps.floor_guard} in "
             f"{load_s:.1f} s")
    models = {id(ps.session_for(b).ff): ps.session_for(b).ff
              for b in ps.buckets}
    recs = [counted_steps(f) for f in models.values()]
    for op in ("generate", "infer"):
        def logged(*a, _op=op, _fn=getattr(ps, op), **kw):
            progress(f"plan: relayed {_op} begins")
            y = _fn(*a, **kw)
            progress(f"plan: relayed {_op} ends")
            return y
        setattr(ps, op, logged)
    rel = WorldRelay(ps)
    progress("plan: relay up")
    V, seq, n = vocab_of(ps.ff), spec["seq"], spec["relay_tokens"]
    out = {"load_s": load_s,
           "floor_guard": {str(b): r for b, r in ps.floor_guard.items()},
           "meshes": {str(b): dict(ps.session_for(b).ff.dmesh.axis_sizes)
                      for b in ps.buckets},
           "heads_local": {str(b): int(ps.session_for(b).ff.params[next(
               l.name for l in ps.session_for(b).ff.executor.program.layers
               if l.op_type.name == "OP_MULTIHEAD_ATTENTION")]["wq"]
               .to_local().shape[1]) for b in ps.buckets}}
    world_sync(spec["device"])
    fwd = flash_fwd_count(spec["device"])
    t0 = time.perf_counter()
    if rel.rank == 0:
        got, failed = {}, []

        def drive():
            try:
                out["refused"] = genworld_requests(spec, rel, V, got)
            except BaseException as e:  # noqa: BLE001 — raised below
                failed.append(e)
            finally:
                rel.stop()
        caller = threading.Thread(target=drive)
        caller.start()
        rel.run()
        caller.join()
        if failed:
            raise failed[0]
        out["got"] = got
    else:
        out["followed"] = rel.run()
    world_sync(spec["device"])
    out["wall_s"] = time.perf_counter() - t0
    progress(f"plan: {rel.calls} relayed calls in {out['wall_s']:.1f} s")
    out["launches"] = fwd()
    out["calls"], out["log"] = rel.calls, [list(x) for x in rel.log]
    out["errors"] = rel.errors
    out["host_ms_per_call"] = rel.host_s / max(rel.calls, 1) * 1e3
    out["steps"] = sum(r["n"] for r in recs)
    out["fallback"] = sum(getattr(f, "_kv_fallback_count", 0)
                          for f in models.values())
    return out


def genworld_requests(spec: dict, rel, V: int, got: dict) -> bool:
    """Rank 0's callers of the plan session's relay: greedy requests at
    each bucket's rows from client threads and forwards from two
    clients of a BatchScheduler over the relay, then an overlong
    request, which its check must refuse on rank 0. Returns whether it
    did."""
    import threading
    from flexflow_tpu_torch.serving import BatchScheduler
    seq, pp, n = spec["seq"], spec["plan_plen"], spec["relay_tokens"]

    def ask(rows):
        got[f"generate{rows}"] = rel.generate(
            gpt_prompts(rows, pp, V, 30 + rows, seq), pp, n)
    sched = BatchScheduler(rel, max_batch=1, max_delay_ms=1)
    pos = np.arange(seq, dtype=np.int32)[None]

    def infer(i):
        y = sched.infer({"input_ids": gpt_prompts(1, pp, V, 40 + i, seq),
                         "position_ids": pos}, timeout=600)
        got[f"infer{i}"] = (tuple(y.shape), bool(np.isfinite(y).all()))
    threads = [threading.Thread(target=ask, args=(r,))
               for r in spec["buckets"]] + [
        threading.Thread(target=infer, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    sched.close()
    try:
        rel.generate(gpt_prompts(1, pp, V, 50, seq), seq, 1)
    except ValueError:
        return True
    return False


def genworld_rank_main(workdir: str) -> int:
    """A rank of the genworld phase (``--gen-rank``): joins the world the
    environment names, runs GENWORLD_RUNS and the serving plan, and
    writes its results."""
    import torch.distributed as dist
    from flexflow_tpu_torch.parallel.distributed import (ROUTES,
                                                         maybe_initialize)
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    maybe_initialize(device_type=spec["device"])
    rank = dist.get_rank()
    out = {"backend": dist.get_backend()}
    for name, argv in GENWORLD_RUNS:
        out[name] = genworld_run(spec, name, argv)
        free_cuda()
    import faulthandler
    # a rank still in the plan part this long after it began prints every
    # thread's stack to its log (then again each as long)
    faulthandler.dump_traceback_later(GENWORLD_STACKS_S, repeat=True)
    out["plan"] = genworld_plan(spec, os.path.join(workdir, "plan.json"))
    faulthandler.cancel_dump_traceback_later()
    out["routes"] = dict(ROUTES)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def genworld_search_plan(spec: dict, path: str) -> dict:
    """The port's serving plan for GPT-2 at ``spec["buckets"]``, searched
    on a described mesh of two devices (the world's) and exported to
    ``path``."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import GPTConfig, build_gpt2
    from flexflow_tpu_torch.parallel.machine import DeviceMesh, MachineSpec
    from flexflow_tpu_torch.search.serving_plan import (
        optimize_serving_strategy)
    cfg = FFConfig()
    cfg.batch_size, cfg.device = spec["batch"], spec["device"]
    cfg.export_strategy_file = path
    ff = FFModel(cfg)
    build_gpt2(ff, spec["batch"], spec["seq"], GPTConfig(**spec["gpt"]))
    spec_ = MachineSpec.detect(spec["device"])
    spec_.num_devices = 2
    ff.dmesh = DeviceMesh(spec_)
    ff.graph_inputs = list(ff.input_tensors)
    t0 = time.perf_counter()
    plan = optimize_serving_strategy(ff, buckets=spec["buckets"],
                                     budget=spec["plan_budget"])
    return {"search_s": time.perf_counter() - t0,
            "buckets": {str(b): {
                "predicted_prefill_ms": p.cost.prefill * 1e3,
                "predicted_decode_step_ms": p.cost.decode_step * 1e3,
                "kv_mib": p.cost.kv_bytes / 2**20}
                for b, p in sorted(plan.buckets.items())}}


def parted_where(got: np.ndarray, ref: dict, plen: int, n: int,
                 tol: float) -> list:
    """Per row: (the first step whose token differs from the one-rank
    run's, or None; the first step whose one-rank top-2 margin is below
    ``tol`` of the row's range, or None)."""
    out = []
    for r in range(got.shape[0]):
        d = np.flatnonzero(got[r, plen:plen + n] != ref["ids"][r,
                                                              plen:plen + n])
        t = np.flatnonzero(ref["margins"][r, :n] < tol)
        out.append((int(d[0]) if d.size else None,
                    int(t[0]) if t.size else None))
    return out


def phase_genworld(smi: str, spec: dict = None, ref: dict = None) -> dict:
    """Generation and serving over two ranks sharing the card (gloo):
    the runs of GENWORLD_SPEC (see above), each rank launching 12 flash
    forwards a prefill and none a decode step, no KV fallback, both ranks
    with the same ids and the same count of decode steps; the greedy
    runs' first decode step within GEN_TOL of the one-rank run's score
    rows (``ref``: the generate phase's, or one made here) and their
    tokens equal to it up to its first near tie; the two sampled runs
    equal. Then the flash kernels at the shapes these paths give them."""
    import tempfile
    spec = dict(spec or GENWORLD_SPEC)
    cuda = spec["device"] == "cuda"
    layers = spec["gpt"].get("num_layers", GPT_LAYERS)
    plen, n = spec["plen"], spec["tokens"]
    out = {}
    if ref is None:
        ref = genworld_one_rank(spec)
    with tempfile.TemporaryDirectory() as workdir:
        with open(os.path.join(workdir, "spec.json"), "w") as f:
            json.dump(spec, f)
        out["plan_search"] = genworld_search_plan(
            spec, os.path.join(workdir, "plan.json"))
        free_cuda()
        t0 = time.perf_counter()
        spawn_world(workdir, "--gen-rank", 2)
        out["world_s"] = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    where = "on the CPU" if not cuda else \
        "sharing one card" if torch.cuda.device_count() < 2 \
        else "on a card each"
    print(f"[genworld] two ranks {where}: backend {ranks[0]['backend']}, "
          f"relay route {ranks[0]['routes'].get('relay')} "
          f"({out['world_s']:.1f} s)")
    for name, _ in GENWORLD_RUNS:
        rs = [rk[name] for rk in ranks]
        for r, x in enumerate(rs):
            check(x["launches"] == layers * x["prefills"],
                  f"genworld {name} rank {r}: flash launches "
                  f"{x['launches']} != {layers} x {x['prefills']} prefills")
            check(x["fallback"] == 0, f"genworld {name} rank {r}: "
                                      f"{x['fallback']} KV fallbacks")
        check(rs[0]["steps"] == rs[1]["steps"],
              f"genworld {name}: decode steps {rs[0]['steps']} and "
              f"{rs[1]['steps']}")
        for k, v in rs[0]["outs"].items():
            check(np.array_equal(v, rs[1]["outs"][k]),
                  f"genworld {name} {k}: the ranks' ids differ")
        g = rs[0]["outs"]["greedy"]
        check_tokens(g, ref["ids"], plen, n, ref["first_rows"]
                     .shape[-1], f"genworld {name} greedy")
        first = torch.stack([x["first_rows"] for x in rs])
        want = ref["first_rows"].float()
        span = (want.amax(-1) - want.amin(-1))[None, :, None]
        err = ((first - want[None]).abs() / span).max().item()
        check(err <= GEN_TOL, f"genworld {name}: first-token scores "
                              f"{err:.3e} of the row's range from one rank")
        parts = parted_where(g, ref, plen, n, GEN_TOL)
        bad = [(r, d, t) for r, (d, t) in enumerate(parts)
               if d is not None and (t is None or d < t)]
        check(not bad, f"genworld {name}: rows parted from the one-rank "
                       f"run before a near tie (row, step, tie): {bad}")
        parted = [(r, d) for r, (d, _) in enumerate(parts) if d is not None]
        x = rs[0]
        print(f"[genworld] GPT-2 {name} ({layers} layers, mesh {x['mesh']}, "
              f"{x['heads_local']} heads a rank): {x['prefills']} requests "
              f"in {x['main_s']:.1f} s, flash launches {x['launches']} / "
              f"{rs[1]['launches']} (want {layers} x {x['prefills']} "
              f"prefills, 0 a decode step), decode steps {x['steps']} / "
              f"{rs[1]['steps']}, no KV fallback, the ranks' ids equal; "
              f"first-token scores within {err:.2e} of the one-rank run's "
              f"row range (tol {GEN_TOL:.0e}); greedy tokens equal the "
              f"one-rank run's in {g.shape[0] - len(parted)} of "
              f"{g.shape[0]} rows, parted (row, step) {parted}, each at or "
              f"after a near tie of the one-rank run")
        for b in rs[0]["times"]:
            t = [rk[name]["times"][b] for rk in ranks]
            print(f"[genworld] GPT-2 {name} at {b} rows: prefill "
                  f"{t[0]['prefill_ms']:.3f} / {t[1]['prefill_ms']:.3f} ms, "
                  f"decode step {t[0]['step_ms']:.3f} / "
                  f"{t[1]['step_ms']:.3f} ms, {t[0]['tokens_per_s']:.1f} "
                  f"tokens/s (rank 0 / rank 1; one FFModel.generate of "
                  f"{spec['timed_tokens']} tokens, host clock, each part "
                  f"device-synced); peak {rs[0]['peak_gib']:.3f} / "
                  f"{rs[1]['peak_gib']:.3f} GiB a rank ({smi})")
        out[name] = {"launches": [r["launches"] for r in rs],
                     "prefills": rs[0]["prefills"],
                     "steps": [r["steps"] for r in rs],
                     "first_err": err, "parted": parted,
                     "peak_gib": [r["peak_gib"] for r in rs],
                     "times": {b: [rk[name]["times"][b] for rk in ranks]
                               for b in rs[0]["times"]}}
    tp = ranks[0]["tp2"]["outs"]
    check(np.array_equal(tp["sample_a"], tp["sample_b"]),
          "genworld tp2: sampling with one seed is not repeatable")
    rl = np.array(spec["ragged"], np.int32)
    eos = int(tp["eos"])
    for r, pl in enumerate(rl):
        row, free = tp["ragged_eos"][r, pl:pl + n], tp["ragged"][r, pl:pl + n]
        hit = np.flatnonzero(free == eos)
        upto = hit[0] if hit.size else n
        check((row[:upto] == free[:upto]).all() and (row[upto:] == eos).all(),
              f"genworld tp2: eos does not latch on row {r}")
    print(f"[genworld] tp2 outputs: ragged {list(rl)} with eos {eos} "
          f"latching, sampling twice at seed 7 equal, beam "
          f"{spec['beam'][2]} over {spec['beam'][1]} tokens; ok")
    pl = [rk["plan"] for rk in ranks]
    x = pl[0]
    got = x["got"]
    prefills = len(spec["buckets"]) + sum(k.startswith("infer")
                                          for k in got)
    for r, y in enumerate(pl):
        check(y["launches"] == layers * prefills,
              f"genworld plan rank {r}: flash launches {y['launches']} != "
              f"{layers} x {prefills}")
        check(y["fallback"] == 0, f"genworld plan rank {r}: KV fallbacks")
        check(not y["errors"], f"genworld plan rank {r}: {y['errors']}")
    check(pl[1]["followed"] == x["calls"] == pl[1]["calls"] == prefills,
          f"genworld plan: relayed calls {x['calls']} / {pl[1]['calls']} "
          f"(followed {pl[1]['followed']}), want {prefills}")
    check(x["log"] == pl[1]["log"], "genworld plan: the ranks ran other "
                                    "calls or another order")
    check(x["steps"] == pl[1]["steps"]
          == spec["relay_tokens"] * len(spec["buckets"]),
          f"genworld plan: decode steps {x['steps']} / {pl[1]['steps']}")
    check(x["refused"], "genworld plan: an overlong request was relayed")
    check(x["floor_guard"] == pl[1]["floor_guard"],
          "genworld plan: the ranks adopted different models")
    forwards = [v for k, v in got.items() if k.startswith("infer")]
    check(all(ok and shape[:2] == (1, spec["seq"]) for shape, ok in forwards),
          f"genworld plan: forwards {forwards}")
    for b in spec["buckets"]:
        check(got[f"generate{b}"].shape == (b, spec["seq"]),
              f"genworld plan: generate at {b} rows")
    srch = out["plan_search"]
    print(f"[genworld] serving plan: searched in {srch['search_s']:.2f} s "
          f"for buckets {spec['buckets']} on a described 2-device mesh; "
          + "; ".join(f"bucket {b}: predicted prefill "
                      f"{v['predicted_prefill_ms']:.3f} ms, decode step "
                      f"{v['predicted_decode_step_ms']:.3f} ms, KV "
                      f"{v['kv_mib']:.1f} MiB, mesh {x['meshes'][b]}, "
                      f"{x['heads_local'][b]} heads a rank, floor guard "
                      f"{x['floor_guard'].get(b)}"
                      for b, v in srch["buckets"].items()))
    print(f"[genworld] plan session over the world: loaded with the floor "
          f"guard in {x['load_s']:.1f} s; {x['calls']} calls through rank "
          f"0's relay (greedy at {spec['buckets']} rows from two client "
          f"threads, {prefills - len(spec['buckets'])} forwards from a "
          f"BatchScheduler's worker) in {x['wall_s']:.1f} s, the same "
          f"calls in the same order on rank 1, an overlong request refused "
          f"on rank 0 only; flash launches {x['launches']} / "
          f"{pl[1]['launches']}, decode steps {x['steps']} / "
          f"{pl[1]['steps']}, no KV fallback; relay host time "
          f"{x['host_ms_per_call']:.3f} / {pl[1]['host_ms_per_call']:.3f} "
          f"ms a call (rank 0's broadcast / rank 1's wait) ({smi})")
    out["plan"] = {k: x[k] for k in ("load_s", "calls", "launches", "steps",
                                     "host_ms_per_call", "wall_s",
                                     "floor_guard", "meshes")}
    out["plan"]["host_ms_per_call_follower"] = pl[1]["host_ms_per_call"]
    out["plan"]["launches"] = [y["launches"] for y in pl]
    if not cuda:
        return out
    # the flash forward at the shapes these paths launch it: a tp rank's
    # heads (b8 h6) and a dp rank's rows (b4 h12) of GPT-2's prefill, and
    # a one-row tp prefill (b1 h6)
    gen = torch.Generator(device="cuda").manual_seed(17)
    s = spec["seq"]
    for key, b, h in (("fwd_tp", 8, 6), ("fwd_dp", 4, 12), ("fwd_tp1", 1, 6)):
        f = out[key] = fwd_times(s, 0.0, gen, causal=True, b=b, h=h, d=64)
        print(f"[genworld] flash forward at b{b} h{h} s{s} d64 bf16 causal: "
              f"{f['ms']:.4f} ms (plain {f['plain_ms']:.4f}, SDPA "
              f"{f['library_ms']:.4f} on {f['library_backend']}, bound "
              f"{f['bound_ms']:.4f} {f['bound_by']}) ({smi})")
    free_cuda()
    return out


def genworld_one_rank(spec: dict) -> dict:
    """The one-rank reference of the genworld phase where the generate
    phase did not run in this process: greedy 8 x plen + tokens from the
    same weights and prompts, its first decode step's score rows and its
    top-2 margins."""
    from flexflow_tpu_torch.serving import InferenceSession
    ff = genworld_model(spec, ("--only-data-parallel",))
    rec = counted_steps(ff)
    V = vocab_of(ff)
    p8 = gpt_prompts(spec["batch"], spec["plen"], V, 1, spec["seq"])
    rec["keep"] = True
    ids = InferenceSession(ff, (1, spec["batch"]), decode_segment=0) \
        .generate(p8, spec["plen"], spec["tokens"])
    ref = one_rank_ref(ff, ids, rec["rows"], spec["plen"], spec["tokens"],
                       spec["device"])
    del ff
    free_cuda()
    return ref


def genworld_batch(ids_np: np.ndarray, device: str) -> dict:
    ids = torch.from_numpy(ids_np).to(device)
    return {"input_ids": ids,
            "position_ids": torch.arange(ids.shape[1], dtype=torch.int32,
                                         device=ids.device)[None]
            .expand(ids.shape[0], -1)}


# --------------------------------------------------------------------------
# world: BERT-base trained dp 2 by a supervised world that loses a rank
# --------------------------------------------------------------------------
# the member program: tools/torch_dist_resilience_smoke.py --worker, one
# rank of the world under a per-process Supervisor (its record per world
# epoch and rank lands in the drill's out/ directory)
WORLD_TOOL = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tools", "torch_dist_resilience_smoke.py")
# the path: full-width BERT-base at 8 x 128 (the resilience phase's model:
# dropout 0.1, Adam 1e-4, flash + fused Adam, bf16 compute) trained dp 2
# under --zero by two ranks sharing the card (gloo), 2 epochs x 3 batches
# (6 steps), a two-phase multi-host checkpoint every 2 steps (and at each
# epoch's end) written by the manager's thread while the next steps run
# (its barriers go through the coordinator's store), the newest 2 kept
WORLD_SPEC = {"model": "bert", "bert": "base", "device": "cuda",
              "bf16": True, "batch": 8, "seq": 128, "dropout": 0.1,
              "rows": 24, "epochs": 2, "every": 2, "keep": 2,
              "async_save": True,
              "argv": ["--only-data-parallel", "--zero"], "mode": "train"}
# the detector's bounds: a beat every 0.1 s, a peer silent for 5 s is
# dead, a barrier waits 20 s (a BERT-base save writes ~0.9 GB on rank 0)
WORLD_ENV = {"FF_HB_INTERVAL_S": "0.1", "FF_HB_TIMEOUT_S": "5",
             "FF_BARRIER_TIMEOUT_S": "20"}
# every epoch of a drill, and each drill's world: spawn, compile, restore
# and steps fit well inside it
WORLD_TIMEOUT_S = 240
WORLD_DISK_BYTES = 6e9   # two kept steps of two drills' worlds


def world_drill(tmp: str, name: str, spec: dict, fault: str,
                **ws_kw) -> dict:
    """One drill: a ``WorldSupervisor`` of two ranks of the member
    program under the epoch-0 fault plan ``fault``; returns the
    supervisor, each (epoch, rank)'s record, the launcher's status, the
    checkpoint directory's listing and the wall time. A world that the
    policy cannot re-form raises (``WorldFailure``): the phase fails."""
    from flexflow_tpu_torch.resilience import WorldSupervisor, status
    d = os.path.join(tmp, name)
    os.makedirs(d)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    env = dict(WORLD_ENV, FF_SMOKE_SPEC=os.path.join(d, "spec.json"),
               FF_SMOKE_CKPT_DIR=os.path.join(d, "ckpt"),
               FF_SMOKE_OUT=os.path.join(d, "out"),
               FF_FAULT_PLAN_EPOCH0=fault, FF_FAULT_PLAN="",
               FF_DIST_TIMEOUT_S=str(WORLD_TIMEOUT_S // 2),
               PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    status.reset()
    ws = WorldSupervisor(
        lambda rank, n, port, epoch: [sys.executable, WORLD_TOOL,
                                      "--worker", "--spawned",
                                      repr(time.time())],
        nprocs=2, batch_size=spec["batch"], world_timeout_s=WORLD_TIMEOUT_S,
        env=env, **ws_kw)
    t0 = time.perf_counter()
    ws.run()
    wall = time.perf_counter() - t0
    recs, alive = {}, {}
    out = os.path.join(d, "out")
    for fn in os.listdir(out):
        with open(os.path.join(out, fn)) as f:
            if fn.endswith(".json"):
                r = json.load(f)
                recs[(r["epoch"], r["rank"])] = r
            elif fn.startswith("alive_rank"):
                step, t = f.read().split()
                rank, epoch = fn[len("alive_rank"):].split("_epoch")
                alive[(int(epoch), int(rank))] = (int(step), float(t))
    return {"ws": ws, "recs": recs, "alive": alive, "wall_s": wall,
            "status": status.snapshot(),
            "ckpt": sorted(os.listdir(os.path.join(d, "ckpt"))),
            "dir": d}


def world_report(tag: str, dr: dict, smi: str) -> None:
    """Print a drill's epochs: each epoch's wall split, each save's time,
    bytes and rate, each restore."""
    ws = dr["ws"]
    print(f"[world] {tag}: epochs {[(r['epoch'], r['nprocs'], r['rcs']) for r in ws.report]}"
          f", {ws.world_restarts} relaunch(es), {ws.shrinks} shrink(s), "
          f"wall {dr['wall_s']:.1f} s ({smi})")
    for (epoch, rank), r in sorted(dr["recs"].items()):
        steps = sum(s["t"] - s["t0"] for s in r["steps"])
        saves = sum(s["s"] for s in r["save_calls"])
        end = r.get("done") or (r.get("failure") or {}).get("t") or max(
            [s["t"] for s in r["steps"]], default=r["main"])
        joined = r.get("joined", r["main"])
        split = (f"spawn {r['main'] - r['spawned']:.1f} s, join "
                 f"{joined - r['main']:.1f} s, compile "
                 f"{r.get('compiled', joined) - joined:.1f} s, "
                 f"restore {r.get('restore_s', 0.0):.2f} s, steps "
                 f"{steps:.2f} s ({len(r['steps'])}), saves in the caller "
                 f"{saves:.2f} s ({len(r['save_calls'])}), total "
                 f"{end - r['spawned']:.1f} s")
        print(f"[world] {tag} epoch {epoch} rank {rank} of {r['world']} "
              f"({r['mode']}): {split}")
        calls = {c["step"]: c["s"] for c in r["save_calls"]}
        for s in r["saves"]:
            print(f"[world] {tag} epoch {epoch} rank {rank} save of step "
                  f"{s['step']}: the caller {calls.get(s['step'], 0.0):.3f}"
                  f" s (host copy), the writer {s['s']:.3f} s (the files"
                  f"{', barriers, commit' if r['world'] > 1 else ''}), "
                  f"shard {s['bytes'] / 1e9:.3f} GB, "
                  f"{s['bytes'] / 1e9 / s['s']:.3f} GB/s ({smi})")
        if "restore_check" in r:
            c = r["restore_check"]
            into = "assembled (no model)" if r["mode"] == "restore" else \
                f"{len(c['differ'])} of {c['leaves']} live leaves differ " \
                f"in any bit from the assembled step"
            print(f"[world] {tag} epoch {epoch} rank {rank} restored step "
                  f"{c['step']} in {r['restore_s']:.3f} s (quorum of "
                  f"{r['world']}): {into}; assembled CRC32 "
                  f"{c['assembled_crc']:#010x} over {c['leaves']} leaves")
        if "failure" in r:
            f = r["failure"]
            print(f"[world] {tag} epoch {epoch} rank {rank} detected "
                  f"RankFailure(rank={f['rank']}): {f['reason'][:160]}")


def world_steps_ok(tag: str, dr: dict, want: dict) -> int:
    """Every executed step of every member (replays included) launched
    ``want``; returns the count of steps checked."""
    n = 0
    for (epoch, rank), r in sorted(dr["recs"].items()):
        for s in r["steps"]:
            check(s["launches"] == want,
                  f"world {tag} epoch {epoch} rank {rank} step {s['step']} "
                  f"launched {s['launches']} != {want}")
            n += 1
    return n


def phase_world(smi: str, spec: dict = None) -> dict:
    """A world of two ranks on the card (gloo, sharing it) supervised by
    the port's WorldSupervisor, each rank a member program under a
    per-process Supervisor, four drills over the path of WORLD_SPEC:
    (a) clean: 2 ranks, 6 steps; (b) FF_FAULT_PLAN_EPOCH0=rank_crash@3:1
    with one relaunch: rank 0 exits 17 naming rank 1 within FF_HB_TIMEOUT_S
    plus a step, epoch 1 relaunches both ranks, resumes from a committed
    step >= 2 (restored bit-equal to the assembled step) and ends with
    every param and moment block and the last epoch's loss bit-equal to
    (a) on both ranks; (c) the same fault under policy "shrink" and no
    relaunch: epoch 1 is one rank, restores bit-equal to the assembled
    step it adopted, finishes with a finite loss, elastic_replans == 1;
    (d) crash_after_stage@2:1 during the save after step 2 of the same
    model: step 2 left as tmp-2 debris, rank 0 exits 17 within the
    barrier bound, and the relaunched (fresh) world quorum-restores step
    1's files on both ranks with equal CRCs. Every executed step of every rank,
    replays included, launches 12 / 12 / 12 flash kernels and one fused
    Adam. Then the flash kernels and the fused Adam at the shapes this
    path gives them."""
    import tempfile
    spec = dict(spec or WORLD_SPEC)
    cuda = spec["device"] == "cuda"
    layers = spec.get("layers", LAYERS)
    want = {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers, "adam_update": 1}
    hb = float(WORLD_ENV["FF_HB_TIMEOUT_S"])
    beat = float(WORLD_ENV["FF_HB_INTERVAL_S"])
    bar = float(WORLD_ENV["FF_BARRIER_TIMEOUT_S"])
    out = {}
    with tempfile.TemporaryDirectory(prefix="ff_world_") as tmp:
        free = shutil.disk_usage(tmp).free
        check(free >= WORLD_DISK_BYTES or not cuda,
              f"{free / 1e9:.1f} GB free under {tmp}; the world phase "
              f"needs {WORLD_DISK_BYTES / 1e9:.0f} GB")
        # (a) clean
        a = world_drill(tmp, "clean", spec, "")
        world_report("(a) clean", a, smi)
        check(a["ws"].epoch == 0 and a["ws"].world_restarts == 0,
              f"clean world re-formed: {a['ws'].report}")
        clean = {r: a["recs"][(0, r)] for r in (0, 1)}
        n_steps = spec["rows"] // spec["batch"] * spec["epochs"]
        check(all(len(c["steps"]) == n_steps for c in clean.values()),
              f"clean world ran {[len(c['steps']) for c in clean.values()]}"
              f" steps, want {n_steps}")
        check(clean[0]["loss"] == clean[1]["loss"]
              and np.isfinite(clean[0]["loss"]),
              f"clean losses {clean[0]['loss']!r} {clean[1]['loss']!r}")
        out["clean_steps"] = world_steps_ok("(a)", a, want)
        step_s = float(np.median([s["t"] - s["t0"] for c in clean.values()
                                  for s in c["steps"]]))
        out["step_s"] = step_s
        out["clean_wall_s"] = a["wall_s"]
        out["saves"] = [clean[r]["saves"] for r in (0, 1)]
        out["adam_shapes"] = clean[0]["adam_shapes"]
        shutil.rmtree(a["dir"], ignore_errors=True)

        # (b) rank 1 dies before step 3; one relaunch
        b = world_drill(tmp, "faulted", spec, "rank_crash@3:1",
                        max_world_restarts=1, policy="auto")
        world_report("(b) rank_crash@3:1", b, smi)
        ws = b["ws"]
        check(ws.epoch == 1 and ws.world_restarts == 1 and ws.shrinks == 0
              and ws.report[0]["rcs"] == [17, 13],
              f"faulted world: {ws.report}")
        fail = b["recs"][(0, 0)].get("failure") or {}
        crash_t = b["alive"][(0, 1)][1]
        detect = fail.get("t", float("inf")) - crash_t
        print(f"[world] (b) detection: rank 1 died before step "
              f"{b['alive'][(0, 1)][0]}; rank 0 raised RankFailure(rank="
              f"{fail.get('rank')}) {detect:.3f} s later (FF_HB_TIMEOUT_S "
              f"{hb:.0f} s, a step {step_s:.3f} s, a beat {beat:.1f} s); "
              f"the error rank 0 caught: {fail.get('error', '')[:200]}")
        # the detector sees the dead rank's last beat up to a beat late
        # and scans once a beat: FF_HB_TIMEOUT_S and a step, to two beats
        # (on the card; a CPU rehearsal's test holds its own bound)
        check(fail.get("rank") == 1 and b["alive"][(0, 1)][0] == 3
              and fail.get("restarts") == 0
              and (detect <= hb + step_s + 2 * beat or not cuda),
              f"detection: {fail}, {detect:.3f} s")
        resumed = [b["recs"][(1, r)] for r in (0, 1)]
        first = min(r["steps"][0]["t"] for r in resumed)
        recovery = first - crash_t
        print(f"[world] (b) recovery wall: {recovery:.1f} s from rank 1's "
              f"death to the first resumed step (epoch 1 resumed from "
              f"step {resumed[0]['start']})")
        for r, e1 in enumerate(resumed):
            check(e1["start"] >= 2 and e1["restore_check"]["differ"] == []
                  and e1["restore_check"]["step"] == e1["start"],
                  f"(b) rank {r} resumed {e1.get('start')} "
                  f"{e1.get('restore_check')}")
            same = e1["crcs"] == clean[r]["crcs"]
            print(f"[world] (b) rank {r} vs clean: last epoch's loss "
                  f"{e1['loss']!r} vs {clean[r]['loss']!r}; "
                  f"{sum(e1['crcs'][k] == v for k, v in clean[r]['crcs'].items())}"
                  f" of {len(clean[r]['crcs'])} param and moment blocks "
                  f"bit-equal")
            check(same and e1["loss"] == clean[r]["loss"],
                  f"(b) rank {r} did not end bit-equal to the clean world")
        out["faulted_steps"] = world_steps_ok("(b)", b, want)
        out.update(detect_s=detect, recovery_s=recovery,
                   faulted_wall_s=b["wall_s"],
                   quorum_restore_s=[e["restore_s"] for e in resumed])
        shutil.rmtree(b["dir"], ignore_errors=True)

        # (c) the same fault, no relaunch: the world shrinks to one rank
        c = world_drill(tmp, "shrink", spec, "rank_crash@3:1",
                        max_world_restarts=0, policy="shrink")
        world_report("(c) shrink", c, smi)
        ws = c["ws"]
        one = c["recs"].get((1, 0), {})
        check(ws.epoch == 1 and ws.shrinks == 1 and ws.nprocs == 1
              and ws.report[0]["rcs"] == [17, 13]
              and c["status"]["elastic_replans"] == 1,
              f"shrink: {ws.report}, status {c['status']}")
        check(one.get("world") == 1 and one["start"] >= 2
              and one["restore_check"]["differ"] == []
              and np.isfinite(one["loss"]),
              f"(c) one-rank epoch: {one}")
        print(f"[world] (c) epoch 1 on one rank restored step "
              f"{one['start']} bit-equal to the assembled step "
              f"({one['restore_check']['leaves']} leaves), last epoch's "
              f"loss {one['loss']!r}; elastic_replans "
              f"{c['status']['elastic_replans']}")
        out["shrink_steps"] = world_steps_ok("(c)", c, want)
        out.update(shrink_loss=one["loss"], shrink_wall_s=c["wall_s"],
                   adam_shapes_one=one["adam_shapes"])
        shutil.rmtree(c["dir"], ignore_errors=True)

        # (d) the torn save, then a fresh world restores
        torn = dict(spec, mode="torn", epoch_modes={"1": "restore"})
        d = world_drill(tmp, "torn", torn, "crash_after_stage@2:1",
                        max_world_restarts=1, policy="relaunch")
        world_report("(d) crash_after_stage@2:1", d, smi)
        ws = d["ws"]
        r0 = d["recs"][(0, 0)]
        waited = r0.get("failure", {}).get("t", float("inf")) \
            - r0.get("save_t0", 0.0)
        print(f"[world] (d) rank 0 left the save of step 2 "
              f"{waited:.2f} s after it began (FF_BARRIER_TIMEOUT_S "
              f"{bar:.0f} s); checkpoint directory {d['ckpt']}")
        check(ws.report[0]["rcs"] == [17, 13] and ws.epoch == 1
              and r0.get("failure", {}).get("rank") == 1
              and waited <= bar
              and "tmp-2" in d["ckpt"] and "2" not in d["ckpt"]
              and "1" in d["ckpt"],
              f"torn drill: {ws.report}, {r0.get('failure')}, {d['ckpt']}")
        rs = [d["recs"][(1, r)] for r in (0, 1)]
        check(all(r["start"] == 1 and r["steps_on_disk"] == [1]
                  for r in rs)
              and rs[0]["restore_check"]["assembled_crc"]
              == rs[1]["restore_check"]["assembled_crc"],
              f"torn drill restore: {[r.get('restore_check') for r in rs]}")
        out["torn_steps"] = world_steps_ok("(d)", d, want)
        out.update(torn_wait_s=waited,
                   torn_restore_s=[r["restore_s"] for r in rs],
                   torn_wall_s=d["wall_s"])
        shutil.rmtree(d["dir"], ignore_errors=True)
    print(f"[world] executed steps checked at {want} launches each: "
          f"(a) {out['clean_steps']}, (b) {out['faulted_steps']}, (c) "
          f"{out['shrink_steps']}, (d) {out['torn_steps']}")
    if not cuda:
        return out
    # the kernels at the shapes this path gives them: flash at a rank's
    # b4 h12 s128 d64 bf16 with dropout 0.1, and the fused Adam over a
    # rank's leaves under ZeRO (each moment's block) and over all of
    # BERT-base's (the shrunken world's one rank)
    free_cuda()
    gen = torch.Generator(device="cuda").manual_seed(17)
    f = out["fwd_rank"] = fwd_times(128, 0.1, gen, b=4)
    bw = out["bwd_rank"] = bwd_times(128, 0.1, gen, b=4)
    print(f"[world] flash at a dp-2 rank's b4 h12 s128 d64 bf16, dropout "
          f"0.1: forward {f['ms']:.4f} ms (plain {f['plain_ms']:.4f}, SDPA "
          f"{f['library_ms']:.4f}, bound {f['bound_ms']:.4f} "
          f"{f['bound_by']}), dq {bw['dq_ms']:.4f} ms (plain "
          f"{bw['dq_plain_ms']:.4f}, bound {bw['dq_bound'][0]:.4f}), dk/dv "
          f"{bw['dkv_ms']:.4f} ms (plain {bw['dkv_plain_ms']:.4f}, bound "
          f"{bw['dkv_bound'][0]:.4f}), SDPA's backward "
          f"{bw['sdpa_bwd_ms']:.4f} ms ({smi})")
    free_cuda()
    for key, shapes in (("adam_zero_rank", out["adam_shapes"]),
                        ("adam_one_rank", out["adam_shapes_one"])):
        shapes = [tuple(x) for x in shapes]
        differing = adam_identical(gen, shapes)
        check(differing == 0, f"world: fused Adam over {key}'s leaves")
        free_cuda()
        a = out[key] = adam_times(gen, shapes)
        a["leaves"] = len(shapes)
        print(f"[world] adam_update over {key.replace('_', ' ')}'s leaves: "
              f"{a['numel']} f32 parameters in {len(shapes)} leaves, one "
              f"launch, bit-identical to the plain version: kernel "
              f"{a['ms']:.4f} ms, plain {a['plain_ms']:.4f} ms, "
              f"torch._fused_adam_ {a['library_ms']:.4f} ms, bound "
              f"{a['bound_ms']:.4f} ms (bytes) ({smi})")
        free_cuda()
    return out


PHASES = ("build", "kernel", "ktimes", "slice", "train", "times",
          "generate", "llama", "mixtral", "moe", "zoo", "frontends",
          "resilience", "search", "dist", "pipe", "seq", "genworld", "world",
          "serve")


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (times needs slice)")
    ap.add_argument("--ab-base", metavar="DIR",
                    help="time the flash kernels of the checkout at DIR "
                    "and of this one in turns, and nothing else")
    ap.add_argument("--dist-rank", metavar="DIR",
                    help="run as a rank of the dist phase's world")
    ap.add_argument("--pipe-rank", metavar="DIR",
                    help="run as a rank of the pipe phase's world")
    ap.add_argument("--seq-rank", metavar="DIR",
                    help="run as a rank of the seq phase's world")
    ap.add_argument("--gen-rank", metavar="DIR",
                    help="run as a rank of the genworld phase's world")
    ap.add_argument("--dist-nccl", metavar="DIR",
                    help="run as the dist phase's one-rank NCCL world")
    ap.add_argument("--dist-profile", metavar="DIR",
                    help="profile one more step of each dist run (the "
                    "one-rank run and every rank's) into DIR")
    args = ap.parse_args()
    if args.dist_rank:
        return dist_rank_main(args.dist_rank)
    if args.dist_nccl:
        return dist_nccl_main(args.dist_nccl)
    if args.pipe_rank:
        return pipe_rank_main(args.pipe_rank)
    if args.seq_rank:
        return seq_rank_main(args.seq_rank)
    if args.gen_rank:
        return genworld_rank_main(args.gen_rank)
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
    run("dist", phase_dist, smi,
        dict(DIST_SPEC, profile=os.path.abspath(args.dist_profile))
        if args.dist_profile else None)
    run("pipe", phase_pipe, smi)
    run("seq", phase_seq, smi)
    run("genworld", phase_genworld, smi, None,
        (res.get("generate") or {}).get("world_ref"))
    run("world", phase_world, smi)
    run("serve", phase_serve, smi)
    if phases != set(PHASES):
        print(f"chip_smoke: ran phases {sorted(phases)} only; no result")
        return 1
    print(json.dumps({"kernels": kernel_rows(
        res["kernel"], res["slice"], res["ktimes"], res["train"],
        res["generate"], res["llama"], res["mixtral"], res["moe"],
        res["zoo"], res["frontends"], res["resilience"], res["search"],
        res["serve"], res["dist"], res["pipe"], res["seq"],
        res["genworld"])}))
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
