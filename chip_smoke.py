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
               BERT-base's leaves plus ragged and bf16 ones;
  4. ktimes  - device times (CUDA graph replay between CUDA events) of
               each kernel, its plain version and its PyTorch yardstick,
               at b8 h12 d64 bf16, s 128 and 512, without dropout and at
               BERT's training rate of 0.1, and each kernel's bound;
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
  8. kernels - one JSON line with each kernel's launches, error and times.

``--phases`` runs a subset while a kernel is brought up: ``--phases
build,kernel`` builds and checks every kernel, ``--phases
build,kernel,ktimes`` also times them; with no arguments every phase
runs.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no result; it does the
same where no CUDA device is present.
"""
from __future__ import annotations

import importlib
import json
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
LAYERS = 12
REQUESTS = 100   # timed requests per shape: the p90 has 10 beyond it
STEPS = 20       # timed train steps per shape
KERNELS = ["flash_attention_fwd", "flash_attention_bwd", "adam_update"]


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
        d_k = 64 if d <= 64 else 128
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


def bert_leaf_shapes() -> list:
    """The weight shapes of full-width BERT-base, from its graph (nothing
    materialized)."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import BertConfig, build_bert
    from flexflow_tpu_torch.ops import ensure_weight_specs
    ff = FFModel(FFConfig())
    build_bert(ff, 8, 128, BertConfig.base())
    return [tuple(w.shape) for layer in ff.layers
            for w in ensure_weight_specs(layer)]


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
    BERT-base's 200 leaves, ragged leaves and a bf16 leaf, with weight
    decay: bit-identical, since both round every f32 op once."""
    from flexflow_tpu_torch.kernels.opt_update import (
        fused_adam_update, fused_adam_update_plain)
    shapes = bert_leaf_shapes() + [(1,), (7,), (4097,), (33, 65), (3, 5, 7)]
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
                dropout: float = 0.1):
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
    bcfg.dropout = dropout
    out = build_bert(ff, 8, seq, bcfg)
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


def train_model(seq: int, impl: str, dropout: float = 0.1):
    from flexflow_tpu_torch import AdamOptimizer
    return build_model(seq, impl, AdamOptimizer(1e-4), ["accuracy"],
                       dropout)


def phase_train() -> dict:
    """The training path at full width: fit -> eval with every kernel's
    launches counted, then the dropout-0 comparison with the plain path."""
    ff, bcfg = train_model(128, "attention:flash,opt_update:fused")
    x, y = dataset(bcfg, 128, 24, 7)
    epochs, batches = 2, 24 // 8
    torch.cuda.synchronize()
    fns = counters()
    for fn in fns.values():   # the main path: every count starts at 0
        fn.launches = 0
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


def bwd_bound_ms(bh: int, s: int, d: int, dkv: bool) -> tuple:
    """Least time of one backward kernel (bf16): q, k, v, do read once,
    lse and delta (f32) read once, dq (or dk and dv) written once, against
    6 (dq) or 8 (dk/dv) * s*s*d flops per head on the bf16 tensor
    cores."""
    nbytes = 4 * bh * s * d * 2 + 2 * bh * s * 4 \
        + (2 if dkv else 1) * bh * s * d * 2
    flops = (8.0 if dkv else 6.0) * bh * s * s * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fwd_times(seq: int, rate: float, gen) -> dict:
    """The forward kernel, its plain version and SDPA (its flash backend,
    with the same dropout rate) at b8 h12 s d64 bf16."""
    import torch.nn.functional as F
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    b, h, d = 8, 12, 64
    q, k, v = (torch.randn(b, h, seq, d, device="cuda", dtype=torch.bfloat16,
                           generator=gen) for _ in range(3))
    kw = dict(dropout_rate=rate, dropout_seed=5 if rate else None)
    bound_ms, bound_by = attention_bound_ms(b * h, seq, seq, d, 2)
    return {"ms": cuda_time_ms(lambda: flash_attention(q, k, v, **kw)),
            "plain_ms": cuda_time_ms(
                lambda: flash_attention_plain(q, k, v, **kw)),
            "library_ms": cuda_time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       dropout_p=rate)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def bwd_times(seq: int, rate: float, gen) -> dict:
    """dq and dk/dv kernels, their plain versions and the backward of
    torch's flash SDPA (dq, dk, dv in one call, at the same dropout rate)
    at b8 h12 s d64 bf16."""
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
        flash_attention_bwd_dq_plain)
    b, h, d = 8, 12, 64
    q, k, v, do = (torch.randn(b, h, seq, d, device="cuda",
                               dtype=torch.bfloat16, generator=gen)
                   for _ in range(4))
    kw = dict(dropout_rate=rate, dropout_seed=5 if rate else None)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    res = {"dq_ms": cuda_time_ms(lambda: flash_attention_bwd_dq(*args, **kw)),
           "dkv_ms": cuda_time_ms(
               lambda: flash_attention_bwd_dkv(*args, **kw)),
           "dq_plain_ms": cuda_time_ms(
               lambda: flash_attention_bwd_dq_plain(*args, **kw)),
           "dkv_plain_ms": cuda_time_ms(
               lambda: flash_attention_bwd_dkv_plain(*args, **kw))}
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, dropout_p=rate)
    out, lse_lib, cq, ck, mq, mk, seed, offset = fwd[:8]
    res["sdpa_bwd_ms"] = cuda_time_ms(
        lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out, lse_lib, cq, ck, mq, mk, rate, False, seed,
            offset))
    res["dq_bound"] = bwd_bound_ms(b * h, seq, d, False)
    res["dkv_bound"] = bwd_bound_ms(b * h, seq, d, True)
    return res


def adam_times(gen) -> dict:
    """The fused Adam kernel, its plain version and torch._fused_adam_
    (a timing yardstick only: its eps placement differs) over BERT-base's
    leaves, f32."""
    from flexflow_tpu_torch.kernels.opt_update import (
        fused_adam_update, fused_adam_update_plain)
    shapes = bert_leaf_shapes()
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


def phase_ktimes() -> dict:
    """Every kernel's device time beside its plain version, its PyTorch
    yardstick and its bound: the flash kernels at s 128 and 512, without
    dropout and at 0.1, and Adam over BERT-base."""
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
    h = res["host"] = launch_host_us()
    print(f"[ktimes] host time of one C launch call (ctypes) b8 h12 s128 d64 "
          f"bf16, each encoding four TMA tensor maps: flash_attention_fwd "
          f"{h['fwd']:.2f} us, flash_attention_bwd_dq {h['dq']:.2f} us")
    a = res["adam"] = adam_times(gen)
    print(f"[ktimes] adam_update over BERT-base's {a['numel']} f32 "
          f"parameters (200 leaves, one launch): kernel {a['ms']:.4f} ms, "
          f"plain {a['plain_ms']:.4f} ms, torch._fused_adam_ "
          f"{a['library_ms']:.4f} ms, bound {a['bound_ms']:.4f} ms "
          f"(bytes); kernel/bound {a['ms'] / a['bound_ms']:.2f}")
    return res


def kernel_rows(errs, serve, kt, train) -> list:
    """The kernels' JSON rows: times at b8 h12 s128 d64 bf16 without
    dropout, with s512 and dropout 0.1 beside them."""
    def fwd_row(seq, rate):
        return dict(kt["fwd"][(seq, rate)])

    def bwd_row(key, seq, rate):
        t = kt["bwd"][(seq, rate)]
        return {"ms": t[key + "_ms"], "plain_ms": t[key + "_plain_ms"],
                "bound_ms": t[key + "_bound"][0],
                "bound_by": t[key + "_bound"][1],
                # one call computes dq, dk and dv together
                "library_ms": t["sdpa_bwd_ms"]}

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
                        "s512": fwd_row(512, 0.1)}}]
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
                            "s512": bwd_row(key, 512, 0.1)}})
    a = kt["adam"]
    rows.append({
        "name": "adam_update", "route": "cuda",
        "source": "flexflow_tpu_torch/csrc/adam_update.cu",
        "replaces": "flexflow_tpu/kernels/opt_update.py:27",
        "launches": train["launches"]["adam_update"],
        "max_abs_err": errs["adam_update"], "ms": a["ms"],
        "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
        "bound_by": "bytes", "library_ms": a["library_ms"],
        "shape": f"BERT-base, {a['numel']} f32 parameters in 200 leaves"})
    return rows


PHASES = ("build", "kernel", "ktimes", "slice", "train", "times")


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (times needs slice)")
    phases = set(ap.parse_args().phases.split(","))
    dev = phase_device()
    if "build" in phases:
        phase_build()
    errs = phase_kernel() if "kernel" in phases else None
    kt = phase_ktimes() if "ktimes" in phases else None
    serve = phase_slice((128, 512)) if "slice" in phases else None
    train = phase_train() if "train" in phases else None
    if "times" in phases:
        phase_times(serve.pop("models"))
    if phases != set(PHASES):
        print(f"chip_smoke: ran phases {sorted(phases)} only; no result")
        return 1
    print(json.dumps({"kernels": kernel_rows(errs, serve, kt, train)}))
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
