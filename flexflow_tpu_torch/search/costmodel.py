"""Execution cost model: per-op compute costs + inter-op transfer costs
over the machine model.

The port of ``flexflow_tpu/search/costmodel.py``; the reference's
Simulator (``src/runtime/simulator.cc``):
  - ``measure_operator_cost`` (``simulator.cc:537``) is
    ``OpCostModel.measure``: run the op's own ``emit`` at the shard-local
    shape on the card, forward and forward+backward, warm-up, repeats and
    the median between CUDA events, cached in memory and on disk by
    (generation, op params, degrees). ``op_cost`` takes the measurement
    when ``measure_on_device`` is set (a search on the card) and the
    analytic roofline (FLOPs at the calibrated tensor-core rate against
    bytes over HBM) otherwise.
  - ``xfer_cost``: resharding between layouts, the collective's volume
    over the fabric's bandwidth plus per-hop latency.
  - ``weight_sync_cost``: the gradient all-reduce ring over the data-
    parallel degree.

Quantized gradient sync (``attach_quantization``,
``quantized_sync_quote``: the flat sync at the wire dtype's bytes) and
overlap-aware sync pricing (``overlap_mode``: only the exposed part of a
sync or a ring hop is charged) are the JAX package's. Hierarchical
placement is not ported (ROADMAP queue 1 item 5): attaching one raises
``NotImplementedError``, so every sync is priced flat.
A CUDA failure while calibrating or measuring raises; only an unreadable
cache file is skipped.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import default_cache_dir
from ..core.layer import Layer
from ..dtypes import itemsize
from ..ffconst import OperatorType, PARALLEL_OPS
from ..obs import events as obs_events
from ..ops import get_op_def
from ..parallel.machine import DeviceMesh, MachineSpec
from ..parallel.topology import link_degradation_factor


_NOT_PORTED = ("is not ported (ROADMAP queue 1 item 5: the rest of the "
               "strategy search)")


def bandwidth_multiplier(collective: str, degree: int) -> float:
    """Ring-algebra bytes multiplier of one collective: each participant
    moves ``multiplier x (d-1)/d`` of the volume (the JAX package's
    ``parallel/placement.py`` table)."""
    return {"all_reduce": 2.0, "all_gather": 1.0,
            "reduce_scatter": 1.0, "all_to_all": 1.0 / max(degree, 1),
            "permute": 1.0 / max(degree, 1),
            "ppermute": float(degree)}[collective]


def _cuda_sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _SavedLaunchCounts:
    """Saves the kernels' launch and plain-call counters on entry and
    puts them back on exit: measurements run the op's kernels, and the
    counts a caller holds a run to must not see them."""

    def __enter__(self):
        from ..kernels.flash_attention import (flash_attention,
                                               flash_attention_bwd_dkv,
                                               flash_attention_bwd_dq)
        from ..kernels.opt_update import fused_adam_update
        self._fns = [flash_attention, flash_attention_bwd_dq,
                     flash_attention_bwd_dkv, fused_adam_update]
        self._saved = [(f.launches, f.plain_calls) for f in self._fns]
        return self

    def __exit__(self, *exc):
        for f, (n, p) in zip(self._fns, self._saved):
            f.launches, f.plain_calls = n, p
        return False


def event_time(fn, device, warmup: int = 2, repeats: int = 5,
               reduce=np.median) -> float:
    """Seconds of one ``fn()`` call: warm-up calls, then ``repeats``
    calls each timed between CUDA events on the card (the host clock
    around a device sync on the CPU), reduced by ``reduce``."""
    import torch
    dev = torch.device(device)
    for _ in range(warmup):
        fn()
    _cuda_sync(dev)
    ts = []
    for _ in range(repeats):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return float(reduce(ts))



@dataclasses.dataclass
class CostMetrics:
    """Reference ``CostMetrics`` (``simulator.h:54``) parity."""
    forward_time: float = 0.0     # seconds
    backward_time: float = 0.0
    sync_time: float = 0.0
    inputs_memory: int = 0
    outputs_memory: int = 0
    weights_memory: int = 0

    @property
    def total_memory(self) -> int:
        return self.inputs_memory + self.outputs_memory + self.weights_memory


class OpCostModel:
    """Analytic + measured operator costs on one device."""

    # MXU efficiency defaults by op class (fraction of peak achieved);
    # refined by calibrate() microbenchmarks when a chip is available.
    _DEFAULT_EFF = 0.5

    # ops worth a per-op microbenchmark; everything cheaper uses the
    # analytic roofline (the JAX package's threshold: a cheap op's time
    # is its dispatch, which calibration prices)
    _MEASURE_MIN_FLOPS = 1e7

    def __init__(self, spec: MachineSpec, cache_dir: Optional[str] = None):
        self.spec = spec
        self.cache: Dict[Tuple, CostMetrics] = {}
        self.mxu_eff = self._DEFAULT_EFF
        self.overhead_s = 2e-6  # per-op dispatch (calibration measures it)
        # measured collective constants (calibrate_collectives); None =
        # use the machine-model ICI numbers. On the CPU simulation
        # platform the model's v5e ICI bandwidths overstate one host's
        # memcpy fabric by orders of magnitude — the round-2 root cause
        # of searched strategies losing to DP on DLRM/XDL.
        self.coll_bw: Optional[float] = None
        self.coll_lat: Optional[float] = None
        # segmented-transfer settings for the task simulator (reference
        # EnhancedMachineModel, machine_model.cc: --simulator-segment-size
        # / --simulator-max-num-segments). max_segments 1 = whole-message
        # store-and-forward; >1 lets multi-hop transfers pipeline
        # segment-wise across their route in tasksim.py.
        self.segment_size: int = 16777216
        self.max_segments: int = 1
        # measurement-grounded calibration v2 (search/calibration.py):
        # host dispatch overhead, memory bandwidth, parallel efficiency
        # and per-collective tables measured on the live backend. None =
        # analytic terms only (unchanged legacy behavior).
        self.calib = None
        # hierarchical placement (not ported: always None, so every
        # sync is priced flat); the quantized-collectives policy
        # (attach_quantization); overlap-aware sync pricing (set by the
        # search from FFConfig.overlap)
        self.placement = None
        self.placement_policy: Optional[str] = None
        self.quantization: Optional[Dict[str, str]] = None
        self.overlap_mode = False
        self.last_sync_wire: str = "float32"
        # calibration-row provenance tap: when a list is installed here,
        # every pricing call appends WHICH calibration row (or analytic
        # term) produced its answer. Installed only by the audit
        # breakdown path (GraphCostEvaluator.graph_cost_breakdown).
        self.provenance: Optional[List[Dict[str, Any]]] = None
        # on-device measurement (reference measure_operator_cost analog)
        self.measure_on_device = False
        # searchable kernel tier (kernels/registry.py): per-(op, impl)
        # answers memoized like the op cache — kernel_impl_cost sits in
        # the planner's candidate loop
        self._impl_cache: Dict[Tuple, CostMetrics] = {}
        # attach_kernel_tier installs this: {"seq_degree", "backend",
        # "tier", "forced"}. With it set, op_cost_with_impl prices
        # attention at its cheapest AVAILABLE implementation — the impl
        # becomes a per-op dimension of the search; the argmin of the
        # most recent pricing is left in last_kernel_impl for the audit
        # breakdown and accumulated per layer name in kernel_choice for
        # FFModel._plan_kernels to adopt.
        self.kernel_tier: Optional[Dict[str, Any]] = None
        self.last_kernel_impl: Optional[str] = None
        self.kernel_choice: Dict[str, str] = {}
        self.measure_budget_s = 120.0   # total wall budget for microbenches
        self._measure_spent_s = 0.0
        self._unmeasurable: set = set()  # per-process, deliberately not on disk
        self._disk: Optional[Dict[str, Any]] = None
        self._cache_dir = cache_dir or default_cache_dir()
        # where measure() runs the ops: the model's device
        self.device = "cuda"

    # ------------------------------------------------------------------
    # disk cache (reference hash_to_operator_cost persisted)
    # ------------------------------------------------------------------
    @property
    def _disk_path(self) -> str:
        return os.path.join(self._cache_dir,
                            f"opcost_{self.spec.generation}.json")

    def _disk_cache(self) -> Dict[str, Any]:
        if self._disk is None:
            try:
                with open(self._disk_path) as f:
                    self._disk = json.load(f)
            except (OSError, ValueError):   # missing or unreadable
                self._disk = {}
        return self._disk

    def _disk_put(self, key: str, value) -> None:
        cache = self._disk_cache()
        cache[key] = value
        try:
            os.makedirs(self._cache_dir, exist_ok=True)
            # one temporary file per writer: the ranks of a world share
            # the cache
            tmp = f"{self._disk_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(cache, f)
            os.replace(tmp, self._disk_path)
        except OSError:  # an unwritable cache costs a re-measurement
            pass


    # ------------------------------------------------------------------
    def attach_placement(self, placement, policy: str = "hier") -> None:
        """Hierarchical placement (the JAX package's
        ``parallel/placement.py``): only detaching is accepted here."""
        if placement is not None:
            raise NotImplementedError(
                f"hierarchical placement {_NOT_PORTED}")
        self.placement = None
        self.placement_policy = None

    def attach_quantization(self, mode: Optional[str],
                            wire: str = "int8") -> None:
        """Attach (or detach, ``mode=None`` / "off") the quantized-
        collectives scoring policy; clears every cost priced under the
        previous one."""
        if mode in (None, "off"):
            self.quantization = None
        else:
            from ..ops.quantized_collectives import QSYNC_MODES
            if mode not in QSYNC_MODES:
                raise ValueError(f"unknown quantization mode {mode!r}")
            self.quantization = {"mode": mode, "wire": wire}
        self.cache.clear()

    def _quant_overhead_s(self, volume_bytes: float) -> float:
        """Quantize + dequantize cost of one synced tensor: two streaming
        passes over the payload at the measured (or datasheet) memory
        rate."""
        mem_bw = self.spec.hbm_bandwidth
        if self.calib is not None and self.calib.mem_bw:
            mem_bw = self.calib.mem_bw
        return 2.0 * volume_bytes / max(mem_bw, 1.0)

    def _flat_wire_sync(self, volume_bytes: float, degree: int,
                        wire: str) -> float:
        """Flat quantized grad sync: the calibrated wire-dtype rows answer
        first, else the f32 rows queried at the narrow payload's bytes,
        else the analytic ring at wire bytes (two collectives, twice the
        latency rounds); plus the quantize/dequantize overhead."""
        from ..ops.quantized_collectives import wire_byte_scale
        wb = volume_bytes * wire_byte_scale(wire)
        t = None
        if self.calib is not None:
            t = self.calib.collective_marginal("all_reduce", degree, wb,
                                               dtype=wire)
            if t is None:
                t = self.calib.collective_marginal("all_reduce", degree,
                                                   wb)
        if t is None:
            ici_bw = (self.coll_bw or self.spec.ici_bandwidth) \
                / link_degradation_factor("ici")
            ici_lat = self.coll_lat if self.coll_lat is not None \
                else self.spec.ici_latency_us * 1e-6
            t = (bandwidth_multiplier("all_reduce", degree)
                 * (degree - 1) / degree * wb / ici_bw
                 + 2 * (degree - 1) * ici_lat)
        return float(t) + self._quant_overhead_s(volume_bytes)

    def quantized_sync_quote(self, volume_bytes: float, degree: int,
                             skeleton: Sequence[Tuple[Tuple[str, ...],
                                                      str]],
                             mode: Optional[str] = None,
                             wire: Optional[str] = None
                             ) -> Optional[Tuple[float, float,
                                                 List[Optional[str]]]]:
        """One gradient tensor's sync at full precision vs quantized over
        the tier-phase ``skeleton`` (``[(axes, tier), ...]``):
        ``(baseline_s, quantized_s, phase_wires)``, ``phase_wires[i]`` the
        wire dtype of phase i (None = full precision), all None where the
        mode keeps it full precision. None when no policy applies. With
        no placement attached (the port never attaches one) the sync is
        priced flat, as the JAX package does there: ``dcn_only`` has no
        leg to narrow, ``auto`` quantizes only where it is cheaper."""
        q = self.quantization or {}
        mode = mode or q.get("mode")
        wire = wire or q.get("wire") or "int8"
        if not mode or mode == "off" or degree <= 1 or volume_bytes <= 0:
            return None
        saved = self.quantization
        try:
            self.quantization = None
            base = self.weight_sync_cost(volume_bytes, degree)
        finally:
            self.quantization = saved
        tiers = [t for _, t in skeleton] or ["ici"]
        if mode == "dcn_only":
            return None
        qc = self._flat_wire_sync(volume_bytes, degree, wire)
        if mode == "auto" and qc >= base:
            return base, base, [None] * len(tiers)
        return base, qc, [wire] * len(tiers)

    def _prov(self, term: str, table: Optional[str],
              key: Optional[str] = None, tier: Optional[str] = None
              ) -> None:
        """Record one provenance row when the tap is installed (audit
        breakdowns only): ``term`` is the audit-entry component the
        answer lands in ("compute" | "xfer" | "sync"), ``table`` the
        calibration table family, ``key`` the exact row."""
        p = self.provenance
        if p is not None:
            p.append({"term": term, "table": table, "key": key,
                      "tier": tier})

    # ------------------------------------------------------------------
    def attach_calibration(self, calib) -> None:
        """Attach a ``calibration.MeshCalibration``: measured host
        dispatch overhead + memory bandwidth + parallel efficiency enter
        ``op_cost`` and the persisted collective tables take precedence
        in ``xfer_cost``. Invalidates the in-memory op cache — costs
        priced under the old terms must not survive."""
        self.calib = calib
        self.cache.clear()
        self._impl_cache.clear()

    # ------------------------------------------------------------------
    def attach_kernel_tier(self, dmesh, forced: Optional[Dict[str, str]]
                           = None) -> None:
        """Turn on the kernel-impl dimension (kernels/registry.py):
        ``op_cost_with_impl`` prices attention at its cheapest available
        implementation on this mesh. ``forced`` pins op kinds to one
        impl (``--kernel-impl`` / FF_KERNEL_IMPL / the retired
        use_flash_attention shim)."""
        tier = None
        seq_ax = getattr(dmesh, "seq_axis", None)
        if seq_ax:
            tier = getattr(dmesh, "axis_tiers", {}).get(seq_ax)
        self.kernel_tier = {
            "seq_degree": int(getattr(dmesh, "seq_degree", 0) or 0),
            "backend": _backend(dmesh),
            "tier": tier,
            "forced": dict(forced or {}),
        }
        self.kernel_choice = {}
        self.cache.clear()
        self._impl_cache.clear()

    def op_cost_with_impl(self, layer: Layer,
                          shard_degrees: Dict[int, int],
                          weight_shard_degree: int = 1) -> CostMetrics:
        """``op_cost`` with the kernel-impl dimension resolved: when a
        kernel tier is attached and the op has registered variants, every
        AVAILABLE impl is priced (``kernel_impl_cost``) and the cheapest
        answers; the argmin lands in ``last_kernel_impl`` (audit
        breakdowns) and ``kernel_choice[layer.name]``
        (``FFModel._plan_kernels``). Without a tier this IS ``op_cost``."""
        self.last_kernel_impl = None
        kt = self.kernel_tier
        if kt is None \
                or layer.op_type != OperatorType.OP_MULTIHEAD_ATTENTION:
            return self.op_cost(layer, shard_degrees, weight_shard_degree)
        from ..kernels import registry as kreg
        q_len = int(layer.inputs[0].shape[1]) if layer.inputs else 0
        kv_len = int(layer.inputs[1].shape[1]) \
            if len(layer.inputs) > 1 else q_len
        ctx = kreg.attention_ctx(layer.params, q_len, kv_len,
                                 backend=kt["backend"],
                                 seq_degree=kt["seq_degree"])
        forced = kt["forced"].get(kreg.ATTENTION)
        if forced is not None:
            names = [forced]  # pinned: availability enforced at adopt
        else:
            names = kreg.available_impls(kreg.ATTENTION, ctx)
        best_name, best = None, None
        for name in names:
            cm = self.kernel_impl_cost(
                layer, kreg.ATTENTION, name, shard_degrees,
                weight_shard_degree,
                seq_degree=kt["seq_degree"] if name == "ring" else 0,
                tier=kt["tier"])
            t = cm.forward_time + cm.backward_time
            if best is None or t < best.forward_time + best.backward_time:
                best_name, best = name, cm
        if best is None:  # no registered impl legal — reference path
            return self.op_cost(layer, shard_degrees, weight_shard_degree)
        self.last_kernel_impl = best_name
        self.kernel_choice[layer.name] = best_name
        return best

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def calibrate(self, device=None) -> float:
        """Time a chain of bf16 matmuls (n = 4096, 8 products) on the
        card between CUDA events and set ``mxu_eff`` to the achieved
        rate over ``spec.peak_flops`` (clamped to [0.05, 1]). Returns the
        achieved FLOP/s. A CUDA failure raises."""
        import torch
        dev = torch.device(device or self.device)
        n, reps = 4096, 8
        a = torch.full((n, n), 1e-3, dtype=torch.bfloat16, device=dev)

        def chain():
            x = a
            for _ in range(reps):
                x = x @ a
            return x

        dt = event_time(chain, dev, warmup=2, repeats=5) / reps
        achieved = 2.0 * n ** 3 / dt
        self.mxu_eff = min(1.0, max(0.05, achieved / self.spec.peak_flops))
        self.cache.clear()
        self._impl_cache.clear()
        return achieved

    # ------------------------------------------------------------------
    def calibrate_collectives(self, dmesh: "DeviceMesh") -> None:
        """Fit the all-reduce bandwidth and latency on the live mesh (a
        world of ranks): a world all-reduce timed at 1 and 16 MiB, the
        fit t(s) = 2(n-1)/n * s/bw + (n-1) * lat, as in the JAX package.
        Every rank times it and rank 0's fit is everyone's; cached on
        disk per (transport, mesh shape). On one device there is nothing
        to fit; a described mesh has no devices to time: its constants
        are the machine model's."""
        if dmesh.num_devices <= 1 or dmesh.described or not dmesh.live:
            return
        import torch
        import torch.distributed as dist
        from ..parallel.distributed import rank_device
        from .calibration import world_backend_key
        n = dmesh.num_devices
        shape = "x".join(f"{a}{s}" for a, s in dmesh.axis_sizes.items())
        key = f"coll_{world_backend_key(dmesh)}_{n}_{shape}"
        box = [self._disk_cache().get(key)
               if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        if box[0]:
            self.coll_bw, self.coll_lat = box[0]
            return
        dev = rank_device(_backend(dmesh))

        def bench(nbytes: int) -> float:
            x = torch.ones((nbytes // 4,), dtype=torch.float32, device=dev)
            return event_time(lambda: dist.all_reduce(x), dev, warmup=1,
                              repeats=3)

        s1, s2 = 1 << 20, 16 << 20
        t1, t2 = bench(s1), bench(s2)
        a = 2.0 * (n - 1) / n
        if t2 > t1 > 0:
            bw = a * (s2 - s1) / (t2 - t1)
            lat = max((t1 - a * s1 / bw) / (n - 1), 1e-9)
        else:  # a noisy pair: the bandwidth of the larger size alone
            bw = a * s2 / max(t2, 1e-9)
            lat = 1e-9
        box = [(float(min(max(bw, 1e7), 1e13)), float(lat))]
        dist.broadcast_object_list(box, src=0)
        self.coll_bw, self.coll_lat = box[0]
        if dist.get_rank() == 0:
            self._disk_put(key, list(box[0]))

    # ------------------------------------------------------------------
    # on-device per-op measurement (simulator.cc:537 / model.cu:38 analog)
    # ------------------------------------------------------------------

    @staticmethod
    def _local_shape(shape: Sequence[int],
                     degrees: Dict[int, int]) -> Tuple[int, ...]:
        out = list(shape)
        for d, deg in degrees.items():
            if 0 <= d < len(out) and deg > 1 and out[d] % deg == 0:
                out[d] = out[d] // deg
        return tuple(out)

    def _make_arg(self, shape, dtype, rng: np.random.Generator,
                  int_high: int, device):
        import torch

        from ..dtypes import to_torch
        tdt = to_torch(dtype)
        if not tdt.is_floating_point and tdt != torch.bool:
            return torch.from_numpy(rng.integers(
                0, max(int_high, 2), size=shape).astype(np.int64)).to(
                device=device, dtype=tdt)
        if tdt == torch.bool:
            return torch.ones(shape, dtype=tdt, device=device)
        return torch.from_numpy(
            (rng.standard_normal(shape) * 0.02).astype(np.float32)).to(
            device=device, dtype=tdt)

    def measure(self, layer: Layer, shard_degrees: Dict[int, int],
                weight_shard_degree: int = 1, warmup: int = 2,
                repeats: int = 5) -> Optional[CostMetrics]:
        """Microbenchmark one op's fwd and fwd+bwd at shard-local shape on
        ``self.device``: the op's own ``emit`` run eagerly (the JAX
        package jits it), warm-up + repeats + median between CUDA events.
        The kernels' launch counters are saved and restored around it.
        Returns None when the op's emit refuses these stand-in inputs
        (a ``ValueError``/``TypeError``/``NotImplementedError`` from
        the op); the caller then prices it analytically. A CUDA error
        raises."""
        import torch

        from ..dtypes import to_torch
        from ..ops import EmitCtx, LayerRng

        dev = torch.device(self.device)
        op = get_op_def(layer.op_type)
        out_shape = layer.outputs[0].shape if layer.outputs else ()
        out_rank = len(out_shape)
        # A degree on the LAST output dim is feature/head sharding: it is
        # realized by sharding the weight's output dim, NOT by shrinking
        # the op input (column-parallel linear/attention). Degrees on
        # earlier dims (batch/spatial) shrink the activations.
        act_degrees = {d: g for d, g in shard_degrees.items()
                       if d < out_rank - 1}
        eff_wdeg = weight_shard_degree * shard_degrees.get(out_rank - 1, 1)
        rng = np.random.default_rng(0)
        int_high = int(layer.params.get(
            "num_entries", layer.params.get("vocab_size", 100)))
        ins = []
        for t in layer.inputs:
            ls = self._local_shape(t.shape, act_degrees) \
                if len(t.shape) == len(out_shape) else t.shape
            ins.append(self._make_arg(ls, t.dtype, rng, int_high, dev))
        w: Dict[str, Any] = {}
        for spec in (layer.weights or op.weights(
                layer.params, [t.shape for t in layer.inputs],
                [t.dtype for t in layer.inputs])):
            ws = list(spec.shape)
            if eff_wdeg > 1 and ws and ws[-1] % eff_wdeg == 0:
                ws[-1] //= eff_wdeg
            w[spec.name] = self._make_arg(tuple(ws), spec.dtype, rng, 2,
                                          dev)
        state = {}
        state_spec = getattr(op, "state_spec", None)
        if state_spec is not None:
            ss = state_spec(layer.params, [t.shape for t in layer.inputs],
                            [t.dtype for t in layer.inputs]) or {}
            for sname, (sshape, sdt) in ss.items():
                init = torch.ones if sname == "var" else torch.zeros
                state[sname] = init(sshape, dtype=to_torch(sdt),
                                    device=dev)
        float_ins = [i for i, a in enumerate(ins) if a.is_floating_point()]
        float_ws = [k for k, v in w.items() if v.is_floating_point()]

        def run(backward: bool):
            ctx = EmitCtx(training=True,
                          rngs={layer.name: LayerRng((0, 0, 0))},
                          state={layer.name: state})
            with torch.enable_grad() if backward else torch.no_grad():
                xs = list(ins)
                ww = dict(w)
                leaves = []
                if backward:
                    for i in float_ins:
                        xs[i] = xs[i].detach().requires_grad_(True)
                        leaves.append(xs[i])
                    for k in float_ws:
                        ww[k] = ww[k].detach().requires_grad_(True)
                        leaves.append(ww[k])
                outs = op.emit(layer.params, xs, ww, ctx, layer.name)
                total = sum(o.float().sum() for o in outs
                            if o.is_floating_point())
                if backward and leaves and torch.is_tensor(total) \
                        and total.requires_grad:
                    torch.autograd.grad(total, leaves, allow_unused=True)

        t_all = time.perf_counter()
        try:
            with _SavedLaunchCounts():
                fwd_t = event_time(lambda: run(False), dev, warmup,
                                   repeats)
                tot_t = event_time(lambda: run(True), dev, warmup,
                                   repeats) \
                    if (float_ins or float_ws) else fwd_t
            return CostMetrics(forward_time=fwd_t,
                               backward_time=max(tot_t - fwd_t, 0.0))
        except (ValueError, TypeError, NotImplementedError, KeyError):
            return None
        finally:
            # real elapsed time, success or failure
            self._measure_spent_s += time.perf_counter() - t_all

    def _measured_cost(self, layer: Layer, shard_degrees: Dict[int, int],
                       weight_shard_degree: int,
                       key: Tuple) -> Optional[CostMetrics]:
        """Disk-cached measurement; None = not measurable / over budget."""
        dkey = repr(key)
        cached = self._disk_cache().get(dkey)
        if cached is not None:
            obs_events.counter("costmodel.measure_cache_hits")
            return CostMetrics(forward_time=cached[0],
                               backward_time=cached[1])
        if key in self._unmeasurable:
            return None
        if self._measure_spent_s >= self.measure_budget_s:
            return None
        obs_events.counter("costmodel.measure_cache_misses")
        with obs_events.span("costmodel.measure", op=layer.name):
            cm = self.measure(layer, shard_degrees, weight_shard_degree)
        if cm is None:
            # in-memory only: a failure may be transient (device busy,
            # flaky compile) and must not poison future processes
            self._unmeasurable.add(key)
            return None
        self._disk_put(dkey, [cm.forward_time, cm.backward_time])
        return cm

    # ------------------------------------------------------------------
    def op_cost(self, layer: Layer, shard_degrees: Dict[int, int],
                weight_shard_degree: int = 1) -> CostMetrics:
        """Cost of one op with its output dims partitioned by
        ``shard_degrees`` (dim -> degree). Compute scales ~1/prod(degrees);
        memory likewise."""
        key = (layer.param_key(), tuple(sorted(shard_degrees.items())),
               weight_shard_degree)
        obs_events.counter("costmodel.queries")
        hit = self.cache.get(key)
        if hit is not None:
            obs_events.counter("costmodel.cache_hits")
            if self.provenance is not None:
                self._op_prov(key)
            return hit
        op = get_op_def(layer.op_type)
        in_shapes = [t.shape for t in layer.inputs]
        out_shapes = [t.shape for t in layer.outputs]
        total_deg = 1
        for d in shard_degrees.values():
            total_deg *= max(d, 1)
        flops = op.flops(layer.params, in_shapes, out_shapes) / total_deg
        in_bytes = sum(int(np.prod(t.shape)) * itemsize(t.dtype)
                       for t in layer.inputs) // total_deg
        out_bytes = sum(int(np.prod(t.shape)) * itemsize(t.dtype)
                        for t in layer.outputs) // total_deg
        w_bytes = sum(int(np.prod(w.shape)) * itemsize(w.dtype)
                      for w in layer.weights) // max(weight_shard_degree, 1)
        bytes_moved = in_bytes + out_bytes + w_bytes
        t_compute = flops / (self.spec.peak_flops * self.mxu_eff)
        # calibration v2: measured memory bandwidth replaces the
        # datasheet HBM constant; measured host dispatch overhead
        # replaces the fixed 2us guess; measured parallel efficiency
        # stretches per-shard time when concurrent shards oversubscribe
        # the host (N virtual devices on C < N cores) — the host terms
        # the r05 fidelity study showed the blind model lacks
        mem_bw = self.spec.hbm_bandwidth
        dispatch = self.overhead_s
        par_eff = 1.0
        if self.calib is not None:
            if self.calib.mem_bw:
                mem_bw = self.calib.mem_bw
            if self.calib.dispatch_s:
                dispatch = self.calib.dispatch_s
            # SPMD executes EVERY op on every device simultaneously —
            # replicated ops run N full copies, sharded ops N shards —
            # so the whole mesh's concurrency applies regardless of the
            # op's own shard degrees (a replicated op escaping the
            # stretch would under-price replication vs sharding)
            par_eff = self.calib.efficiency(max(self.spec.num_devices, 1))
        t_mem = bytes_moved / mem_bw
        fwd = max(t_compute, t_mem) / max(par_eff, 1e-6) + dispatch
        bwd = fwd * op.backward_flops_factor() \
            if layer.op_type != OperatorType.OP_INPUT else 0.0
        if (self.measure_on_device and flops >= self._MEASURE_MIN_FLOPS
                and layer.op_type not in PARALLEL_OPS
                and layer.op_type != OperatorType.OP_INPUT):
            mm = self._measured_cost(layer, shard_degrees,
                                     weight_shard_degree,
                                     (self.spec.generation,) + key)
            if mm is not None:
                fwd, bwd = mm.forward_time, mm.backward_time
        cm = CostMetrics(forward_time=fwd, backward_time=bwd,
                         inputs_memory=in_bytes, outputs_memory=out_bytes,
                         weights_memory=w_bytes)
        self.cache[key] = cm
        if self.provenance is not None:
            self._op_prov(key)
        return cm

    def _op_prov(self, key: Tuple) -> None:
        """Compute-term provenance for one ``op_cost`` answer: the
        on-device measured row when one exists, else the calibrated
        host terms (membw/dispatch/parallel-eff — re-measuring those
        three is what fixes a drifting compute prediction), else the
        bare analytic roofline."""
        from .calibration import CalibrationTable
        if self.measure_on_device:
            dkey = repr((self.spec.generation,) + key)
            if self._disk_cache().get(dkey) is not None:
                self._prov("compute", "opcost", dkey)
                return
        if self.calib is not None:
            b = self.calib.backend
            self._prov("compute", "host_membw",
                       CalibrationTable.key(b, "host_membw"))
            self._prov("compute", "host_dispatch",
                       CalibrationTable.key(b, "host_dispatch"))
            if self.calib.parallel_eff:
                n = max(self.spec.num_devices, 1)
                self._prov("compute", "parallel_eff",
                           CalibrationTable.key(b, "parallel_eff", "-",
                                                0, n))
        else:
            self._prov("compute", None)

    # ------------------------------------------------------------------
    # searchable kernel tier (kernels/registry.py)
    # ------------------------------------------------------------------
    def kernel_impl_cost(self, layer: Optional[Layer], op: str,
                         impl_name: str,
                         shard_degrees: Optional[Dict[int, int]] = None,
                         weight_shard_degree: int = 1, *,
                         seq_degree: int = 0,
                         tier: Optional[str] = None,
                         param_bytes: float = 0.0,
                         **_ignored) -> CostMetrics:
        """Price one (op, kernel-impl) pair — the registry's cost entry
        point (``kernels/registry.py KernelImpl.cost``).

        ``attention``: starts from :meth:`op_cost` (the plain ``xla``
        path) and swaps the attention CORE term for the chosen impl's.
        Measured ``op_attention@<impl>`` calibration rows answer first
        (both sides of the swap from the same table, so the delta is
        apples-to-apples); off-table impls use the analytic curves:
        flash = same matmul flops minus the (s, s) score-matrix HBM
        round trip; ring = core/deg + (deg-1) ``ppermute`` hops of the
        local K/V block, each hop priced from the ``coll_ppermute``
        rows (``tier``-scoped when given) and — under ``overlap_mode``
        — charged only for its EXPOSED remainder after the concurrent
        block compute (the PR-13 bucket model applied to ring slices).

        ``opt_update``: absolute update time over ``param_bytes`` —
        ``fused`` streams w/g/m/v through VMEM once (~7 HBM passes),
        ``unfused`` pays XLA's multi-kernel round trips (~2x).
        """
        sd = dict(shard_degrees or {})
        key = (layer.param_key() if layer is not None else None, op,
               impl_name, tuple(sorted(sd.items())), weight_shard_degree,
               seq_degree, tier, int(param_bytes))
        hit = self._impl_cache.get(key)
        if hit is not None:
            return hit
        mem_bw = self.spec.hbm_bandwidth
        if self.calib is not None and self.calib.mem_bw:
            mem_bw = self.calib.mem_bw

        if op == "opt_update":
            b = max(float(param_bytes), 0.0)
            passes = 7.0 if impl_name == "fused" else 14.0
            t = passes * b / max(mem_bw, 1.0)
            if self.calib is not None:
                m = self.calib.op_time(f"opt_update@{impl_name}", b)
                if m is not None:
                    t = m
            cm = CostMetrics(forward_time=t)
            self._impl_cache[key] = cm
            return cm

        if op != "attention" or layer is None:
            raise ValueError(f"unpriceable kernel op {op!r}")
        base = self.op_cost(layer, sd, weight_shard_degree)
        out = layer.outputs[0].shape
        bsz, s = int(out[0]), int(out[1])
        h = int(layer.params.get("num_heads", 1))
        # kdim/embed_dim of 0 are unset placeholders, not real dims
        e = int(layer.params.get("kdim") or
                layer.params.get("embed_dim") or out[-1])
        dh = e // max(h, 1)
        total_deg = 1
        for d in sd.values():
            total_deg *= max(d, 1)
        pe = 1.0
        if self.calib is not None:
            pe = max(self.calib.efficiency(
                max(self.spec.num_devices, 1)), 1e-6)
        # fwd core: the two (s, s) contractions (qk^T and p·v),
        # stretched by measured parallel efficiency exactly like the
        # base roofline so "base minus core" stays non-negative
        core_flops = 4.0 * bsz * s * s * h * dh / total_deg
        t_core = core_flops / (self.spec.peak_flops * self.mxu_eff) / pe
        # the XLA path's score-matrix HBM round trip (write + read of
        # the (b, h, s, s) logits) — the traffic flash/ring never pay,
        # and the base roofline (inputs+outputs+weights only) misses
        t_scores = 2.0 * 4.0 * bsz * h * s * s / total_deg \
            / max(mem_bw, 1.0) / pe
        q_bytes = 4.0 * bsz * s * h * dh / total_deg
        # everything in the op that is NOT the attention core
        # (projections, bias, softmax overhead) — shared by every impl
        rest_f = max(base.forward_time - t_core, 0.0)
        rest_b = max(base.backward_time - 2.0 * t_core, 0.0)

        def _measured(name: str, deg: int = 0):
            """Measured impl time, ONLY within the measured payload
            range (x2 margin): the bench grid spans s=128..1024 at its
            own geometry, and extrapolating the near-quadratic xla
            curve an order of magnitude out turns the impl comparison
            into noise larger than the base cost itself. Out-of-range
            queries fall back to the analytic curve."""
            if self.calib is None:
                return None
            key = (f"op:attention@{name}", deg, self.calib.dtype)
            pts = self.calib._pts.get(key)
            if pts is None:
                self.calib.op_time(f"attention@{name}", 1, degree=deg)
                pts = self.calib._pts.get(key) or []
            if not pts or not (pts[0][0] / 2 <= q_bytes
                               <= pts[-1][0] * 2):
                return None
            return self.calib.op_time(f"attention@{name}", q_bytes,
                                      degree=deg)

        if impl_name == "xla":
            m = _measured("xla")
            t_impl = m if m is not None else t_core + t_scores
            t_impl_b = 2.0 * t_impl
        elif impl_name == "flash":
            m = _measured("flash")
            t_impl = m if m is not None else t_core
            t_impl_b = 2.0 * t_impl
        elif impl_name == "ring":
            deg = max(int(seq_degree), 1)
            # per-device: deg blocks of (s/deg, s/deg) scores — core
            # compute drops by deg, per-chunk score traffic by deg^2
            # summed over deg chunks
            t_blocks = (t_core + t_scores / deg) / deg
            hop_bytes = 2.0 * 4.0 * bsz * h * (s / max(deg, 1)) * dh
            hop_t = None
            if self.calib is not None:
                hop_t = self.calib.collective_time(
                    "ppermute", deg, hop_bytes, tier=tier)
                if hop_t is None and tier is not None:
                    hop_t = self.calib.collective_time(
                        "ppermute", deg, hop_bytes)
            if hop_t is None:
                ici_bw = (self.coll_bw or self.spec.ici_bandwidth) \
                    / link_degradation_factor(tier or "ici")
                ici_lat = self.coll_lat if self.coll_lat is not None \
                    else self.spec.ici_latency_us * 1e-6
                hop_t = hop_bytes / max(ici_bw, 1.0) + ici_lat
            per_hop_block = t_blocks / max(deg, 1)
            if self.overlap_mode:
                # each hop's transfer overlaps the concurrent block's
                # compute — only the exposed remainder is charged
                # (PR-13's bucket split applied to ring slices)
                exposed = max(hop_t - per_hop_block, 0.0)
            else:
                exposed = hop_t
            comm_f = (deg - 1) * exposed
            m = _measured("ring", deg=deg)
            if m is not None:
                t_impl = m              # the bench times hops included
                t_impl_b = 2.0 * m + comm_f   # bwd rings 2x payload
            else:
                t_impl = t_blocks + comm_f
                # backward rotates (k, v, dk, dv) — double payload
                t_impl_b = 2.0 * t_blocks + 2.0 * comm_f
        else:
            raise ValueError(f"unknown attention impl {impl_name!r}")

        fwd = rest_f + t_impl
        bwd = rest_b + t_impl_b
        cm = CostMetrics(forward_time=fwd, backward_time=bwd,
                         inputs_memory=base.inputs_memory,
                         outputs_memory=base.outputs_memory,
                         weights_memory=base.weights_memory)
        self._impl_cache[key] = cm
        if self.provenance is not None:
            row = None
            if self.calib is not None:
                from .calibration import CalibrationTable, shape_class
                d = seq_degree if impl_name == "ring" else 0
                if self.calib.op_time(f"attention@{impl_name}", q_bytes,
                                      degree=d) is not None:
                    row = CalibrationTable.key(
                        self.calib.op_backend(d),
                        f"op_attention@{impl_name}", "float32",
                        shape_class(q_bytes), d)
            self._prov("compute", f"op_attention@{impl_name}", row,
                       tier)
        return cm

    # ------------------------------------------------------------------
    def xfer_cost(self, volume_bytes: float, collective: str,
                  degree: int,
                  axes: Optional[Tuple[str, ...]] = None) -> float:
        """Collective time (ring algorithms): all-gather/reduce-scatter
        move (d-1)/d of the volume; all-reduce 2(d-1)/d; all-to-all
        (d-1)/d with per-hop latency.

        Multi-slice machines: a collective whose
        degree exceeds ``devices_per_slice`` necessarily crosses DCN;
        its cost is the standard hierarchical decomposition —
        intra-slice leg over ICI plus an inter-slice leg on the
        slice-reduced volume over DCN (reference analog: per-link-type
        simulation in ``src/runtime/network.cc`` /
        ``simulator.h:381-499``).

        Calibration v2: a persisted measured table for this
        (backend, collective, degree) answers first — real XLA
        collective timings at import-time shapes interpolated across
        shape classes; degrees never measured fall through to the
        fitted/analytic ring model."""
        obs_events.counter("costmodel.xfer_queries")
        floor = 0.0
        if self.calib is not None:
            kind = "all_to_all" if collective == "permute" else collective
            t = self.calib.collective_time(kind, degree, volume_bytes)
            if t is not None:
                if self.provenance is not None:
                    self._prov("xfer", f"coll_{kind}",
                               self.calib.row_key(kind, degree,
                                                  volume_bytes))
                return float(t)
            # even off-table, no collective is cheaper than one measured
            # host dispatch — the floor the host-blind model lacked
            floor = self.calib.dispatch_s or 0.0
        if self.provenance is not None and degree > 1 \
                and volume_bytes > 0:
            self._prov("xfer", None)     # analytic ring model
        ici_bw = (self.coll_bw or self.spec.ici_bandwidth) \
            / link_degradation_factor("ici")
        ici_lat = self.coll_lat if self.coll_lat is not None \
            else self.spec.ici_latency_us * 1e-6
        per_slice = self.spec.devices_per_slice
        if self.spec.num_slices > 1 and degree > per_slice:
            d_in = math.gcd(degree, per_slice) or 1
            d_out = degree // d_in
            t = (self._ring_cost(volume_bytes, collective, d_in,
                                 ici_bw, ici_lat)
                 + self._ring_cost(volume_bytes / max(d_in, 1),
                                   collective, d_out,
                                   self.spec.dcn_bandwidth
                                   / link_degradation_factor("dcn"),
                                   self.spec.dcn_latency_us * 1e-6))
        else:
            t = self._ring_cost(volume_bytes, collective, degree,
                                ici_bw, ici_lat)
        # zero-cost (elided) collectives stay free; everything real is
        # floored at one measured host dispatch
        return max(floor, t) if t > 0 else t

    def reshard_step_cost(self, kind: str, degree: int,
                          volume_bytes: float,
                          axes: Optional[Tuple[str, ...]] = None
                          ) -> float:
        """Cost of one step of a reshard plan (``parallel/reshard.py``):
        ``all_gather`` / ``all_to_all`` through ``xfer_cost`` (the
        calibrated collective rows answer first), ``slice`` a local block
        copy at the measured memory bandwidth plus one dispatch."""
        if degree <= 1 or volume_bytes <= 0:
            return 0.0
        if kind == "slice":
            mem_bw = self.spec.hbm_bandwidth
            dispatch = self.overhead_s
            if self.calib is not None:
                if self.calib.mem_bw:
                    mem_bw = self.calib.mem_bw
                if self.calib.dispatch_s:
                    dispatch = self.calib.dispatch_s
            return volume_bytes / max(mem_bw, 1.0) + dispatch
        return self.xfer_cost(volume_bytes, kind, degree, axes=axes)

    @staticmethod
    def _ring_cost(volume_bytes: float, collective: str, degree: int,
                   bw: float, lat: float) -> float:
        if degree <= 1 or volume_bytes <= 0:
            return 0.0
        frac = (degree - 1) / degree
        mult = bandwidth_multiplier(collective, degree)
        return mult * frac * volume_bytes / bw + (degree - 1) * lat

    def decode_collective_cost(self, volume_bytes: float,
                               collective: str, degree: int,
                               axes: Optional[Tuple[str, ...]] = None
                               ) -> float:
        """Latency-side price of ONE decode-step collective (the serving
        search, ``serving_plan.py``). Decode-step payloads are tiny
        ((bucket x hidden) activations at sequence length 1) and fire
        once per generated token, so nothing coalesces them across
        tokens: routed through :meth:`xfer_cost` (calibrated
        small-message rows, dispatch floor), never a bandwidth-marginal
        path."""
        return self.xfer_cost(volume_bytes, collective, degree,
                              axes=axes)

    def kv_read_time(self, kv_bytes: float) -> float:
        """HBM time to stream a resident KV cache once: the per-step
        memory floor of autoregressive decode (every step reads the full
        local cache). Uses the calibrated memory bandwidth when a
        calibration is attached."""
        if kv_bytes <= 0:
            return 0.0
        mem_bw = self.spec.hbm_bandwidth
        if self.calib is not None and self.calib.mem_bw:
            mem_bw = self.calib.mem_bw
        return kv_bytes / max(mem_bw, 1.0)

    def resharding_cost(self, tensor_bytes: float,
                        src_degrees: Dict[int, int],
                        dst_degrees: Dict[int, int]) -> float:
        """Cost of moving a tensor between two dim->degree layouts
        (reference ``estimate_xfer_cost`` / Repartition special case)."""
        if src_degrees == dst_degrees:
            return 0.0
        src_total = int(np.prod(list(src_degrees.values()))) \
            if src_degrees else 1
        dst_total = int(np.prod(list(dst_degrees.values()))) \
            if dst_degrees else 1
        if src_total == 1 and dst_total > 1:
            return 0.0  # slicing a replicated tensor is local
        if dst_total == 1:
            return self.xfer_cost(tensor_bytes, "all_gather", src_total)
        same_dims = set(src_degrees) == set(dst_degrees)
        if same_dims:
            return self.xfer_cost(tensor_bytes, "permute",
                                  max(src_total, dst_total))
        return self.xfer_cost(tensor_bytes, "all_to_all",
                              max(src_total, dst_total))

    def weight_sync_cost(self, weight_bytes: float, dp_degree: int,
                         axes: Optional[Tuple[str, ...]] = None) -> float:
        """Per-step gradient all-reduce (reference NCCL optimizer path).

        Calibrated (single-tier): priced at the measured curve's
        MARGINAL (per-byte) cost — XLA's all-reduce combiner coalesces
        per-layer gradient reductions into a few large collectives, so
        the fixed dispatch floor is paid once per step, not once per op
        (calibration.MeshCalibration.collective_marginal)."""
        self.last_sync_wire = "float32"
        t = None
        if self.calib is not None and dp_degree > 1 and weight_bytes > 0:
            t = self.calib.collective_marginal("all_reduce", dp_degree,
                                               weight_bytes)
            if t is not None:
                t = float(t)
        if t is None:
            n0 = len(self.provenance) if self.provenance is not None \
                else 0
            t = self.xfer_cost(weight_bytes, "all_reduce", dp_degree)
            if self.provenance is not None:
                # the fallthrough priced through xfer_cost, but this IS
                # the gradient sync — drift diffs it under "sync"
                for row in self.provenance[n0:]:
                    row["term"] = "sync"
        elif self.provenance is not None:
            self._prov("sync", "coll_all_reduce",
                       self.calib.row_key("all_reduce", dp_degree,
                                          weight_bytes))
        # the quantized flat candidate (ops/quantized_collectives.py):
        # "auto" takes it where it prices cheaper, "all" mandates it;
        # dcn_only narrows tree legs only, and a flat sync has none
        q = self.quantization
        if q is not None and q["mode"] in ("auto", "all") \
                and dp_degree > 1 and weight_bytes > 0:
            qc = self._flat_wire_sync(weight_bytes, dp_degree, q["wire"])
            if q["mode"] == "all" or qc < t:
                self.last_sync_wire = q["wire"]
                if self.provenance is not None:
                    from ..ops.quantized_collectives import wire_byte_scale
                    self._prov("sync", "coll_all_reduce",
                               self.calib.row_key(
                                   "all_reduce", dp_degree,
                                   weight_bytes
                                   * wire_byte_scale(q["wire"]))
                               if self.calib is not None else None,
                               None)
                    self.provenance[-1]["wire"] = q["wire"]
                return qc
        return t



def _backend(dmesh=None) -> str:
    """The backend name rows and kernel predicates key on: "cuda" or
    "cpu", from the mesh's devices (a described mesh has none and
    prices for the card)."""
    devs = getattr(dmesh, "devices", None) if dmesh is not None else None
    if devs:
        return devs[0].type
    return "cuda"
