"""Measurement-grounded cost-model calibration (v2), on one device.

The port of the single-device half of ``flexflow_tpu/search/
calibration.py``. The analytic cost model prices compute from datasheet
FLOP/s and bytes; this module measures, on the card, what it cannot
know: the **host dispatch** cost of one eager op (the port runs the graph
op by op, so every kernel pays it), the **memory bandwidth** a streaming
read reaches, and the **attention impls** the kernel tier chooses
between (``op_attention@xla``: the plain materialized-scores attention;
``op_attention@flash``: ``flash_attention``, on the card the CUDA forward
kernel, ``csrc/flash_attention_fwd.cu``). Rows persist in one JSON table
keyed ``backend|kind|dtype|shape_class|axis_size`` with backend
``cuda`` (``cpu`` when run on the CPU), the JAX package's format and
keys, so a table written by either package loads in the other. A warm
table makes a calibration measurement-free.

The port's table defaults to ``<repo>/.ffcache/torch/calibration_v2.json``
(``config.default_cache_dir``; ``FF_CACHE_DIR`` moves it), never the JAX
package's file. Every
microbenchmark times between CUDA events (the host clock around a device
sync on the CPU). A CUDA failure raises; only a missing or unreadable
table file is skipped. Not ported (ROADMAP queue 1 item 5): the
collective rows (``coll_*``, ``ring``, ``parallel_eff``), which need
several live devices, and the drift detector's stale-row sidecar.

Opt-in: ``FFConfig.calibration_v2 = "true"`` or ``FF_CALIBRATION_V2=1``
("auto" honors the env var only).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import events as obs_events
from ..config import default_cache_dir
from .costmodel import _backend, _cuda_sync, event_time

#: the table's directory; None = ``config.default_cache_dir()``
_DEFAULT_DIR: Optional[str] = None

#: attention-core payload sizes for the kernel-impl rows
#: (op_attention@<impl>): q bytes at (b=1, h=8, d=64, f32) — the two
#: classes are s=128 and s=512; longer contexts extrapolate on the pair
ATTN_IMPL_SIZES = (1 << 16, 1 << 20)


def shape_class(nbytes: int) -> int:
    """Power-of-two size bucket: measurements and lookups for payloads
    within the same factor-of-2 band share one table entry."""
    if nbytes <= 1:
        return 1
    return 1 << int(round(math.log2(nbytes)))


class CalibrationTable:
    """Persistent microbenchmark results, one JSON file per cache dir.

    Every entry is keyed ``backend|kind|dtype|shape_class|axis_size`` so
    a value measured on one backend (or for one dtype) can never be
    served for another. ``measured`` counts live microbenchmarks run by
    THIS process — a second process loading a warm table must report 0.
    """

    def __init__(self, cache_dir: Optional[str] = None):
        self._cache_dir = cache_dir or _DEFAULT_DIR or default_cache_dir()
        self._data: Optional[Dict[str, float]] = None
        self.measured = 0          # live measurements this process

    @property
    def path(self) -> str:
        return os.path.join(self._cache_dir, "calibration_v2.json")

    @staticmethod
    def key(backend: str, kind: str, dtype: str = "-",
            sclass: int = 0, axis_size: int = 0) -> str:
        return f"{backend}|{kind}|{dtype}|{sclass}|{axis_size}"

    def _load(self) -> Dict[str, float]:
        if self._data is None:
            try:
                with open(self.path) as f:
                    self._data = {k: float(v)
                                  for k, v in json.load(f).items()}
            except (OSError, ValueError):   # missing or unreadable
                self._data = {}
        return self._data

    def get(self, backend: str, kind: str, dtype: str = "-",
            sclass: int = 0, axis_size: int = 0) -> Optional[float]:
        return self._load().get(
            self.key(backend, kind, dtype, sclass, axis_size))

    def put(self, backend: str, kind: str, dtype: str, sclass: int,
            axis_size: int, value: float) -> None:
        data = self._load()
        data[self.key(backend, kind, dtype, sclass, axis_size)] = value
        try:
            os.makedirs(self._cache_dir, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f)
            os.replace(tmp, self.path)
        except OSError:  # an unwritable table costs re-measurements
            pass

    def get_or_measure(self, backend: str, kind: str, dtype: str,
                       sclass: int, axis_size: int,
                       fn: Callable[[], float]) -> float:
        """Serve from the table; run ``fn`` (a microbenchmark) only on a
        genuine miss, recording the result for future processes. A
        failing microbenchmark raises."""
        hit = self.get(backend, kind, dtype, sclass, axis_size)
        if hit is not None:
            obs_events.counter("calibration.cache_hits")
            return hit
        obs_events.counter("calibration.cache_misses")
        with obs_events.span("calibration.measure", kind=kind,
                             axis_size=axis_size, sclass=sclass):
            v = float(fn())
        self.measured += 1
        self.put(backend, kind, dtype, sclass, axis_size, v)
        return v

    def entries(self, backend: str, kind: str, dtype: str = "-",
                axis_size: int = 0) -> List[Tuple[int, float]]:
        """(shape_class, value) pairs for one (backend, kind, dtype,
        axis-size), sorted by shape class — interpolation input."""
        prefix = f"{backend}|{kind}|{dtype}|"
        suffix = f"|{axis_size}"
        out = []
        for k, v in self._load().items():
            if k.startswith(prefix) and k.endswith(suffix):
                out.append((int(k[len(prefix):-len(suffix)]), v))
        return sorted(out)


# ----------------------------------------------------------------------
# microbenchmarks (each returns seconds, or bytes/s for the bandwidth)
# ----------------------------------------------------------------------

def _device_of(dmesh=None):
    import torch
    devs = getattr(dmesh, "devices", None) if dmesh is not None else None
    return torch.device(devs[0]) if devs else torch.device("cuda")


def _timed(fn, device, warmup: int = 2, repeats: int = 5) -> float:
    """MIN over repeats of one ``fn()`` between CUDA events (the host
    clock on the CPU): contention only adds time, and a polluted value
    persisted to the table is served forever."""
    return event_time(fn, device, warmup=warmup, repeats=repeats,
                      reduce=min)


def _bench_dispatch(device=None) -> float:
    """Host cost of dispatching one eager op: 256 back-to-back trivial
    adds on a tiny tensor, on the host clock up to a device sync, per op
    (min of 5). The JAX package times one jitted call and its fetch; the
    port runs every op eagerly, so this is the floor under each op."""
    import torch
    dev = torch.device(device or "cuda")
    x = torch.zeros((8,), dtype=torch.float32, device=dev)
    n = 256
    best = None
    for _ in range(5):
        _cuda_sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            x = x + 1.0
        _cuda_sync(dev)
        dt = (time.perf_counter() - t0) / n
        best = dt if best is None else min(best, dt)
    return float(best)


def _bench_membw(nbytes: int = 1 << 30, device=None) -> float:
    """Effective memory bandwidth (bytes/s) of a streaming read of
    ``nbytes`` (a sum over an f32 buffer, which reads it once)."""
    import torch
    dev = torch.device(device or "cuda")
    x = torch.ones((nbytes // 4,), dtype=torch.float32, device=dev)
    dt = _timed(lambda: x.sum(), dev, warmup=2, repeats=5)
    return nbytes / dt


def _attn_seq_len(nbytes: int, deg: int = 1) -> int:
    """Sequence length whose q payload is ``nbytes`` at the canonical
    bench geometry (b=1, h=8, d=64, f32), rounded so flash blocks and
    ring chunks both divide."""
    s = max(nbytes // (4 * 8 * 64), 128)
    step = 128 * max(deg, 1)
    return max(s - s % step, step)


def attention_bench_fn(impl: str, s: int, device=None):
    """The zero-argument call ``_bench_attention_impl`` times: one
    causal attention core at sequence length ``s``, b=1, h=8, d=64, f32.
    ``xla`` is the materialized-scores reference (the plain path);
    ``flash`` is ``flash_attention``: the CUDA forward kernel on the
    card, its plain twin on the CPU."""
    import torch
    dev = torch.device(device or "cuda")
    b, h, d = 1, 8, 64
    rng = np.random.default_rng(0)

    def arg():
        return torch.from_numpy((rng.standard_normal((b, h, s, d))
                                 * 0.02).astype(np.float32)).to(dev)

    q, k, v = arg(), arg(), arg()
    sc = 1.0 / math.sqrt(d)
    if impl == "xla":
        i = torch.arange(s, device=dev)
        keep = i[None, :] <= i[:, None]

        def f():
            sm = torch.einsum("bhqd,bhkd->bhqk", q, k) * sc
            sm = torch.where(keep, sm, torch.full_like(sm, -1e9))
            p = torch.softmax(sm, dim=-1)
            return torch.einsum("bhqk,bhkd->bhqd", p, v)
    elif impl == "flash":
        from ..kernels.flash_attention import flash_attention

        def f():
            return flash_attention(q, k, v, causal=True)
    elif impl == "ring":
        raise NotImplementedError(
            "ring attention rows need a mesh sequence axis of live "
            "devices (ROADMAP queue 1 item 4)")
    else:
        raise ValueError(impl)
    return f


def _bench_attention_impl(impl: str, s: int, device=None) -> float:
    """Forward time of one attention core (``attention_bench_fn``) — the
    measured anchor for the kernel tier (``op_attention@<impl>``)."""
    import torch
    with torch.no_grad():
        return _timed(attention_bench_fn(impl, s, device), device,
                      repeats=3)


def calibrate_kernel_impls(dmesh=None,
                           table: Optional[CalibrationTable] = None,
                           cache_dir: Optional[str] = None,
                           impls: Tuple[str, ...] = ("xla", "flash",
                                                     "ring"),
                           sizes: Tuple[int, ...] = ATTN_IMPL_SIZES
                           ) -> CalibrationTable:
    """Measure (or warm-load) the kernel-impl rows the kernel tier
    prices from: ``op_attention@<impl>`` keyed by the q payload's shape
    class. ``ring`` needs a mesh sequence axis, which one device lacks,
    so it records nothing. Called by the search and by
    ``FFModel._plan_kernels``."""
    tab = table if table is not None else CalibrationTable(cache_dir)
    backend = _backend(dmesh)
    device = _device_of(dmesh)
    for impl in impls:
        if impl == "ring":
            continue                   # no seq axis: no ring row
        for s in sorted({_attn_seq_len(nb) for nb in sizes}):
            # keyed by the ACTUAL q payload of the benched shape
            qbytes = 4 * 8 * 64 * s
            tab.get_or_measure(
                backend, f"op_attention@{impl}", "float32",
                shape_class(qbytes), 0,
                lambda i=impl, n=s: _bench_attention_impl(i, n, device))
    return tab


# ----------------------------------------------------------------------
# the attachable calibration object
# ----------------------------------------------------------------------

@dataclasses.dataclass
class MeshCalibration:
    """Measured host + collective terms the cost model consults.

    ``collective_time`` answers from the persisted table by log-log
    interpolation between the measured shape classes of the matching
    (backend, collective, dtype, axis-size) row; a query for a degree
    that was never measured returns None and the cost model falls back
    to its fitted/analytic path.
    """
    backend: str
    dispatch_s: Optional[float] = None
    mem_bw: Optional[float] = None
    parallel_eff: Dict[int, float] = dataclasses.field(default_factory=dict)
    table: Optional[CalibrationTable] = None
    dtype: str = "float32"
    # lookup memos — collective_time sits inside xfer_cost, the
    # search's hottest evaluator loop (1e4-1e6 calls per search): the
    # full-table key scans are done once per (coll, degree)
    _pts: Dict = dataclasses.field(default_factory=dict, repr=False)
    _degs: Dict = dataclasses.field(default_factory=dict, repr=False)

    def _points(self, coll: str, degree: int,
                tier: Optional[str] = None,
                dtype: Optional[str] = None) -> List[Tuple[int, float]]:
        """Measured (shape_class, seconds) points for one collective at
        one degree. ``tier`` selects the tier-keyed rows
        (``coll_<kind>@<tier>``, written by :func:`calibrate_mesh` on
        multi-tier meshes); flat rows remain the fallback so warm
        pre-tier tables keep answering without re-measurement.
        ``dtype`` selects wire-dtype rows (``int8``/``float8_*``,
        measured by :func:`calibrate_mesh` when quantized collectives
        are enabled) instead of the default element dtype."""
        kind = f"{coll}@{tier}" if tier else coll
        dt = dtype or self.dtype
        key = (kind, degree, dt)
        hit = self._pts.get(key)
        if hit is None:
            hit = self.table.entries(self.backend, f"coll_{kind}",
                                     dt, axis_size=degree)
            self._pts[key] = hit
        return hit

    def efficiency(self, n_shards: int) -> float:
        """Measured parallel efficiency for ``n_shards`` concurrent shard
        tasks (1.0 = ideal). Unmeasured widths interpolate between the
        measured ones (ideal at 1)."""
        if n_shards <= 1 or not self.parallel_eff:
            return 1.0
        if n_shards in self.parallel_eff:
            return self.parallel_eff[n_shards]
        pts = sorted(self.parallel_eff.items())
        lo_n, lo_e = 1, 1.0
        for n, e in pts:
            if n >= n_shards:
                # linear in log(n): eff falls off as oversubscription grows
                t = ((math.log(n_shards) - math.log(lo_n))
                     / max(math.log(n) - math.log(lo_n), 1e-9))
                return lo_e + t * (e - lo_e)
            lo_n, lo_e = n, e
        return pts[-1][1]          # wider than measured: worst measured

    def _degrees_measured(self, coll: str) -> List[int]:
        if self.table is None:
            return []
        hit = self._degs.get(coll)
        if hit is None:
            prefix = f"{self.backend}|coll_{coll}|{self.dtype}|"
            out = set()
            for k in self.table._load():
                if k.startswith(prefix):
                    out.add(int(k.rsplit("|", 1)[1]))
            hit = sorted(out)
            self._degs[coll] = hit
        return hit

    def collective_time(self, coll: str, degree: int, nbytes: float,
                        tier: Optional[str] = None,
                        dtype: Optional[str] = None) -> Optional[float]:
        if self.table is None or degree <= 1 or nbytes <= 0:
            return None
        if dtype is not None:
            # wire-dtype rows are measured opportunistically (quantized
            # collectives enabled): STRICT like tier rows — a miss
            # returns None and the caller falls back to the
            # itemsize-scaled float32 query, never a wrong row
            pts = self._points(coll, degree, tier, dtype=dtype)
            if not pts:
                return None
            return self._interp(pts, nbytes)
        if tier is not None:
            # STRICT: a tier-scoped query answers only from rows
            # measured for that tier. Falling back to the flat rows
            # here would price a DCN leg at the innermost fabric's
            # measured speed (~20x under on the virtual 2-slice config)
            # — the caller's fallback is the tier's machine-model
            # constants, not a wrong measurement. Flat (tier=None)
            # queries keep the whole warm table, so pre-tier caches
            # still answer with zero re-measurement.
            pts = self._points(coll, degree, tier)
            if not pts:
                return None
        else:
            pts = self._points(coll, degree)
        if not pts:
            # nearest measured degree (log distance): a degree-3 query
            # on a mesh measured at {2, 4, 8} answers from the closest
            # curve rather than falling to the host-blind analytic model
            degs = self._degrees_measured(coll)
            if not degs:
                return None
            near = min(degs, key=lambda d: abs(math.log(d)
                                               - math.log(degree)))
            if not (0.5 <= near / degree <= 2.0):
                return None          # too far to stand in
            pts = self._points(coll, near)
        return self._interp(pts, nbytes)

    def op_time(self, kind: str, nbytes: float,
                degree: int = 0) -> Optional[float]:
        """Measured time of one kernel-impl row (``op_<kind>`` —
        e.g. ``attention@ring``), interpolated across the measured
        shape classes. ``degree`` keys the rows that depend on a mesh
        axis size (ring's seq degree); 0 for degree-free impls. None =
        never measured — the cost model falls back to its analytic
        curve for that impl."""
        if self.table is None or nbytes <= 0:
            return None
        key = (f"op:{kind}", degree, self.dtype)
        pts = self._pts.get(key)
        if pts is None:
            pts = self.table.entries(self.backend, f"op_{kind}",
                                     self.dtype, axis_size=degree)
            self._pts[key] = pts
        if not pts:
            return None
        return self._interp(pts, nbytes)

    @staticmethod
    def _interp(pts: List[Tuple[int, float]], nbytes: float) -> float:
        # at/below the smallest measured class the fixed dispatch/
        # rendezvous floor dominates: CLAMP, never extrapolate downward
        # (a 16 KiB collective does not cost 16/64 of the 64 KiB one)
        if nbytes <= pts[0][0]:
            return pts[0][1]
        if len(pts) == 1:
            sc, t = pts[0]
            return t * nbytes / sc   # single point: linear in volume
        # log-log interpolation (upward extrapolation on the top pair)
        xs = [math.log(sc) for sc, _ in pts]
        ys = [math.log(max(t, 1e-12)) for _, t in pts]
        x = math.log(max(nbytes, 1.0))
        i = 1
        while i < len(xs) - 1 and xs[i] < x:
            i += 1
        slope = (ys[i] - ys[i - 1]) / max(xs[i] - xs[i - 1], 1e-9)
        y = ys[i - 1] + slope * (x - xs[i - 1])
        return math.exp(y)

    def row_key(self, coll: str, degree: int, nbytes: float,
                tier: Optional[str] = None) -> Optional[str]:
        """Full table key (``backend|kind|dtype|shape_class|axis_size``)
        of the measured row anchoring a :meth:`collective_time` answer —
        the nearest measured shape class at the answering degree (the
        provenance an audit entry records). None = the query would not
        answer from the table (the prediction came from the analytic
        model instead)."""
        if self.table is None or degree <= 1 or nbytes <= 0:
            return None
        kind = f"{coll}@{tier}" if tier else coll
        pts = self._points(coll, degree, tier)
        deg = degree
        if not pts and tier is None:
            degs = self._degrees_measured(coll)
            if degs:
                near = min(degs, key=lambda d: abs(math.log(d)
                                                   - math.log(degree)))
                if 0.5 <= near / degree <= 2.0:
                    deg = near
                    pts = self._points(coll, near)
        if not pts:
            return None
        sc = min(pts, key=lambda p: abs(
            math.log(max(p[0], 1)) - math.log(max(nbytes, 1.0))))[0]
        return CalibrationTable.key(self.backend, f"coll_{kind}",
                                    self.dtype, sc, deg)

    def collective_marginal(self, coll: str, degree: int,
                            nbytes: float,
                            dtype: Optional[str] = None
                            ) -> Optional[float]:
        """Per-byte MARGINAL cost of a collective — the measured curve's
        top-range slope times the volume, with the fixed dispatch/
        rendezvous floor amortized away. This prices per-op gradient
        all-reduces: XLA's all-reduce combiner coalesces the per-layer
        reductions of a training step into a few large collectives, so
        the executed program pays the floor once, not once per layer —
        charging it per op made every many-layer DP baseline look
        ~per-layer-floor too expensive and inverted the searched-vs-DP
        ranking on dense tower models (candle/mlp)."""
        if self.table is None or degree <= 1 or nbytes <= 0:
            return None
        full = self.collective_time(coll, degree, nbytes, dtype=dtype)
        if full is None:
            return None
        pts = self._points(coll, degree, dtype=dtype)
        if dtype is not None and len(pts) < 2:
            # wire-dtype rows: no nearest-degree stand-in (strict, like
            # tier rows) — fall back to the top point's average
            return full
        if not pts:
            degs = self._degrees_measured(coll)
            if not degs:
                return full
            near = min(degs, key=lambda d: abs(math.log(d)
                                               - math.log(degree)))
            pts = self._points(coll, near)
        if len(pts) < 2:
            return full
        (s1, t1), (s2, t2) = pts[-2], pts[-1]
        slope = (t2 - t1) / max(s2 - s1, 1.0)
        if slope <= 0.0:
            # non-monotone measured pair (transient load during the
            # smaller bench, persisted forever): fall back to the top
            # point's average per-byte cost rather than pricing every
            # gradient all-reduce at zero
            slope = t2 / max(s2, 1.0)
        return min(full, slope * nbytes)


def calibrate_mesh(dmesh=None, cache_dir: Optional[str] = None,
                   table: Optional[CalibrationTable] = None
                   ) -> MeshCalibration:
    """Measure (or load) the host dispatch and memory-bandwidth terms on
    the mesh's device. A warm table makes this measurement-free. A
    described multi-device mesh gets no collective rows (there are no
    devices to time them on); a live one would need them, which is not
    ported."""
    if dmesh is not None and dmesh.num_devices > 1 and not dmesh.described:
        raise NotImplementedError(
            "collective calibration rows need several live devices "
            "(ROADMAP queue 1 item 4)")
    with obs_events.span("search.calibrate_mesh"):
        backend = _backend(dmesh)
        device = _device_of(dmesh)
        tab = table if table is not None else CalibrationTable(cache_dir)
        calib = MeshCalibration(backend=backend, table=tab)
        calib.dispatch_s = tab.get_or_measure(
            backend, "host_dispatch", "-", 0, 0,
            lambda: _bench_dispatch(device))
        calib.mem_bw = tab.get_or_measure(
            backend, "host_membw", "-", 0, 0,
            lambda: _bench_membw(device=device))
        return calib


def calibration_enabled(cfg=None) -> bool:
    """Resolve the opt-in: config "true"/"false" wins; "auto" (and no
    config at all) honors the FF_CALIBRATION_V2 env var."""
    mode = str(getattr(cfg, "calibration_v2", "auto") or "auto").lower()
    if mode in ("true", "on", "1", "yes"):
        return True
    if mode in ("false", "off", "0", "no"):
        return False
    return os.environ.get("FF_CALIBRATION_V2", "").lower() \
        in ("1", "true", "yes", "on")
