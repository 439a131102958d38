"""Machine model: device mesh + interconnect description.

The port of ``flexflow_tpu/parallel/machine.py``. ``MachineSpec`` holds
the constants the cost model prices with: peak bf16 FLOP/s, HBM size
and bandwidth, per-link fabric bandwidth and latency, the slice and host
structure. The TPU generations keep the JAX package's table, so a
machine file describes the same machine in both packages; ``h100`` adds
the card this port runs on. ``DeviceMesh`` factorizes the device count
into atomic axes (prime factors, largest first); a search-assigned
parallel degree is realized as a subset of axes whose sizes multiply to
it. The mesh holds the ``torch.device`` list it executes on; a mesh
that describes more devices than the process has is a *described*
mesh, which the search scores and exports and ``FFModel.compile``
refuses to run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _prime_factors(n: int) -> List[int]:
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)


# Per-generation hardware constants (public figures; bf16 FLOP/s).
TPU_GENERATIONS = {
    # name: (peak bf16 TFLOP/s, HBM GiB, HBM GB/s, ICI GB/s per link (one dir))
    "v4": (275.0, 32.0, 1228.0, 50.0),
    "v5e": (197.0, 16.0, 819.0, 50.0),
    "v5p": (459.0, 95.0, 2765.0, 100.0),
    "v6e": (918.0, 32.0, 1640.0, 90.0),
    "cpu-sim": (0.2, 8.0, 50.0, 5.0),
}

# GPU constants, same columns. h100: NVIDIA's published H100 SXM5 figures
# (H100 Tensor Core GPU datasheet): 989.4 dense bf16 TFLOP/s, 80 GB of
# HBM3 at 3.35 TB/s, fourth-generation NVLink at 900 GB/s per GPU in both
# directions together (450 GB/s each way). ``MachineSpec.detect`` takes
# the HBM size of the card at hand from ``torch.cuda``.
GPU_GENERATIONS = {
    "h100": (989.4, 80.0, 3350.0, 450.0),
}

GENERATIONS = {**TPU_GENERATIONS, **GPU_GENERATIONS}


@dataclasses.dataclass
class MachineSpec:
    """Description of the target machine for both execution and simulation."""
    num_devices: int = 1
    generation: str = "v5e"
    # physical ICI topology, e.g. (4, 8) for v5e-32; product may exceed
    # num_devices for partial slices
    ici_shape: Optional[Tuple[int, ...]] = None
    num_slices: int = 1                     # multi-slice via DCN
    num_hosts: int = 1                      # controller hosts (DCN NICs)
    dcn_bandwidth_gbps: float = 25.0        # per-host DCN
    ici_latency_us: float = 1.0
    dcn_latency_us: float = 10.0
    # machine-file overrides of the per-generation constants
    # (``--machine-model-file``, parallel/topology.py:load_machine_file)
    ici_bandwidth_override: Optional[float] = None
    peak_flops_override: Optional[float] = None
    # cross-host-within-slice fabric override (bytes/s, us): unset on
    # TPU pods (ICI spans hosts inside a slice), set by reference-style
    # machine files whose inter-host fabric is a NIC
    host_bandwidth_override: Optional[float] = None
    host_latency_override_us: Optional[float] = None
    # explicit fabric (parallel/topology.py GraphTopology): big-switch,
    # degraded-link, or custom connection matrices — the reference's
    # NetworkedMachineModel (simulator.h:381-515). None = derive from
    # ici_shape (+ multi-slice DCN when num_slices > 1).
    topology_override: Optional[object] = None
    # the detected card's device memory in bytes (``detect`` on CUDA);
    # None = the generation table's figure
    hbm_bytes_override: Optional[float] = None

    @property
    def peak_flops(self) -> float:
        if self.peak_flops_override is not None:
            return self.peak_flops_override
        return GENERATIONS[self.generation][0] * 1e12

    @property
    def hbm_bytes(self) -> float:
        if self.hbm_bytes_override is not None:
            return self.hbm_bytes_override
        return GENERATIONS[self.generation][1] * (1 << 30)

    @property
    def hbm_bandwidth(self) -> float:
        return GENERATIONS[self.generation][2] * 1e9

    @property
    def ici_bandwidth(self) -> float:
        if self.ici_bandwidth_override is not None:
            return self.ici_bandwidth_override
        return GENERATIONS[self.generation][3] * 1e9

    @property
    def topology(self):
        """The physical fabric: an explicit ``topology_override`` when
        set, a multi-slice ICI+DCN graph when ``num_slices > 1`` with a
        known ``ici_shape``, a plain ICI torus when single-slice, else
        None. Memoized per spec: the topology carries route/distance
        caches that must persist across the search's thousands of
        task-graph builds (rebuilding it per build cost ~35 s of Dijkstra
        on the 64-device two-slice north-star). The memo is keyed on
        every field the fabric derives from, so mutating the spec after
        construction (dataclass fields are writable) invalidates it
        instead of silently pinning the stale fabric into search costs."""
        if self.topology_override is not None:
            return self.topology_override
        if self.ici_shape is None:
            return None
        key = (tuple(self.ici_shape), self.num_slices, self.num_hosts,
               self.ici_bandwidth, self.dcn_bandwidth)
        cached = self.__dict__.get("_topology_cache")
        if cached is not None and cached[0] == key:
            return cached[1]
        if self.num_slices > 1:
            from .topology import GraphTopology
            topo = GraphTopology.multi_slice_torus(
                tuple(self.ici_shape), self.num_slices,
                ici_bw=self.ici_bandwidth, dcn_bw=self.dcn_bandwidth,
                hosts_per_slice=max(
                    1, self.num_hosts // max(1, self.num_slices)))
        else:
            from .topology import TorusTopology
            topo = TorusTopology(tuple(self.ici_shape))
        object.__setattr__(self, "_topology_cache", (key, topo))
        return topo

    @property
    def tier_graph(self):
        """The machine's bandwidth-tier ladder
        (:class:`~flexflow_tpu_torch.parallel.topology.TierGraph`): ici /
        host / dcn with per-tier bandwidth+latency — what the placement
        search, cost model and plan verifier query instead of a single
        flat number. Memoized per spec, keyed on every field the ladder
        derives from (same invalidation discipline as ``topology``)."""
        from .topology import TierGraph
        key = (self.num_devices, self.num_slices, self.num_hosts,
               self.ici_bandwidth, self.dcn_bandwidth,
               self.ici_latency_us, self.dcn_latency_us,
               self.host_bandwidth_override,
               self.host_latency_override_us)
        cached = self.__dict__.get("_tier_graph_cache")
        if cached is not None and cached[0] == key:
            return cached[1]
        tg = TierGraph.from_machine_spec(self)
        object.__setattr__(self, "_tier_graph_cache", (key, tg))
        return tg

    @classmethod
    def from_file(cls, path: str) -> "MachineSpec":
        """Load a machine description (``--machine-model-file``); see
        ``parallel/topology.py:load_machine_file`` for the formats."""
        from .topology import load_machine_file
        return load_machine_file(path)

    @property
    def dcn_bandwidth(self) -> float:
        """Inter-slice (per-host NIC) bandwidth in bytes/s."""
        return self.dcn_bandwidth_gbps * 1e9

    @property
    def devices_per_slice(self) -> int:
        """Devices reachable over ICI alone; collectives of larger degree
        must cross DCN (the cost model's slice boundary)."""
        return max(1, self.num_devices // max(1, self.num_slices))

    @classmethod
    def detect(cls, device=None) -> "MachineSpec":
        """The machine the process runs on: one device, the model's.
        A CUDA device yields the ``h100`` generation with the card's own
        device memory (another card keeps the H100 constants and logs a
        warning); the CPU yields ``cpu-sim``."""
        import logging

        import torch
        dev = torch.device(device if device is not None else "cuda")
        log = logging.getLogger("flexflow_tpu_torch")
        if dev.type != "cuda":
            return cls(num_devices=1, generation="cpu-sim")
        props = torch.cuda.get_device_properties(
            dev.index if dev.index is not None
            else torch.cuda.current_device())
        if "h100" not in props.name.lower().replace(" ", ""):
            log.warning(
                "MachineSpec.detect: unknown card %r; pricing with the "
                "h100 constants — pass an explicit MachineSpec or a "
                "machine-model file if this is wrong", props.name)
        else:
            log.info("MachineSpec.detect: 1 x h100 (%s)", props.name)
        return cls(num_devices=1, generation="h100",
                   hbm_bytes_override=float(props.total_memory))


class DeviceMesh:
    """Factorized global mesh. Axis names are ``x0, x1, ...`` sized by the
    prime factorization of the device count (largest factor first).
    ``devices`` are the ``torch.device``s it executes on; none, or fewer
    than ``spec.num_devices``, make it a described mesh
    (``described``, ``devices`` None). The JAX package's ``mesh`` (a
    ``jax.sharding.Mesh``) has no counterpart: axis names and sizes are
    ``axis_names`` / ``axis_sizes``."""

    def __init__(self, spec: MachineSpec, devices=None,
                 mesh_shape: Optional[Sequence[int]] = None,
                 seq: int = 0):
        import torch
        self.spec = spec
        devices = [torch.device(d) for d in (devices or ())]
        # a described mesh: more devices than the process executes on
        # (the search scores it; nothing runs on it)
        self.described = spec.num_devices > len(devices)
        self.devices = None if self.described \
            else devices[: spec.num_devices]
        self.dcn_axis: Optional[str] = None
        # dedicated sequence-parallel (context) axis: carved as the
        # TRAILING axis so its devices are contiguous (fastest fabric —
        # ring-attention hops belong on ICI). Reserved: the general
        # search never shards batch/params over it (allocate_axes /
        # valid_degrees exclude it); only ring attention consumes it.
        self.seq_axis: Optional[str] = None
        n = spec.num_devices if self.described else len(self.devices)
        seq = int(seq or 0)
        if seq > 1:
            if n % seq != 0:
                raise ValueError(
                    f"--seq-parallel {seq} does not divide {n} devices")
            n_rest = n // seq
        else:
            seq, n_rest = 0, n
        slices = spec.num_slices if (spec.num_slices > 1
                                     and n % spec.num_slices == 0) else 1
        if seq and slices > 1 and (n_rest % slices != 0):
            raise ValueError(
                f"--seq-parallel {seq} does not compose with "
                f"{slices} slices over {n} devices (the seq axis must "
                f"stay inside a slice)")
        if mesh_shape is not None:
            factors = [int(s) for s in mesh_shape if int(s) > 1] or [1]
            if seq and int(np.prod(factors)) * seq == n:
                # an explicit mesh_shape describes the non-seq axes
                self.axis_sizes: Dict[str, int] = {
                    f"x{i}": f for i, f in enumerate(factors)}
            else:
                self.axis_sizes = {
                    f"x{i}": f for i, f in enumerate(factors)}
                seq = 0
        elif slices > 1:
            # leading "dcn" axis spans slices/hosts: devices are ordered
            # slice-major, so each slice's devices stay contiguous along
            # the inner (ICI) axes
            inner = _prime_factors(n_rest // slices) or [1]
            self.axis_sizes = {"dcn": slices,
                               **{f"x{i}": f for i, f in enumerate(inner)}}
            self.dcn_axis = "dcn"
        else:
            factors = _prime_factors(n_rest) or [1]
            self.axis_sizes = {f"x{i}": f for i, f in enumerate(factors)}
        if seq:
            self.axis_sizes["seq"] = seq
            self.seq_axis = "seq"
        if int(np.prod(list(self.axis_sizes.values()))) != n:
            raise ValueError(
                f"mesh {dict(self.axis_sizes)} does not cover {n} devices")

    @property
    def seq_degree(self) -> int:
        """Size of the dedicated sequence axis (1 = no seq axis)."""
        return self.axis_sizes.get("seq", 1) if self.seq_axis else 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.axis_sizes.keys())

    @property
    def num_devices(self) -> int:
        return int(np.prod(list(self.axis_sizes.values()))) if self.axis_sizes else 1

    @property
    def axis_tiers(self) -> Dict[str, str]:
        """Physical tier of each atomic mesh axis ("ici" / "host" /
        "dcn"), derived from the axis block strides against the spec's
        slice/host structure: devices are flat slice-major, host-major,
        chip-minor, and an axis whose stride reaches past
        ``devices_per_slice`` hops slices (DCN), past chips-per-host
        hops hosts. Memoized — the mesh is immutable after build."""
        cached = self.__dict__.get("_axis_tiers")
        if cached is not None:
            return cached
        spec = self.spec
        per_slice = max(1, spec.devices_per_slice)
        hosts_per_slice = max(1, spec.num_hosts
                              // max(1, spec.num_slices))
        chips_per_host = max(1, per_slice // hosts_per_slice)
        tiers: Dict[str, str] = {}
        names = list(self.axis_sizes.keys())
        sizes = [self.axis_sizes[a] for a in names]
        for i, a in enumerate(names):
            stride = 1
            for s in sizes[i + 1:]:
                stride *= s
            reach = stride * sizes[i]          # devices the axis spans
            if reach > per_slice and spec.num_slices > 1:
                tiers[a] = "dcn"
            elif reach > chips_per_host:
                tiers[a] = "host"
            else:
                tiers[a] = "ici"
        self.__dict__["_axis_tiers"] = tiers
        return tiers

    def axes_by_tier(self, innermost_first: bool = True
                     ) -> List[Tuple[str, int]]:
        """(axis, size) pairs ordered by physical tier (innermost =
        fastest fabric first when ``innermost_first``) — the allocation
        order placement-aware axis assignment uses."""
        from .topology import TIER_RANK
        tiers = self.axis_tiers
        items = list(self.axis_sizes.items())
        ranked = sorted(
            range(len(items)),
            key=lambda i: (TIER_RANK.get(tiers[items[i][0]], 99), i))
        if not innermost_first:
            ranked = ranked[::-1]
        return [items[i] for i in ranked]

    def allocate_axes(self, degree: int, used: Sequence[str],
                      prefer: Optional[str] = None
                      ) -> Optional[Tuple[str, ...]]:
        """Pick unused atomic axes whose sizes multiply to exactly `degree`.

        Greedy largest-first subset-product; returns None if impossible.
        This is the analog of the reference's machine-view enumeration
        (``FFModel::register_all_machine_views``) constrained to one mesh.

        ``prefer`` orders candidates by physical tier: ``"inner"`` takes
        the fastest fabric first (per-step per-op collectives belong on
        ICI), ``"outer"`` the slowest first (once-per-step gradient sync
        can afford the DCN axis). ``None`` keeps declaration order —
        bit-identical to the historical behavior.
        """
        if degree == 1:
            return ()
        if prefer in ("inner", "outer"):
            items = self.axes_by_tier(innermost_first=(prefer == "inner"))
        else:
            items = list(self.axis_sizes.items())
        avail = [(a, s) for a, s in items
                 if a not in used and a != self.seq_axis]
        picked: List[str] = []
        rem = degree

        def search(i: int, rem: int) -> bool:
            if rem == 1:
                return True
            if i >= len(avail):
                return False
            a, s = avail[i]
            if rem % s == 0:
                picked.append(a)
                if search(i + 1, rem // s):
                    return True
                picked.pop()
            return search(i + 1, rem)

        if search(0, rem):
            return tuple(picked)
        return None

    def valid_degrees(self) -> List[int]:
        """All degrees realizable as subset products of atomic axes
        (the reserved seq axis, when present, is not in the pool)."""
        degs = {1}
        for a, s in self.axis_sizes.items():
            if a == self.seq_axis:
                continue
            degs |= {d * s for d in degs}
        return sorted(degs)

    @property
    def sharding_axes(self) -> Tuple[str, ...]:
        """Axes the general search may shard over (all but ``seq``)."""
        return tuple(a for a in self.axis_sizes if a != self.seq_axis)

    @property
    def sharding_devices(self) -> int:
        """Device count across the general sharding axes."""
        return max(1, self.num_devices // self.seq_degree)
