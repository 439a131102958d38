"""Physical interconnect topology: tier ladder, torus and graph fabrics,
routing, and the machine-file loader.

The port of ``flexflow_tpu/parallel/topology.py``, unchanged in what it
computes, so that a machine file describes the same fabric to the cost
model in both packages. A TPU pod is an N-D torus of chips joined by
per-dimension links (``TorusTopology``, dimension-ordered routing with
the shortest wrap); slices join over per-host NICs; ``GraphTopology``
holds an explicit connection matrix (big switch, degraded links). A GPU
machine is described by the reference INI schema
(``machine_config_example``): ``nvlink_bandwidth`` is the fabric inside a
node, ``nic_bandwidth`` the one between nodes. ``TierGraph`` is the
bandwidth ladder (``ici`` / ``host`` / ``dcn``) the cost model prices
collectives against.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

# path-length comparison tolerance; safe because Dijkstra weights are
# normalized to max_bw/bw (dimensionless, >= 1 per hop)
_EPS = 1e-9

Link = Tuple[int, int, int]  # (device, dim, direction ±1) — outgoing port

# flat_ring_links cache bound: device tuples repeat thousands of times
# per search, but a long-lived topology (MachineSpec memo) must not
# accumulate routes without limit across searches
_RING_ROUTE_CACHE_CAP = 4096

# shared Dijkstra cache bound: distance maps are keyed by the topology's
# LINK TABLE fingerprint (+ node, direction), so rebuilt-but-identical
# fabrics (MachineSpec memo invalidation, per-test topologies) reuse one
# another's sweeps while a degraded() copy — different link table,
# different fingerprint — can never alias a healthy fabric's distances
_DIST_CACHE_CAP = 4096
_SHARED_DIST_CACHE: Dict[Tuple, Dict[int, float]] = {}
_ROUTES_CACHE_CAP = 8192


# ----------------------------------------------------------------------
# hardware tiers (arXiv 2110.10548: hierarchical placement + reduction)
# ----------------------------------------------------------------------

#: canonical tier names, innermost (fastest) first
TIER_ORDER = ("ici", "host", "dcn")
#: tier name -> rank (innermost = 0); THE ordering map every consumer
#: shares (placement paths, axis allocation, calibration tier keys)
TIER_RANK = {t: i for i, t in enumerate(TIER_ORDER)}


@dataclasses.dataclass(frozen=True)
class Tier:
    """One bandwidth/latency level of the machine hierarchy.

    ``span`` is the number of devices reachable without leaving the
    tier's domain (chips per host for ``ici``, devices per slice for
    ``host``, the whole machine for ``dcn``) — the quantity placement
    search compares collective degrees against."""
    name: str            # "ici" | "host" | "dcn"
    bandwidth: float     # bytes/s per link, one direction
    latency_s: float     # per-hop latency in seconds
    span: int            # devices reachable inside one tier domain

    def rank(self) -> int:
        return TIER_ORDER.index(self.name) \
            if self.name in TIER_ORDER else len(TIER_ORDER)


class TierGraph:
    """First-class description of the machine's bandwidth tiers —
    ICI-within-host / ICI-or-NIC-across-hosts / DCN-across-slices —
    queryable by the placement search, cost model, plan verifier and
    executor lowering (arXiv 2110.10548 models exactly this hierarchy).

    Tiers are ordered innermost (fastest, smallest span) first. A
    machine may collapse to a single tier (one host, one slice): every
    consumer must then degenerate to flat-mesh behavior.
    """

    def __init__(self, tiers: Sequence[Tier]):
        if not tiers:
            raise ValueError("TierGraph needs at least one tier")
        self.tiers: Tuple[Tier, ...] = tuple(
            sorted(tiers, key=lambda t: (t.span, t.rank())))
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")

    def __repr__(self) -> str:
        return "TierGraph(" + ", ".join(
            f"{t.name}: span={t.span} bw={t.bandwidth / 1e9:.3g}GB/s "
            f"lat={t.latency_s * 1e6:.3g}us" for t in self.tiers) + ")"

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tiers)

    @property
    def multi_tier(self) -> bool:
        return len(self.tiers) > 1

    def tier(self, name: str) -> Tier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise ValueError(f"unknown tier {name!r} "
                         f"(tiers: {list(self.names)})")

    def innermost(self) -> Tier:
        return self.tiers[0]

    def outermost(self) -> Tier:
        return self.tiers[-1]

    def tier_for_span(self, span: int) -> Tier:
        """The innermost tier whose domain covers ``span`` devices — the
        tier a collective of that reach must traverse."""
        for t in self.tiers:
            if span <= t.span:
                return t
        return self.tiers[-1]

    @classmethod
    def from_machine_spec(cls, spec) -> "TierGraph":
        """Derive the tier ladder from a ``MachineSpec``:

          - ``ici``  — chips of one host (always present);
          - ``host`` — crossing hosts inside a slice (present when a
            slice spans several hosts; ICI bandwidth on TPU pods, the
            host-fabric override — e.g. a reference INI's NIC — when
            ``host_bandwidth_override`` is set);
          - ``dcn``  — crossing slices over per-host NICs (present when
            ``num_slices > 1``).
        """
        n = max(1, spec.num_devices)
        per_slice = max(1, spec.devices_per_slice)
        hosts_per_slice = max(1, spec.num_hosts // max(1, spec.num_slices))
        chips_per_host = max(1, per_slice // hosts_per_slice)
        ici_bw = spec.ici_bandwidth
        ici_lat = spec.ici_latency_us * 1e-6
        tiers = [Tier("ici", ici_bw, ici_lat, chips_per_host)]
        if per_slice > chips_per_host:
            host_bw = getattr(spec, "host_bandwidth_override", None)
            host_lat = getattr(spec, "host_latency_override_us", None)
            tiers.append(Tier(
                "host",
                float(host_bw) if host_bw is not None else ici_bw,
                float(host_lat) * 1e-6 if host_lat is not None
                else ici_lat, per_slice))
        if spec.num_slices > 1 and n > per_slice:
            tiers.append(Tier("dcn", spec.dcn_bandwidth,
                              spec.dcn_latency_us * 1e-6, n))
        return cls(tiers)


# ----------------------------------------------------------------------
# chaos-drill link degradation (resilience/faults.py ``degrade_link``)
# ----------------------------------------------------------------------

#: memoized accessor into the fault registry — pricing paths call this
#: 1e4-1e6 times per search, so the import resolves once
_ld_fn = None


def link_degradation_factor(name: str) -> float:
    """Active chaos-drill slowdown factor of one tier name (1.0 =
    healthy fabric). Registered by ``degrade_link@N:tier:factor``
    clauses (resilience/faults.py); every analytic tier-priced leg
    divides its bandwidth by this so predictions — and therefore the
    re-plan search — see the degraded link the moment the drill fires."""
    global _ld_fn
    if _ld_fn is None:
        try:
            from ..resilience.faults import link_degradation
            _ld_fn = link_degradation
        except Exception:  # noqa: BLE001 — no drill machinery
            _ld_fn = lambda t: 1.0  # noqa: E731
    return _ld_fn(name)


def effective_tier_bandwidth(tier: Tier) -> float:
    """``tier.bandwidth`` after any active chaos-drill degradation."""
    f = link_degradation_factor(tier.name)
    return tier.bandwidth / f if f > 1.0 else tier.bandwidth


def flat_ring_links(topo, devices: Tuple[int, ...]):
    """Flattened ring-collective routes over ``devices``, cached on the
    topology: ``(offsets, links, factors-or-None)`` where ``links`` is
    the concatenated per-participant hop list and ``offsets[i]`` its
    start. Only builder-independent data (raw link tuples, bandwidth
    factors) is cached here — processor-id mapping is per consumer
    (search/tasksim.py), so one shared topology can never serve another
    builder's ids. The cache is bounded at ``_RING_ROUTE_CACHE_CAP``
    entries (cleared wholesale when full; hot tuples repopulate).

    A module function rather than a method so any duck-typed topology
    (``MachineSpec.topology_override`` accepts arbitrary objects with
    ``ring_links``/``link_index``) gets the same caching."""
    cache = topo.__dict__.get("_ring_route_cache")
    if cache is None:
        cache = {}
        topo.__dict__["_ring_route_cache"] = cache
    hit = cache.get(devices)
    if hit is None:
        routes = topo.ring_links(list(devices))
        factor = getattr(topo, "link_factor", None)
        off = [0]
        links: List[Link] = []
        fac: Optional[List[float]] = [] if factor else None
        for hops in routes:
            for link in hops:
                links.append(link)
                if fac is not None:
                    fac.append(float(factor(link)))
            off.append(len(links))
        if len(cache) >= _RING_ROUTE_CACHE_CAP:
            cache.clear()
        hit = (tuple(off), tuple(links),
               tuple(fac) if fac is not None else None)
        cache[devices] = hit
    return hit


@dataclasses.dataclass
class TorusTopology:
    """N-D torus of devices; wrap links exist on dims of size >= 3
    (TPU slices expose wraparound only for full rings)."""
    shape: Tuple[int, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def coord(self, dev: int) -> Tuple[int, ...]:
        c = []
        for s in reversed(self.shape):
            c.append(dev % s)
            dev //= s
        return tuple(reversed(c))

    def device(self, coord: Sequence[int]) -> int:
        d = 0
        for x, s in zip(coord, self.shape):
            d = d * s + (x % s)
        return d

    def _wrap(self, dim: int) -> bool:
        return self.shape[dim] >= 3

    def hop_distance(self, a: int, b: int) -> int:
        """Total hops of the dimension-ordered route."""
        ca, cb = self.coord(a), self.coord(b)
        hops = 0
        for k, s in enumerate(self.shape):
            d = abs(ca[k] - cb[k])
            hops += min(d, s - d) if self._wrap(k) else d
        return hops

    def route(self, src: int, dst: int) -> List[Link]:
        """Dimension-ordered shortest-wrap route as outgoing links.

        Analog of ``ShortestPathNetworkRoutingStrategy::get_routes``
        (``simulator.h:399``) specialized to the torus, where
        dimension-ordered IS shortest-path."""
        links: List[Link] = []
        cur = list(self.coord(src))
        tgt = self.coord(dst)
        for k, s in enumerate(self.shape):
            while cur[k] != tgt[k]:
                fwd = (tgt[k] - cur[k]) % s
                back = (cur[k] - tgt[k]) % s
                step = 1 if (fwd <= back or not self._wrap(k)) else -1
                if not self._wrap(k) and tgt[k] < cur[k]:
                    step = -1
                links.append((self.device(cur), k, step))
                cur[k] = (cur[k] + step) % s
        return links

    def ring_links(self, devices: Sequence[int]) -> List[List[Link]]:
        """Per-step physical links of a ring collective over ``devices``
        (each participant sends to its successor every step)."""
        n = len(devices)
        return [self.route(devices[i], devices[(i + 1) % n])
                for i in range(n)]

    def link_index(self) -> Dict[Link, int]:
        """Dense numbering of every outgoing port (device, dim, dir)."""
        idx: Dict[Link, int] = {}
        for d in range(self.num_devices):
            for k in range(len(self.shape)):
                for s in (1, -1):
                    idx[(d, k, s)] = len(idx)
        return idx


class GraphTopology:
    """Arbitrary weighted interconnect: a directed connection matrix over
    devices, with weighted shortest-path routing.

    Analog of the reference's ``NetworkedMachineModel`` + connection-
    matrix generators + ``WeightedShortestPathRoutingStrategy``
    (``src/runtime/network.cc:1-586``, ``include/flexflow/
    simulator.h:381-515``). Where the torus model is exact for one
    healthy slice, this expresses what it cannot: big-switch fabrics,
    degraded links, heterogeneous multi-slice pods (ICI inside each
    slice, DCN between them).

    ``conn[(i, j)]`` is the link bandwidth in bytes/s (absent = no
    link). The task simulator charges each link on a route a duration
    scaled by ``link_factor`` — the ratio of the fastest link's
    bandwidth to this link's — so a DCN hop or a degraded link
    serializes traffic proportionally longer. The ``Link`` key is
    ``(src, 0, dst)``: same 3-tuple arity as the torus's
    ``(device, dim, dir)`` ports, so ``link_index``/``ring_links``
    consumers work unchanged.
    """

    def __init__(self, num_devices: int,
                 conn: Dict[Tuple[int, int], float]):
        self.num_devices = num_devices
        self.conn = dict(conn)
        self.max_bw = max(conn.values()) if conn else 1.0
        self._routes_cache: Dict[Tuple[int, int, int], List[List[Link]]] = {}
        self._dist_cache: Dict[int, Dict[int, float]] = {}
        self._rdist_cache: Dict[int, Dict[int, float]] = {}
        # link-table fingerprint: keys the SHARED Dijkstra cache, so
        # identical fabrics (rebuilt per search/test) reuse sweeps while
        # degraded() copies — different table, different key — never
        # alias (the per-instance dicts above stay as the L1 memo).
        # The FULL tuple is the key, not its hash: a 64-bit hash
        # collision between distinct fabrics would silently serve wrong
        # distances; equality comparison rules that out
        self._conn_key = (num_devices,
                          tuple(sorted(self.conn.items())))
        # Dijkstra weight: dimensionless time factor max_bw/bw (>= 1 per
        # hop, the same normalization as link_factor). Raw per-byte
        # weights (1/bw ~ 1e-11 for real ICI bandwidths) would sit at
        # the same scale as any absolute epsilon and break the
        # shortest-path-DAG edge test on fast fabrics.
        self._adj: Dict[int, List[Tuple[int, float]]] = {}
        self._radj: Dict[int, List[Tuple[int, float]]] = {}
        for (i, j), bw in conn.items():
            w = self.max_bw / max(bw, 1e-30)
            self._adj.setdefault(i, []).append((j, w))
            self._radj.setdefault(j, []).append((i, w))

    # ---- constructors (reference network.cc topology generators) ----
    @classmethod
    def from_torus(cls, shape: Sequence[int],
                   bw: float = 1.0) -> "GraphTopology":
        t = TorusTopology(tuple(shape))
        conn: Dict[Tuple[int, int], float] = {}
        for d in range(t.num_devices):
            c = t.coord(d)
            for k, s in enumerate(shape):
                for step in ((1, -1) if s >= 3 else (1,) if c[k] + 1 < s
                             else ()):
                    nc = list(c)
                    nc[k] = (nc[k] + step) % s
                    conn[(d, t.device(nc))] = bw
                    conn[(t.device(nc), d)] = bw
        return cls(t.num_devices, conn)

    @classmethod
    def big_switch(cls, n: int, bw: float = 1.0) -> "GraphTopology":
        """Full crossbar: every pair directly connected (the reference's
        ``FlatDegConstraintNetworkTopologyGenerator`` limit case)."""
        conn = {(i, j): bw for i in range(n) for j in range(n) if i != j}
        return cls(n, conn)

    @classmethod
    def degraded(cls, base: "GraphTopology",
                 slow_links: Sequence[Tuple[int, int]],
                 factor: float) -> "GraphTopology":
        """Copy of ``base`` with the listed (src, dst) links running at
        ``bw / factor`` (fault/brownout modeling)."""
        conn = dict(base.conn)
        for (i, j) in slow_links:
            if (i, j) in conn:
                conn[(i, j)] = conn[(i, j)] / factor
        return cls(base.num_devices, conn)

    @classmethod
    def multi_slice_torus(cls, shape: Sequence[int], n_slices: int,
                          ici_bw: float, dcn_bw: float,
                          hosts_per_slice: int = 1) -> "GraphTopology":
        """``n_slices`` tori joined by DCN: each slice exposes
        ``hosts_per_slice`` gateway devices (block-contiguous hosts'
        first chips) with all-to-all DCN links between slices — the
        fabric of a real multi-slice pod."""
        one = cls.from_torus(shape, ici_bw)
        per = one.num_devices
        conn: Dict[Tuple[int, int], float] = {}
        for s in range(n_slices):
            off = s * per
            for (i, j), bw in one.conn.items():
                conn[(off + i, off + j)] = bw
        chips_per_host = max(1, per // max(1, hosts_per_slice))
        gateways = [list(range(s * per, (s + 1) * per, chips_per_host))
                    for s in range(n_slices)]
        for a in range(n_slices):
            for b in range(n_slices):
                if a == b:
                    continue
                for ga, gb in zip(gateways[a], gateways[b]):
                    conn[(ga, gb)] = dcn_bw
        return cls(per * n_slices, conn)

    # ---- routing (WeightedShortestPathRoutingStrategy analog) ----
    def routes(self, src: int, dst: int, k: int = 4) -> List[List[Link]]:
        """Up to ``k`` equal-cost weighted-shortest paths src -> dst.

        All shortest paths live on the Dijkstra shortest-path DAG
        (edges u->v with dist[v] == dist[u] + w); a depth-first walk in
        sorted-neighbor order enumerates them deterministically. The
        reference's WeightedShortestPathRoutingStrategy returns one
        path chosen by a random tie-break (network.cc:89 —
        ``unif(gen) < 0.5``), spreading flows across equal-cost paths
        statistically; here :meth:`route` hash-selects per (src, dst)
        flow, the deterministic form of the same ECMP spreading."""
        if src == dst:
            return [[]]
        hit = self._routes_cache.get((src, dst, k))
        if hit is not None:
            return hit
        dist = self._dist_from(src)
        if dst not in dist:
            raise ValueError(f"no route {src} -> {dst} in topology")
        rdist = self._dist_from(dst, rev=True)
        total = dist[dst]
        # relative tolerance: weights are dimensionless (max_bw/bw >= 1)
        # but long routes accumulate fp error proportional to length
        tol = _EPS * max(1.0, total)
        # one candidate per equal-cost FIRST HOP (sorted, deterministic):
        # distinct egress links by construction, so per-flow selection
        # genuinely spreads source traffic (a k-truncated DFS kept only
        # paths differing near dst — every candidate shared hop 1)
        inf = float("inf")
        firsts = [v for v, w in sorted(self._adj.get(src, ()))
                  if w + rdist.get(v, inf) <= total + tol]
        if not firsts:
            # fp-pathological fabric: fall back to the single best hop
            firsts = [min(self._adj.get(src, ()),
                          key=lambda vw: (vw[1] + rdist.get(vw[0], inf),
                                          vw[0]))[0]]
        paths: List[List[int]] = []
        for first in firsts[:max(1, k)]:
            # greedy descent on rdist: from any node on a shortest path
            # the neighbor minimizing (w + rdist) continues one, so the
            # walk reaches dst in <= num_devices hops; a step cap guards
            # degenerate fp cases (such a path is simply dropped)
            path = [src, first]
            u = first
            for _ in range(self.num_devices):
                if u == dst:
                    break
                u = min(self._adj.get(u, ()),
                        key=lambda vw: (vw[1] + rdist.get(vw[0], inf),
                                        vw[0]))[0]
                path.append(u)
            if path[-1] == dst:
                paths.append(path)
        if not paths:
            raise ValueError(f"no route {src} -> {dst} in topology")
        out = [[(p[i], 0, p[i + 1]) for i in range(len(p) - 1)]
               for p in paths]
        if len(self._routes_cache) >= _ROUTES_CACHE_CAP:
            self._routes_cache.clear()     # hot pairs repopulate
        self._routes_cache[(src, dst, k)] = out
        return out

    def _dist_from(self, node: int, rev: bool = False) -> Dict[int, float]:
        """Memoized full Dijkstra distance map from ``node`` (forward or
        reverse graph) — ring_links issues a route per device pair, so
        per-node caching turns 2P sweeps into at most 2V. Two-level:
        per-instance dict first, then the module-level bounded cache
        keyed on the link-table fingerprint (``_conn_key``), so a fresh
        but identical topology object reuses earlier sweeps while a
        ``degraded()`` copy's different table can never alias."""
        cache = self._rdist_cache if rev else self._dist_cache
        hit = cache.get(node)
        if hit is not None:
            return hit
        skey = (self._conn_key, node, rev)
        shared = _SHARED_DIST_CACHE.get(skey)
        if shared is not None:
            cache[node] = shared
            return shared
        import heapq
        adj = self._radj if rev else self._adj
        dist = {node: 0.0}
        pq = [(0.0, node)]
        while pq:
            d, u = heapq.heappop(pq)
            if d > dist.get(u, float("inf")):
                continue
            for v, w in adj.get(u, ()):
                nd = d + w
                if nd < dist.get(v, float("inf")) - _EPS:
                    dist[v] = nd
                    heapq.heappush(pq, (nd, v))
        cache[node] = dist
        if len(_SHARED_DIST_CACHE) >= _DIST_CACHE_CAP:
            _SHARED_DIST_CACHE.clear()     # hot fabrics repopulate
        _SHARED_DIST_CACHE[skey] = dist
        return dist

    def route(self, src: int, dst: int) -> List[Link]:
        """One weighted-shortest path; equal-cost alternatives are
        hash-selected per flow (deterministic ECMP — see
        :meth:`routes`)."""
        if src == dst:
            return []
        cands = self.routes(src, dst)   # cached per (src, dst, k)
        # deterministic per-flow spreading: distinct (src, dst) pairs
        # land on different equal-cost paths; repeated queries agree
        idx = (src * 2654435761 + dst * 40503) % len(cands)
        return cands[idx]

    def hop_distance(self, a: int, b: int) -> int:
        """Minimum hop count over the ENUMERATED equal-cost candidates
        (:meth:`routes`, one greedy path per equal-cost first hop,
        k <= 4): deterministic and independent of the per-flow hash
        (ADVICE r4). Not guaranteed to be the global minimum-hop
        equal-weight path — ties inside the greedy descent break by
        node id, which is fine for the latency estimates this feeds."""
        if a == b:
            return 0
        return min(len(p) for p in self.routes(a, b))

    def ring_links(self, devices: Sequence[int]) -> List[List[Link]]:
        n = len(devices)
        return [self.route(devices[i], devices[(i + 1) % n])
                for i in range(n)]

    def link_index(self) -> Dict[Link, int]:
        return {(i, 0, j): k
                for k, (i, j) in enumerate(sorted(self.conn.keys()))}

    def link_factor(self, link: Link) -> float:
        """Duration multiplier for traffic on this link relative to the
        fastest link in the fabric (DCN/degraded links serialize
        longer)."""
        bw = self.conn.get((link[0], link[2]))
        return self.max_bw / bw if bw else 1.0


# ----------------------------------------------------------------------
# machine description files (--machine-model-file)
# ----------------------------------------------------------------------

def _parse_ini(text: str) -> Dict[str, str]:
    """``key = value`` lines, ``#`` comments — the reference's
    ``machine_config_example`` format. Lines that look like
    assignments but don't parse raise a typed ``ValueError`` naming
    the offending line instead of being silently dropped."""
    out: Dict[str, str] = {}
    for ln, line in enumerate(text.splitlines(), start=1):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        m = re.match(r"([A-Za-z0-9_]+)\s*=\s*(.+)", line)
        if not m:
            raise ValueError(
                f"machine file line {ln}: {line!r} is not a "
                f"'key = value' entry")
        out[m.group(1)] = m.group(2).strip()
    return out


def _cfg_get(cfg: Dict, key: str, conv, default=None, path: str = ""):
    """Typed machine-file field access: a malformed value raises
    ``ValueError`` naming the offending key (never a bare
    ``KeyError``/``TypeError`` from deep inside the parser)."""
    if key not in cfg or cfg[key] is None:
        return default
    try:
        return conv(cfg[key])
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"machine file {path or '<config>'}: invalid value "
            f"{cfg[key]!r} for key '{key}': {e}") from e


def _shape_conv(v) -> Tuple[int, ...]:
    """ici_shape in JSON list form or INI text form ('4x8', '4 8',
    '4,8')."""
    if isinstance(v, str):
        parts = [p for p in re.split(r"[x,\s]+", v.strip()) if p]
        return tuple(int(p) for p in parts)
    return tuple(int(x) for x in v)


#: keys marking a TPU-native description (JSON or INI); their absence
#: from an INI file selects the reference machine_config_example schema
_TPU_KEYS = ("generation", "ici_shape", "num_slices", "num_devices",
             "dcn_bandwidth_gbps", "ici_bandwidth_gbps")


def load_machine_file(path: str):
    """Parse a machine description into a ``MachineSpec``.

    Formats:
      - JSON (TPU-native): ``{"generation": "v5e", "ici_shape": [4, 8],
        "num_hosts": 4, "num_slices": 1, "dcn_bandwidth_gbps": 25, ...}``
      - INI with the same TPU-native keys (``ici_shape = 4x8``) — e.g.
        ``machine_configs/v5e-2slice.ini``;
      - reference-style INI (``machine_config_example``): ``num_nodes``,
        ``num_gpus_per_socket`` x ``num_sockets_per_node`` -> devices,
        ``nvlink_bandwidth`` -> ICI GB/s, ``nic_bandwidth`` -> DCN,
        latencies in ms.

    Malformed entries raise ``ValueError`` naming the offending key.
    """
    from .machine import MachineSpec

    with open(path) as f:
        text = f.read()
    try:
        cfg = json.loads(text)
        is_json = True
    except json.JSONDecodeError:
        cfg = _parse_ini(text)
        is_json = False

    if is_json or any(k in cfg for k in _TPU_KEYS):
        ici_shape = _cfg_get(cfg, "ici_shape", _shape_conv, None, path)
        num_slices = _cfg_get(cfg, "num_slices", int, 1, path)
        num_devices = _cfg_get(cfg, "num_devices", int, None, path)
        if num_devices is None:
            num_devices = _prod(ici_shape or [1]) * num_slices
        spec = MachineSpec(
            num_devices=num_devices,
            generation=_cfg_get(cfg, "generation", str, "v5e", path),
            ici_shape=ici_shape,
            num_slices=num_slices,
            dcn_bandwidth_gbps=_cfg_get(cfg, "dcn_bandwidth_gbps",
                                        float, 25.0, path),
            ici_latency_us=_cfg_get(cfg, "ici_latency_us", float, 1.0,
                                    path),
            dcn_latency_us=_cfg_get(cfg, "dcn_latency_us", float, 10.0,
                                    path),
        )
        spec.num_hosts = _cfg_get(cfg, "num_hosts", int,
                                  spec.num_slices, path)
        ici_bw = _cfg_get(cfg, "ici_bandwidth_gbps", float, None, path)
        if ici_bw is not None:
            spec.ici_bandwidth_override = ici_bw * 1e9
        host_bw = _cfg_get(cfg, "host_bandwidth_gbps", float, None, path)
        if host_bw is not None:
            spec.host_bandwidth_override = host_bw * 1e9
        host_lat = _cfg_get(cfg, "host_latency_us", float, None, path)
        if host_lat is not None:
            spec.host_latency_override_us = host_lat
        tflops = _cfg_get(cfg, "peak_tflops", float, None, path)
        if tflops is not None:
            spec.peak_flops_override = tflops * 1e12
        from .machine import GENERATIONS
        if spec.generation not in GENERATIONS:
            raise ValueError(
                f"machine file {path}: invalid value "
                f"{spec.generation!r} for key 'generation'")
        if "topology" in cfg:
            if not isinstance(cfg["topology"], dict):
                raise ValueError(
                    f"machine file {path}: invalid value for key "
                    f"'topology': expected an object, got "
                    f"{type(cfg['topology']).__name__}")
            spec.topology_override = topology_from_json(cfg["topology"],
                                                        spec)
        return spec

    # reference INI: nodes x sockets x gpus-per-socket accelerators;
    # nvlink ≙ intra-node fabric (ICI), nic ≙ inter-node (DCN)
    nodes = _cfg_get(cfg, "num_nodes", int, 1, path)
    sockets = _cfg_get(cfg, "num_sockets_per_node", int, 1, path)
    per_socket = _cfg_get(cfg, "num_gpus_per_socket", int, 1, path)
    per_node = sockets * per_socket
    spec = MachineSpec(
        num_devices=nodes * per_node,
        num_slices=nodes if nodes > 1 else 1,
        dcn_bandwidth_gbps=_cfg_get(cfg, "nic_bandwidth", float, 25.0,
                                    path),
        # reference latencies are in ms
        ici_latency_us=_cfg_get(cfg, "nvlink_latency", float, 0.001,
                                path) * 1e3,
        dcn_latency_us=_cfg_get(cfg, "nic_latency", float, 0.01,
                                path) * 1e3,
    )
    spec.num_hosts = nodes
    spec.ici_shape = (per_node,)
    nvlink = _cfg_get(cfg, "nvlink_bandwidth", float, None, path)
    if nvlink is not None:
        spec.ici_bandwidth_override = nvlink * 1e9
    return spec


def topology_from_json(doc: Dict, spec) -> GraphTopology:
    """Build a ``GraphTopology`` from a machine-file ``topology`` block.

    Kinds (reference topology generators, ``network.cc``):
      - ``{"kind": "torus", "shape": [4, 8]}``
      - ``{"kind": "big_switch", "n": 32}``
      - ``{"kind": "multi_slice_torus", "shape": [4, 8], "n_slices": 2,
         "hosts_per_slice": 8}``
      - ``{"kind": "degraded", "base": {...}, "slow_links": [[0, 1]],
         "factor": 4}``
      - ``{"kind": "matrix", "n": 4,
         "links": [[src, dst, bandwidth_gbps], ...]}``
    """
    kind = doc.get("kind", "torus")
    ici = spec.ici_bandwidth
    if kind == "torus":
        return GraphTopology.from_torus(doc["shape"], ici)
    if kind == "big_switch":
        return GraphTopology.big_switch(int(doc["n"]), ici)
    if kind == "multi_slice_torus":
        return GraphTopology.multi_slice_torus(
            doc["shape"], int(doc["n_slices"]), ici_bw=ici,
            dcn_bw=spec.dcn_bandwidth,
            hosts_per_slice=int(doc.get("hosts_per_slice", 1)))
    if kind == "degraded":
        base = topology_from_json(doc["base"], spec)
        return GraphTopology.degraded(
            base, [tuple(l) for l in doc["slow_links"]],
            float(doc["factor"]))
    if kind == "matrix":
        conn = {(int(s), int(d)): float(bw) * 1e9
                for s, d, bw in doc["links"]}
        return GraphTopology(int(doc["n"]), conn)
    raise ValueError(f"unknown topology kind {kind!r}")


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n
