"""Parallelization strategy: per-op sharding assignment.

The port of ``flexflow_tpu/parallel/strategy.py``, the searched artifact:
layer name -> {output specs, weight specs} over one device mesh. A spec
is a plain tuple with one entry per tensor dim: a mesh axis name, a
tuple of axis names, or None (the JAX package holds a
``jax.sharding.PartitionSpec`` with the same entries). The one-device
executor runs every strategy unsharded; the specs are what the search
scores and what a strategy file carries.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .machine import DeviceMesh

Spec = Tuple  # one entry per tensor dim: axis name, tuple of names, None


def P(*entries) -> Spec:
    """A sharding spec: the tuple of its entries (``PartitionSpec(*e)``
    in the JAX package)."""
    return tuple(entries)


def _spec_axes(spec) -> List[str]:
    axes: List[str] = []
    for e in spec:
        if e is None:
            continue
        if isinstance(e, (tuple, list)):
            axes.extend(e)
        else:
            axes.append(e)
    return axes


@dataclasses.dataclass
class OpSharding:
    """Sharding of one op's outputs and weights."""
    outputs: List[Optional[Spec]] = dataclasses.field(default_factory=list)
    weights: Dict[str, Spec] = dataclasses.field(default_factory=dict)

    def degree_of(self, dmesh: DeviceMesh, out_idx: int = 0) -> int:
        spec = self.outputs[out_idx]
        if spec is None:
            return 1
        d = 1
        for a in _spec_axes(spec):
            d *= dmesh.axis_sizes[a]
        return d


class ShardingStrategy:
    """Complete strategy for a graph over a mesh."""

    def __init__(self, dmesh: DeviceMesh):
        self.dmesh = dmesh
        self.ops: Dict[str, OpSharding] = {}
        self.inputs: Dict[str, Spec] = {}   # input tensor name -> spec
        # hierarchical placement annotations (parallel/placement.py in
        # the JAX package): mesh axis -> tier, and the per-collective
        # reduction trees a placement-aware search chose. Both round-trip
        # through strategy files; the port's search attaches no
        # placement (one tier), so it leaves them empty.
        self.axis_tiers: Dict[str, str] = {}
        self.collective_trees: List[Dict] = []
        # pipeline region, banks, place groups, ZeRO, quantized sync and
        # serving plans: the JAX package's multi-device planners, not
        # ported (ROADMAP queue 1 items 4-5); always empty here
        self.pipeline = None
        self.banks: List = []
        self.place_groups: List = []
        self.zero = None
        self.qsync = None
        self.serving = None
        # searched per-op kernel-implementation assignment
        # (kernels/registry.py, planned by FFModel._plan_kernels): op
        # kind -> impl for graph-wide kinds ("opt_update": "fused") and
        # layer name -> impl for attention ops. {} / missing key = the
        # kind's default impl. Serializes as the "kernel_impls" block.
        self.kernel_impls: Dict[str, str] = {}

    # ------------------------------------------------------------------
    def set_op(self, layer_name: str, outputs: Sequence[Optional[Spec]],
               weights: Optional[Dict[str, Spec]] = None):
        self.ops[layer_name] = OpSharding(list(outputs), dict(weights or {}))

    # ------------------------------------------------------------------
    @classmethod
    def data_parallel(cls, layers, input_tensors, dmesh: DeviceMesh
                      ) -> "ShardingStrategy":
        """Canonical pure-DP strategy: batch dim sharded over ALL mesh axes,
        weights replicated. Analog of the reference's
        ``--only-data-parallel`` canonical view (``graph.cc:1939-1964``)."""
        st = cls(dmesh)
        # the reserved seq axis (ring attention's context axis) never
        # carries the batch dim — DP spans the general sharding axes
        axes = dmesh.sharding_axes
        nd = dmesh.sharding_devices
        batch_axes = axes if len(axes) > 1 else (axes[0] if axes else None)
        if nd == 1:
            return st  # single device: everything unsharded
        for t in input_tensors:
            if t.shape and t.shape[0] % nd == 0:
                st.inputs[t.name] = P(batch_axes)
        for layer in layers:
            outs = []
            for o in layer.outputs:
                if o.shape and o.shape[0] % nd == 0:
                    outs.append(P(batch_axes))
                else:
                    outs.append(None)
            st.set_op(layer.name, outs, {})
        return st

    # ------------------------------------------------------------------
    def validate(self) -> List[str]:
        """Check axis-use consistency within each spec (an axis may appear
        at most once per PartitionSpec)."""
        errors = []
        for name, os in self.ops.items():
            for spec in list(os.outputs) + list(os.weights.values()):
                if spec is None:
                    continue
                axes = _spec_axes(spec)
                if len(axes) != len(set(axes)):
                    errors.append(f"{name}: axis reused in {spec}")
                for a in axes:
                    if a not in self.dmesh.axis_sizes:
                        errors.append(f"{name}: unknown axis {a}")
        return errors

    def describe(self) -> str:
        lines = [f"mesh axes: {dict(self.dmesh.axis_sizes)}"]
        if self.axis_tiers:
            lines.append(f"axis tiers: {dict(self.axis_tiers)}")
        for ct in self.collective_trees:
            lines.append(
                f"  tree {ct.get('site')}/{ct.get('collective')}"
                f" x{ct.get('degree')}: {ct.get('algo')} over "
                f"{ct.get('tier_path')}")
        if self.kernel_impls:
            lines.append(f"kernel impls: {dict(self.kernel_impls)}")
        for name, os in self.ops.items():
            lines.append(f"  {name}: out={os.outputs} w={os.weights}")
        return "\n".join(lines)
