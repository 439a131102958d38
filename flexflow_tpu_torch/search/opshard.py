"""Per-operator sharding options: which tensor dims may be partitioned and
what weight shardings each choice implies. The port of
``flexflow_tpu/search/opshard.py``; specs are plain tuples
(``parallel/strategy.py``).

Analog of the reference's ParallelDimMappingRecords (``operator.h:127-130``)
plus the programmatic parallelization xfers (``substitution.cc:61-110``):
each op type declares its shardable output dims (SOAP: Sample / Operator /
Attribute / Parameter) and how weights co-shard. The search assigns a
degree to each option; axes come from the factorized mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..ffconst import (ELEMENTWISE_BINARY_OPS, ELEMENTWISE_UNARY_OPS,
                       OperatorType)
from ..core.layer import Layer
from ..parallel.strategy import P, Spec


@dataclasses.dataclass(frozen=True)
class ShardOption:
    """One shardable dimension of an op's output."""
    kind: str          # "sample" | "parameter" | "attribute"
    out_dim: int       # which output dim gets the degree
    # weight name -> weight dim that co-shards (same axes)
    weight_dims: Tuple[Tuple[str, int], ...] = ()


def _rank(layer: Layer) -> int:
    return len(layer.outputs[0].shape)


def options_for(layer: Layer) -> List[ShardOption]:
    """Enumerate shardable dims for this layer (batch dim is option 0
    when available)."""
    t = layer.op_type
    r = _rank(layer)
    opts: List[ShardOption] = []
    if r == 0:
        return opts

    def sample(dim=0):
        opts.append(ShardOption("sample", dim))

    if t == OperatorType.OP_LINEAR:
        sample()
        opts.append(ShardOption("parameter", r - 1,
                                (("kernel", 1), ("bias", 0))))
    elif t == OperatorType.OP_CONV2D:
        sample()
        opts.append(ShardOption("parameter", 1,
                                (("kernel", 0), ("bias", 0))))
        if r == 4:
            opts.append(ShardOption("attribute", 2))  # image H
    elif t == OperatorType.OP_POOL2D or t == OperatorType.OP_BATCHNORM:
        sample()
        opts.append(ShardOption("attribute", 1, (("scale", 0), ("bias", 0))
                                if t == OperatorType.OP_BATCHNORM else ()))
    elif t == OperatorType.OP_EMBEDDING:
        sample()
        opts.append(ShardOption("parameter", r - 1, (("kernel", 1),)))
    elif t == OperatorType.OP_MULTIHEAD_ATTENTION:
        sample()
        # head-parallel: wq/wk/wv head dim, wo input-head dim; output stays
        # unsharded on hidden (all-reduce after wo) — reference
        # create_partition_attention_combine
        opts.append(ShardOption("parameter", -1,
                                (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0),
                                 ("bq", 0), ("bk", 0), ("bv", 0))))
    elif t == OperatorType.OP_LAYERNORM or t == OperatorType.OP_RMSNORM:
        sample()
        if r >= 3:
            opts.append(ShardOption("attribute", 1))  # sequence dim
    elif t in ELEMENTWISE_UNARY_OPS or t in ELEMENTWISE_BINARY_OPS \
            or t in (OperatorType.OP_DROPOUT, OperatorType.OP_SOFTMAX,
                     OperatorType.OP_MUL):
        sample()
        if r >= 3:
            opts.append(ShardOption("attribute", 1))
    elif t in (OperatorType.OP_FLAT, OperatorType.OP_RESHAPE,
               OperatorType.OP_CONCAT, OperatorType.OP_SPLIT,
               OperatorType.OP_TRANSPOSE, OperatorType.OP_BATCHMATMUL,
               OperatorType.OP_MATMUL, OperatorType.OP_TOPK,
               OperatorType.OP_CAST, OperatorType.OP_GATHER):
        sample()
    elif t in (OperatorType.OP_AGGREGATE, OperatorType.OP_AGG_SPEC):
        sample()
    # GROUP_BY and expert-side ops stay unsharded here (EP handled by
    # presets/placement); reductions/means: batch only if dim 0 survives
    elif layer.outputs[0].shape and layer.inputs and \
            layer.inputs[0].shape[:1] == layer.outputs[0].shape[:1]:
        sample()
    return opts


@dataclasses.dataclass
class OpAssignment:
    """Chosen degrees per option for one op. degree 1 = not partitioned."""
    degrees: Tuple[int, ...]  # parallel to options_for(layer)


def assignment_to_sharding(layer: Layer, options: Sequence[ShardOption],
                           degrees: Sequence[int], dmesh
                           ) -> Optional[Tuple[List[Optional[Spec]],
                                               Dict[str, Spec]]]:
    """Convert (options, degrees) to (output specs, weight specs) over the
    mesh, allocating disjoint atomic axes per option. Returns None when the
    mesh can't realize the degree product or a dim isn't divisible."""
    r = _rank(layer)
    used: List[str] = []
    out_axes: Dict[int, Tuple[str, ...]] = {}
    weight_axes: Dict[str, Dict[int, Tuple[str, ...]]] = {}
    for opt, deg in zip(options, degrees):
        if deg <= 1:
            continue
        axes = dmesh.allocate_axes(deg, used)
        if axes is None:
            return None
        used.extend(axes)
        if opt.out_dim >= 0:
            dim = opt.out_dim
            size = layer.outputs[0].shape[dim]
            if size % deg != 0:
                return None
            out_axes[dim] = axes
        for wname, wdim in opt.weight_dims:
            weight_axes.setdefault(wname, {})[wdim] = axes

    def to_spec(axes_map: Dict[int, Tuple[str, ...]], rank: int) -> Spec:
        entries = []
        for d in range(rank):
            ax = axes_map.get(d)
            if ax is None:
                entries.append(None)
            else:
                entries.append(ax[0] if len(ax) == 1 else tuple(ax))
        return P(*entries)

    out_spec = to_spec(out_axes, r) if out_axes else None
    out_specs: List[Optional[Spec]] = []
    for o in layer.outputs:
        if out_spec is not None and len(o.shape) == r:
            ok = all(o.shape[d] % _deg(dmesh, ax) == 0
                     for d, ax in out_axes.items())
            out_specs.append(out_spec if ok else None)
        else:
            out_specs.append(None)
    wspecs: Dict[str, Spec] = {}
    for wname, amap in weight_axes.items():
        rank_w = max(amap.keys()) + 1
        wspecs[wname] = to_spec(amap, rank_w)
    return out_specs, wspecs


def _deg(dmesh, axes: Tuple[str, ...]) -> int:
    d = 1
    for a in axes:
        d *= dmesh.axis_sizes[a]
    return d
