"""Parallel operators: communication as graph nodes.

The port of ``flexflow_tpu/ops/parallel_ops.py``. The strategy search
(``search/unity.py``) rewrites a graph with Repartition / Combine /
Replicate / Reduction nodes; each is a sharding transition, the identity
on values. On one device the transition moves nothing, so each emits its
input as it is; a described multi-device strategy is priced and exported
but not run here (``FFModel.compile`` refuses it).
"""
from __future__ import annotations

from ..ffconst import OperatorType
from .registry import OpDef, register


class _ShardingTransitionBase(OpDef):
    """Identity at the value level; sharding change at the mesh level."""

    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[0], in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        return [inputs[0]]


@register
class RepartitionOp(_ShardingTransitionBase):
    """Re-shard along dim ``dim`` with degree ``degree`` (scatter)."""
    op_type = OperatorType.OP_REPARTITION


@register
class CombineOp(_ShardingTransitionBase):
    """Inverse of repartition (gather along a dim)."""
    op_type = OperatorType.OP_COMBINE


@register
class ReplicateOp(_ShardingTransitionBase):
    """Replicate across ``degree`` devices (broadcast)."""
    op_type = OperatorType.OP_REPLICATE


@register
class ReductionOp(_ShardingTransitionBase):
    """Sum-combine ``degree`` replicas (all-reduce / reduce-scatter)."""
    op_type = OperatorType.OP_REDUCTION


@register
class AllToAllOp(_ShardingTransitionBase):
    """Resharding between two partitioned dims."""
    op_type = OperatorType.OP_ALLTOALL


@register
class PipelineOp(_ShardingTransitionBase):
    """Pipeline stage boundary marker (an identity as a graph node)."""
    op_type = OperatorType.OP_PIPELINE


@register
class FusedParallelOp(_ShardingTransitionBase):
    """A chain of parallel ops collapsed into one transition."""
    op_type = OperatorType.OP_FUSED_PARALLEL
