"""Parallel operators: communication as graph nodes.

The port of ``flexflow_tpu/ops/parallel_ops.py``. The strategy search
(``search/unity.py``) rewrites a graph with Repartition / Combine /
Replicate / Reduction / AllToAll nodes; each is a sharding transition,
the identity on values. Over a live mesh (a world of ranks) each moves
its input to the layout the strategy gives its output: through the
reshard planner (``parallel/reshard.py``: gather, all-to-all and slice
steps), a Partial input (a Reduction's) summed first. On one device
there is nothing to move, and each emits its input as it is. Pipeline
marks a stage boundary and stays an identity.
"""
from __future__ import annotations

from ..ffconst import OperatorType
from ..parallel.local_ops import is_dtensor
from .registry import OpDef, register


class _ShardingTransitionBase(OpDef):
    """Identity at the value level; sharding change at the mesh level."""

    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[0], in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        x = inputs[0]
        st = getattr(ctx, "strategy", None)
        if st is None or not is_dtensor(x):
            return [x]
        from ..parallel.reshard import planner_for, resolve_partial
        spec = st.output_sharding(name)
        if spec is None:
            # no layout asked for: only a Partial input is summed
            return [x.redistribute(x.device_mesh,
                                   resolve_partial(x.placements))]
        return [planner_for(st).apply(x, spec)]


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
    """Pipeline stage boundary marker: an identity as a graph node. The
    stages of a pipeline region run over the pp ranks
    (``parallel/pipeline.py``); no op marks their boundaries."""
    op_type = OperatorType.OP_PIPELINE

    def emit(self, params, inputs, weights, ctx, name):
        return [inputs[0]]


@register
class FusedParallelOp(_ShardingTransitionBase):
    """A chain of parallel ops collapsed into one transition: the net
    effect is the final layout."""
    op_type = OperatorType.OP_FUSED_PARALLEL
