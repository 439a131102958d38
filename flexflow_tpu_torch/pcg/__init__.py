"""Parallel Computation Graph (PCG) — the searched graph level (the port
of ``flexflow_tpu/pcg``).

Reference analog: ``PCG::Graph`` (``include/flexflow/graph.h:293-377``,
``src/runtime/graph.cc``). Users build a lazy Layer graph; ``FFModel.compile``
lowers it to a PCG whose nodes carry *parallel annotations* (which dims are
partitioned over which mesh-axis groups, which weights co-shard, which
outputs hold partial sums) and whose communication is reified as parallel-op
nodes (Repartition / Combine / Replicate / Reduction). The auto-parallelization
search rewrites this graph; the chosen PCG converts back to an executable
program + ShardingStrategy.
"""
from .graph import Edge, Graph, PNode, ParAnn, GraphProgramInfo

__all__ = ["Edge", "Graph", "PNode", "ParAnn", "GraphProgramInfo"]
