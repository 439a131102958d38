"""ParallelTensor shape machinery.

The port of ``flexflow_tpu/parallel/ptensor.py``. Reference parity:
``include/flexflow/parallel_tensor.h:36-70`` —
``ParallelDim {size, degree, parallel_idx, is_replica_dim}`` and
``ParallelTensorShape``. Here a dim's ``degree`` is realized as the product
of named mesh axes assigned to that dim; replica dims become replication
over mesh axes (the unnamed remainder of the mesh in GSPMD terms).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from ..ffconst import DataType


@dataclasses.dataclass(frozen=True)
class ParallelDim:
    size: int                       # logical (global) size of this dim
    degree: int = 1                 # #shards along this dim
    mesh_axes: Tuple[str, ...] = () # mesh axes realizing the degree
    is_replica_dim: bool = False

    def __post_init__(self):
        if self.mesh_axes:
            # degree must match the product of its mesh axes at mesh-bind time
            pass

    @property
    def shard_size(self) -> int:
        if self.size % max(self.degree, 1) != 0:
            raise ValueError(f"size {self.size} not divisible by "
                             f"degree {self.degree}")
        return self.size // max(self.degree, 1)


@dataclasses.dataclass(frozen=True)
class ParallelTensorShape:
    dims: Tuple[ParallelDim, ...]
    dtype: DataType = DataType.DT_FLOAT

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    def global_shape(self) -> Tuple[int, ...]:
        return tuple(d.size for d in self.dims if not d.is_replica_dim)

    def shard_shape(self) -> Tuple[int, ...]:
        return tuple(d.shard_size for d in self.dims if not d.is_replica_dim)

    def total_degree(self) -> int:
        p = 1
        for d in self.dims:
            p *= d.degree
        return p

    def partition_spec(self) -> Tuple:
        """The sharding spec over non-replica dims: a tuple of axis names,
        axis-name tuples and None (``parallel/strategy.py``)."""
        entries = []
        for d in self.dims:
            if d.is_replica_dim:
                continue
            if not d.mesh_axes:
                entries.append(None)
            elif len(d.mesh_axes) == 1:
                entries.append(d.mesh_axes[0])
            else:
                entries.append(tuple(d.mesh_axes))
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    @classmethod
    def from_shape(cls, shape: Sequence[int], dtype: DataType = DataType.DT_FLOAT,
                   degrees: Optional[Sequence[int]] = None,
                   axes: Optional[Sequence[Tuple[str, ...]]] = None
                   ) -> "ParallelTensorShape":
        n = len(shape)
        degrees = list(degrees or [1] * n)
        axes = list(axes or [()] * n)
        return cls(tuple(ParallelDim(int(s), int(dg), tuple(ax))
                         for s, dg, ax in zip(shape, degrees, axes)), dtype)
