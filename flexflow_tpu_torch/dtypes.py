"""DataType <-> torch dtype mapping.

Follows the JAX package's policy (``flexflow_tpu/dtypes.py``) so that a
graph built in either package declares the same storage types: DT_HALF
maps to bfloat16, not IEEE fp16; DT_INT64 and DT_DOUBLE narrow to 32 bits
as JAX does with x64 disabled.
"""
from __future__ import annotations

import torch

from .ffconst import DataType

_TO_TORCH = {
    DataType.DT_BOOLEAN: torch.bool,
    DataType.DT_INT32: torch.int32,
    DataType.DT_INT64: torch.int32,
    DataType.DT_HALF: torch.bfloat16,
    DataType.DT_BFLOAT16: torch.bfloat16,
    DataType.DT_FLOAT: torch.float32,
    DataType.DT_DOUBLE: torch.float32,
    DataType.DT_INT8: torch.int8,
    DataType.DT_FLOAT8_E4M3: torch.float8_e4m3fn,
    DataType.DT_FLOAT8_E5M2: torch.float8_e5m2,
}

_FROM_TORCH = {
    torch.bool: DataType.DT_BOOLEAN,
    torch.int8: DataType.DT_INT8,
    torch.int32: DataType.DT_INT32,
    torch.int64: DataType.DT_INT64,
    torch.bfloat16: DataType.DT_BFLOAT16,
    torch.float16: DataType.DT_HALF,
    torch.float32: DataType.DT_FLOAT,
    torch.float64: DataType.DT_DOUBLE,
    torch.float8_e4m3fn: DataType.DT_FLOAT8_E4M3,
    torch.float8_e5m2: DataType.DT_FLOAT8_E5M2,
}


def to_torch(dt: DataType) -> torch.dtype:
    return _TO_TORCH[DataType(dt)]


def itemsize(dt: DataType) -> int:
    """Bytes per element of ``dt`` as stored (the cost model's byte
    counts; the same numbers as the JAX package's)."""
    return to_torch(dt).itemsize


def from_torch_dtype(dtype: torch.dtype) -> DataType:
    return _FROM_TORCH.get(dtype, DataType.DT_FLOAT)
