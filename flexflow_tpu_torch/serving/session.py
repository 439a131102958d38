"""Inference session: bucketed batches through the compiled forward.

The port of ``InferenceSession.infer`` in ``flexflow_tpu/serving/
session.py``, the session every serving front end wraps. Requests of any
row count are padded with zero rows up to the nearest batch bucket, run
through ``Executor.make_forward`` and sliced back; batches larger than the
largest bucket run in bucket-sized chunks. ``generate``, the fault hook
and request tracing come with later slices.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_NP_DTYPES = {torch.bool: np.bool_, torch.int8: np.int8,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.float32: np.float32, torch.float64: np.float64}


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class InferenceSession:
    """Wraps a compiled FFModel for serving."""

    def __init__(self, ff, batch_buckets: Sequence[int] = (1, 4, 16, 64)):
        if ff.executor is None:
            raise ValueError("compile() the model first")
        self.ff = ff
        self.buckets = sorted(set(int(b) for b in batch_buckets))
        self._fwd = ff.executor.make_forward()
        self._lock = threading.Lock()

    @property
    def input_names(self) -> List[str]:
        return [t.name for t in self.ff.graph_inputs]

    @property
    def input_signature(self) -> Dict[str, Tuple[Tuple[int, ...],
                                                 np.dtype]]:
        """name -> (compile-time shape, numpy dtype) of each graph input;
        ``shape[0]`` is the compile-time batch size."""
        return {t.name: (tuple(t.shape),
                         np.dtype(_NP_DTYPES[t.torch_dtype]))
                for t in self.ff.graph_inputs}

    def infer(self, inputs: Dict[str, np.ndarray]) -> np.ndarray:
        """Run one batch; pads to the bucket and slices the result.
        Client errors (missing inputs, ragged rows) raise ValueError."""
        names = self.input_names
        missing = [n for n in names if n not in inputs]
        if missing:
            raise ValueError(f"missing inputs: {missing}")
        n = int(next(iter(inputs.values())).shape[0])
        cap = self.buckets[-1]
        if n > cap:
            return np.concatenate(
                [self.infer({k: v[i:i + cap] for k, v in inputs.items()})
                 for i in range(0, n, cap)], axis=0)
        bucket = _next_bucket(n, self.buckets)
        padded = {}
        for name in names:
            arr = np.ascontiguousarray(inputs[name])
            if arr.shape[0] != n:
                raise ValueError(f"ragged batch: {name} has "
                                 f"{arr.shape[0]} rows, want {n}")
            if bucket != n:
                pad = np.zeros((bucket - n,) + arr.shape[1:], arr.dtype)
                arr = np.concatenate([arr, pad], axis=0)
            padded[name] = arr
        with self._lock:  # one forward of this model at a time
            out = self._fwd(self.ff.params, self.ff.state, padded)
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy()[:n]
