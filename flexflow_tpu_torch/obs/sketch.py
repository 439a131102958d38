"""Mergeable streaming quantile sketch (DDSketch-style).

The port of ``flexflow_tpu/obs/sketch.py``, unchanged (plain Python):
``to_dict`` / ``from_dict`` write and read the same documents, so a
sketch serialized by either package merges into the other's.

A relative-error quantile estimator over log-spaced buckets: serving
reports p50/p90/p99/p99.9 per (model, bucket) with bounded memory no
matter how many requests flow through. For any value ``v`` inserted,
``quantile(q)`` returns an estimate within a factor of
``(1 + alpha) / (1 - alpha)`` of the true q-quantile (relative error
``alpha``, default 1%). Sketches with the same ``alpha`` merge exactly
(bucket-wise count addition), so per-bucket sketches combine into a
per-model aggregate and replica snapshots union into fleet quantiles.

Not internally locked: callers (``SchedulerMetrics``) already hold a
lock around every mutation.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["QuantileSketch"]


class QuantileSketch:
    """Log-bucketed relative-error quantile estimator.

    ``alpha`` is the relative accuracy: quantile estimates are within
    ``alpha`` (to first order) of the true value.  ``max_bins`` bounds
    memory: when exceeded, the *lowest* buckets collapse together (the
    tail — p99 and up — is what serving cares about, so accuracy is
    sacrificed at the floor, never the ceiling).  Values at or below
    ``min_value`` land in a dedicated zero bucket.
    """

    __slots__ = ("alpha", "gamma", "_log_gamma", "max_bins", "min_value",
                 "_bins", "_zero", "count", "total", "min", "max")

    def __init__(self, alpha: float = 0.01, max_bins: int = 2048,
                 min_value: float = 1e-9):
        if not (0.0 < alpha < 1.0):
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        if max_bins < 2:
            raise ValueError(f"max_bins must be >= 2, got {max_bins}")
        self.alpha = float(alpha)
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self.gamma)
        self.max_bins = int(max_bins)
        self.min_value = float(min_value)
        self._bins: Dict[int, int] = {}
        self._zero = 0
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- ingest ---------------------------------------------------------

    def add(self, value: float) -> None:
        v = float(value)
        if v != v:              # NaN: drop rather than poison the sketch
            return
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= self.min_value:
            self._zero += 1
            return
        idx = int(math.ceil(math.log(v) / self._log_gamma))
        self._bins[idx] = self._bins.get(idx, 0) + 1
        if len(self._bins) > self.max_bins:
            self._collapse()

    def _collapse(self) -> None:
        # fold the lowest bucket into its neighbour until under budget —
        # low quantiles blur, the tail stays at full resolution
        keys = sorted(self._bins)
        while len(keys) > self.max_bins:
            lo = keys.pop(0)
            self._bins[keys[0]] = self._bins.get(keys[0], 0) \
                + self._bins.pop(lo)

    # -- query ----------------------------------------------------------

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]); NaN when empty."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return math.nan
        rank = q * (self.count - 1)
        seen = self._zero
        if rank < seen or not self._bins:
            return 0.0 if self._zero else self.min
        for idx in sorted(self._bins):
            seen += self._bins[idx]
            if rank < seen:
                # midpoint of the bucket's value range in log space
                est = 2.0 * self.gamma ** idx / (self.gamma + 1.0)
                # clamp to observed extremes: bucket midpoints can land
                # just outside [min, max] at the edges
                return min(max(est, self.min), self.max)
        return self.max

    def quantiles(self, qs: Sequence[float]) -> List[float]:
        return [self.quantile(q) for q in qs]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    # -- merge / serialize ----------------------------------------------

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (exact for equal ``alpha``)."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with alpha {self.alpha} and "
                f"{other.alpha}: bucket boundaries differ")
        for idx, n in other._bins.items():
            self._bins[idx] = self._bins.get(idx, 0) + n
        self._zero += other._zero
        self.count += other.count
        self.total += other.total
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max
        if len(self._bins) > self.max_bins:
            self._collapse()
        return self

    def copy(self) -> "QuantileSketch":
        s = QuantileSketch(self.alpha, self.max_bins, self.min_value)
        s._bins = dict(self._bins)
        s._zero = self._zero
        s.count = self.count
        s.total = self.total
        s.min = self.min
        s.max = self.max
        return s

    def to_dict(self) -> Dict:
        return {
            "alpha": self.alpha,
            "max_bins": self.max_bins,
            "min_value": self.min_value,
            "zero": self._zero,
            "count": self.count,
            "total": self.total,
            "min": None if self.count == 0 else self.min,
            "max": None if self.count == 0 else self.max,
            "bins": sorted(self._bins.items()),
        }

    @classmethod
    def from_dict(cls, doc: Dict) -> "QuantileSketch":
        s = cls(doc["alpha"], doc["max_bins"], doc["min_value"])
        s._bins = {int(i): int(n) for i, n in doc["bins"]}
        s._zero = int(doc["zero"])
        s.count = int(doc["count"])
        s.total = float(doc["total"])
        s.min = math.inf if doc["min"] is None else float(doc["min"])
        s.max = -math.inf if doc["max"] is None else float(doc["max"])
        return s

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return (f"QuantileSketch(alpha={self.alpha}, count={self.count}, "
                f"bins={len(self._bins)})")
