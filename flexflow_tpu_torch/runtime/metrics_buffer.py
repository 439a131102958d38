"""Device-resident metric accumulation for the train loop.

The port of ``flexflow_tpu/runtime/metrics_buffer.py``. PyTorch on the
card runs ahead of the host until something reads a device value back;
reading each step's loss would make every step wait for the one before.
So:

  - each step's metric dict (0-dim device tensors, with the step's
    ``all_finite`` flag) is *pushed* without a read;
  - a bounded in-flight window (``FFConfig.async_dispatch_steps``,
    default 8) keeps the host from racing unboundedly ahead: pushing
    step N waits for the step leaving the window (N - window), through a
    CUDA event recorded when that step was pushed;
  - :meth:`flush` reads every pending step back in **one** copy (all
    scalars stacked into one tensor) and folds them, in push order, into
    the attached :class:`~flexflow_tpu_torch.runtime.metrics.PerfMetrics`;
  - the NaN screen checks the fetched ``all_finite`` flags at flushes:
    the first non-finite step is kept (:attr:`first_bad_step`) and
    :meth:`raise_if_poisoned` raises :class:`NonFiniteMetrics`.

``FF_SYNC_EVERY_STEP=1`` or ``async_dispatch_steps <= 0`` flushes at every
push.
"""
from __future__ import annotations

import math
import os
from collections import deque
from typing import Any, Dict, Optional

import torch

ENV_SYNC = "FF_SYNC_EVERY_STEP"

#: metric key of the step's loss-finiteness flag; stripped from the
#: dicts folded into PerfMetrics
ALL_FINITE_KEY = "all_finite"


def sync_every_step_forced() -> bool:
    """Is the sync-every-step fallback forced by the environment?"""
    return os.environ.get(ENV_SYNC, "").strip().lower() in (
        "1", "true", "yes", "on")


class NonFiniteMetrics(RuntimeError):
    """A flushed step reported a non-finite loss. ``step`` is the global
    train-step index of the FIRST bad step in the flushed run."""

    def __init__(self, step: int, value: float):
        super().__init__(f"non-finite loss {value} at step {step}")
        self.step = step
        self.value = value


class MetricsBuffer:
    """Deferred, device-resident per-step metric accumulator.

    ``window <= 0`` means sync-every-step. ``pm`` is the PerfMetrics that
    flushes fold into. ``max_pending`` bounds memory: a loop that
    reaches no flush point for a long stretch still folds every
    ``max_pending`` steps."""

    def __init__(self, window: int = 8, pm=None, max_pending: int = 512):
        self.window = int(window)
        self.max_pending = max(1, int(max_pending))
        self.pm = pm
        # (global step index, device metric dict, batch size, event)
        self._pending: deque = deque()
        self.first_bad_step: Optional[int] = None
        self.first_bad_value: float = float("nan")

    @classmethod
    def for_config(cls, config, pm=None) -> "MetricsBuffer":
        window = int(getattr(config, "async_dispatch_steps", 8))
        if sync_every_step_forced():
            window = 0
        return cls(window=window, pm=pm)

    @property
    def sync(self) -> bool:
        return self.window <= 0

    @property
    def pending(self) -> int:
        return len(self._pending)

    def raise_if_poisoned(self) -> None:
        if self.first_bad_step is not None:
            raise NonFiniteMetrics(self.first_bad_step,
                                   self.first_bad_value)

    def push(self, step_idx: int, bm: Dict[str, Any],
             batch_size: int) -> None:
        """Record one step's device metric dict; no read-back unless
        sync."""
        event = None
        if not self.sync and any(
                isinstance(v, torch.Tensor) and v.is_cuda
                for v in bm.values()):
            event = torch.cuda.Event()
            event.record()
        self._pending.append((int(step_idx), bm, int(batch_size), event))
        if self.sync or len(self._pending) >= self.max_pending:
            self.flush()
            return
        if len(self._pending) > self.window:
            # bound in-flight work: wait for the step LEAVING the window
            leaving = self._pending[len(self._pending) - self.window - 1]
            if leaving[3] is not None:
                leaving[3].synchronize()

    def flush(self) -> int:
        """Read every pending step back in one copy, fold into ``pm`` in
        push order, update the NaN screen. Returns the steps folded."""
        if not self._pending:
            return 0
        entries = list(self._pending)
        self._pending.clear()
        keys = [sorted(bm) for _, bm, _, _ in entries]
        flat = [torch.as_tensor(bm[k]).detach().reshape(()).float()
                for (_, bm, _, _), ks in zip(entries, keys) for k in ks]
        values = torch.stack(flat).cpu().tolist() if flat else []
        pos = 0
        for (step_idx, _, bsz, _), ks in zip(entries, keys):
            vals = dict(zip(ks, values[pos:pos + len(ks)]))
            pos += len(ks)
            ok = vals.pop(ALL_FINITE_KEY, None)
            loss = vals.get("loss")
            if ok is None:
                ok = loss is None or math.isfinite(loss)
            if self.pm is not None:
                self.pm.update(vals, bsz)
            if not bool(ok) and self.first_bad_step is None:
                self.first_bad_step = step_idx
                self.first_bad_value = loss if loss is not None \
                    else float("nan")
        return len(entries)
