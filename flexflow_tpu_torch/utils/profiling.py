"""Profiling / tracing.

The port of ``flexflow_tpu/utils/profiling.py`` on PyTorch:

  - :func:`sync` waits for the device work feeding a value
    (``torch.cuda.synchronize`` on the device of its first CUDA tensor;
    the JAX package fetches a leaf to the host instead);
  - :func:`profile_region` and ``Profiler(trace_dir=...)`` trace with
    ``torch.profiler`` where the JAX package uses ``jax.profiler``, and
    write a Chrome trace (Perfetto / ``chrome://tracing``) into
    ``trace_dir``;
  - :class:`Profiler` keeps the JAX package's per-step summary (the first
    step apart, then mean / p50 / p90 / max) and its registry gauges. A
    step given a CUDA ``sync_value`` is timed by CUDA events on that
    device's current stream: the device time from the step's first
    enqueue to its last, where the host clock of an eager step would
    read the host's enqueue time. Without one it is timed on the host
    clock. PyTorch compiles nothing, so the first step's time is
    warm-up (library initialisation, the first kernel launches), not a
    compile.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _first_cuda_tensor(value: Any) -> Optional[torch.Tensor]:
    """The first CUDA tensor among the leaves of nested dicts, lists and
    tuples (None when there is none)."""
    if isinstance(value, torch.Tensor):
        return value if value.is_cuda else None
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            t = _first_cuda_tensor(v)
            if t is not None:
                return t
    return None


def sync(value: Any) -> None:
    """Wait for the device work feeding ``value`` (nested dicts / lists
    of tensors): ``torch.cuda.synchronize`` on its first CUDA tensor's
    device; a value with no CUDA tensor needs no wait."""
    t = _first_cuda_tensor(value)
    if t is not None:
        torch.cuda.synchronize(t.device)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _trace_file(trace_dir: str, name: str) -> str:
    os.makedirs(trace_dir, exist_ok=True)
    return os.path.join(trace_dir, f"{name}.{os.getpid()}.pt.trace.json")


@contextlib.contextmanager
def profile_region(name: str, trace_dir: Optional[str] = None):
    """A named ``torch.profiler`` range around a region; with
    ``trace_dir``, the region is also profiled and its Chrome trace
    written to ``<trace_dir>/<name>.<pid>.pt.trace.json``."""
    if trace_dir:
        with torch.profiler.profile(activities=_activities()) as prof:
            with torch.profiler.record_function(name):
                yield
        prof.export_chrome_trace(_trace_file(trace_dir, name))
    else:
        with torch.profiler.record_function(name):
            yield


class Profiler:
    """Per-step timing accumulator.

    ``name`` labels this profiler's gauges in the metrics registry so
    two profilers in one process (train + eval loops) don't overwrite
    each other's ``ff_profiler_*`` rows."""

    def __init__(self, trace_dir: Optional[str] = None,
                 name: str = "default"):
        self.trace_dir = trace_dir
        self.name = name
        self.step_times: List[float] = []
        self.compile_time: float = 0.0
        self._trace_active = False
        self._prof = None

    def start_trace(self):
        if self.trace_dir and not self._trace_active:
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.__enter__()
            self._trace_active = True

    def stop_trace(self):
        if self._trace_active:
            self._prof.__exit__(None, None, None)
            self._prof.export_chrome_trace(
                _trace_file(self.trace_dir, f"profiler_{self.name}"))
            self._prof = None
            self._trace_active = False

    @contextlib.contextmanager
    def step(self, sync_value=None):
        dev = _first_cuda_tensor(sync_value)
        if dev is not None:
            stream = torch.cuda.current_stream(dev.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            yield
            end.record(stream)
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        if not self.step_times:
            self.compile_time = dt   # the first step: warm-up
        self.step_times.append(dt)

    def summary(self) -> Dict[str, float]:
        # steady-state excludes the first (warm-up) step; with a SINGLE
        # recorded step there is no steady-state sample at all, so the
        # steady stats are 0.0 there and compile_s carries the one
        # measurement
        steady = self.step_times[1:]
        out = {
            "steps": len(self.step_times),
            "compile_s": self.compile_time,
            "mean_step_s": float(np.mean(steady)) if steady else 0.0,
            "p50_step_s": float(np.median(steady)) if steady else 0.0,
            "p90_step_s": float(np.percentile(steady, 90))
            if steady else 0.0,
            "max_step_s": float(np.max(steady)) if steady else 0.0,
            "total_s": float(np.sum(self.step_times)),
        }
        # route the summary into the metrics registry so a serving /
        # training process exposes its step timings at GET /metrics
        from ..obs.metrics_registry import REGISTRY
        for k in ("compile_s", "mean_step_s", "p50_step_s",
                  "p90_step_s", "max_step_s"):
            REGISTRY.gauge(f"ff_profiler_{k}",
                           f"Profiler.summary() {k}").set(
                out[k], profiler=self.name)
        return out
