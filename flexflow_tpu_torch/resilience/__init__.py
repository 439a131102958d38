"""Resilience subsystem: fault injection, verified atomic checkpoints,
auto-resume and rollback, in one process.

The port of ``flexflow_tpu/resilience``'s single-process half:

  - :mod:`.faults` — deterministic fault injection
    (``FF_FAULT_PLAN="crash@2;nan@5;corrupt_ckpt@6"`` or
    :func:`faults.install`): crash-at-step, NaN/Inf corruption,
    checkpoint corruption/truncation, inference failures, virtual device
    loss, and the rank-scoped multi-process kinds;
  - hardened checkpoints (``runtime/checkpoint.py``) — atomic
    staging-dir + rename saves, a per-leaf shape/dtype/CRC32 manifest
    verified on restore, async saves, restore that falls back past
    corrupt or partial steps; the files are the JAX package's, so a step
    written by either package restores into the other;
  - :mod:`.supervisor` — a resilient training driver: auto-resume from
    the newest valid checkpoint (exact dataloader resume), bounded
    restarts with exponential backoff + jitter, NaN-loss rollback;
  - :mod:`.status` — always-on restart/fault/checkpoint facts.

The multi-process half (``coord``, ``WorldSupervisor``, the multi-host
checkpoint format) and ``elastic`` come with the parallel lowering
(ROADMAP queue 1, item 4); ``replan`` with analysis and replanning
(item 7).
"""
from . import faults, status
from .faults import (DeviceLoss, FaultError, FaultPlan, SimulatedCrash,
                     install as install_fault_plan)
from .supervisor import RestartBudgetExceeded, Supervisor, run_supervised

__all__ = [
    "faults", "status",
    "FaultPlan", "FaultError", "SimulatedCrash", "DeviceLoss",
    "install_fault_plan",
    "Supervisor", "run_supervised", "RestartBudgetExceeded",
]
