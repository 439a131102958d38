"""Resilience subsystem: fault injection, verified atomic checkpoints,
auto-resume and rollback, and cross-process world recovery.

The port of ``flexflow_tpu/resilience``:

  - :mod:`.faults` — deterministic fault injection
    (``FF_FAULT_PLAN="crash@2;nan@5;corrupt_ckpt@6"`` or
    :func:`faults.install`): crash-at-step, NaN/Inf corruption,
    checkpoint corruption/truncation, inference failures, virtual device
    loss, and the rank-scoped multi-process kinds (``rank_crash@N:r``,
    ``rank_hang@N:r``, ``corrupt_shard@N:r``, ``crash_after_stage@N:r``;
    ``FF_FAULT_PLAN_EPOCH0`` arms a plan in world epoch 0 only);
  - :mod:`.coord` — multi-process failure detection: per-rank
    heartbeats over the world's store (the ``TCPStore`` of the
    rendezvous), bounded barriers (never hang forever — timeouts raise
    :class:`~.coord.RankFailure` with the dead rank attributed), the
    attribution of a collective's error to a dead peer, and the
    monotonic world epoch;
  - hardened checkpoints (``runtime/checkpoint.py``) — atomic
    staging-dir + rename saves, a per-leaf shape/dtype/CRC32 manifest
    verified on restore, async saves, restore that falls back past
    corrupt or partial steps, and (over a world) a two-phase
    stage/commit protocol with all-rank quorum restore; the files are
    the JAX package's, so a step written by either package restores
    into the other;
  - :mod:`.supervisor` — a resilient training driver: auto-resume from
    the newest valid checkpoint (exact dataloader resume), bounded
    restarts with exponential backoff + jitter, NaN-loss rollback; plus
    the launcher-side :class:`~.supervisor.WorldSupervisor` that
    re-forms a world after rank failure (relaunch under a restart
    budget, else shrink to a batch-divisible survivor world);
  - :mod:`.elastic` — the shrink arithmetic;
  - :mod:`.status` — always-on restart/fault/checkpoint/world facts.

The in-process elastic re-plan (``elastic.replan_on_device_loss``)
waits for a mesh described larger than the world (ROADMAP queue 1, item
4.1's leftover); ``replan`` comes with analysis and replanning (item 7).
"""
from . import coord, elastic, faults, status
from .coord import EXIT_RANK_FAILURE, Coordinator, RankFailure
from .faults import (DeviceLoss, FaultError, FaultPlan, SimulatedCrash,
                     install as install_fault_plan)
from .supervisor import (RestartBudgetExceeded, Supervisor, WorldFailure,
                         WorldSupervisor, run_supervised,
                         run_world_member)

__all__ = [
    "faults", "status", "elastic", "coord",
    "FaultPlan", "FaultError", "SimulatedCrash", "DeviceLoss",
    "install_fault_plan",
    "Supervisor", "run_supervised", "RestartBudgetExceeded",
    "Coordinator", "RankFailure", "EXIT_RANK_FAILURE",
    "WorldSupervisor", "WorldFailure", "run_world_member",
]
