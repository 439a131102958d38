"""Dynamic recompilation (reference ``RecompileState``,
``include/flexflow/recompile.h:26``, ``FFModel::recompile_on_condition``,
``src/runtime/model.cc:2422``).

The port of ``flexflow_tpu/runtime/recompile.py``. The reference
evaluates a user trigger each iteration and, when it fires, runs an alter
function that mutates the model (used for MoE cache swaps). Here the
alter function may mutate the FFModel, its config, optimizer or layers;
the executor's cached step closures are then dropped, so the next call
rebuilds them against the altered model (the JAX package drops its
jitted steps, which re-trace).
"""
from __future__ import annotations

from typing import Callable, Optional

from ..obs import events as obs_events
from ..obs.metrics_registry import REGISTRY


class RecompileState:
    """trigger() -> bool evaluated once per training iteration; when true,
    alter(ff) runs and the executor's cached steps are dropped."""

    def __init__(self, trigger: Callable[["RecompileState"], bool],
                 alter: Callable[["RecompileState"], None], ff=None):
        self.trigger = trigger
        self.alter = alter
        self.ff = ff
        self.recompilations = 0
        # free-form slots the reference exposes for trigger bookkeeping
        self.last_metric: Optional[float] = None
        self.iteration = 0

    def step(self, ff) -> bool:
        """Evaluate once per iteration; returns True if a recompile ran."""
        self.iteration += 1
        if not self.trigger(self):
            return False
        self.alter(self)
        self.recompilations += 1
        # recompile events: an instant in the trace (the next step's
        # span shows phase="compile" again) + a scrapeable counter
        obs_events.instant("runtime.recompile", iteration=self.iteration,
                           recompilations=self.recompilations)
        obs_events.counter("executor.recompiles")
        REGISTRY.counter(
            "ff_recompiles_total",
            "Dynamic recompilations (recompile_on_condition)").inc()
        # drop the cached steps; params/opt state survive (the graph may
        # have changed shape-compatibly — the user's responsibility, as
        # in the reference)
        if ff.executor is not None:
            ff.executor._train_step = None
            ff.executor._eval_step = None
            ff.executor._forward_fn = None
        return True
