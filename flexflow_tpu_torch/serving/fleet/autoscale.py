"""Signal-driven autoscaling over the replica fleet.

The port of ``flexflow_tpu/serving/fleet/autoscale.py``, unchanged
(plain Python).
The control loop consumes exactly the signals the serving layer
already emits — the per-replica admission-control EWMA
(``estimated_wait_s``), queue depth, and ``ff_slo_violations_total``
deltas — and turns them into three actions:

* **repair**: a dead replica (crash, ``DEAD_AFTER`` failed polls) is
  replaced immediately up to ``min_replicas`` — the fleet's floor is
  an invariant, not a suggestion.
* **scale up**: predicted wait has exceeded the deadline band (or SLO
  violations are actively accruing) for ``sustain_polls`` consecutive
  ticks and the fleet is below ``max_replicas``. One spawn at a time:
  a pending (spawned, not yet ready) replica blocks further spawns so
  a slow cold start cannot stampede the fleet to max.
* **scale down**: the fleet has been idle (queue EWMA ~ 0, zero wait,
  zero SLO delta) for ``idle_polls`` ticks and sits above
  ``min_replicas`` — one spawned replica takes the graceful-drain
  path (finish in-flight, then exit).

Time-to-ready is recorded per replica by the router's
``ff_replica_time_to_ready_seconds`` gauge, which is the number that
keeps autoscaling honest (a cold replica arriving after the burst it
was scaled for adds no capacity when it was needed).

``decide`` is pure — (config, observed state) -> action — so the
policy is unit-testable without processes.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from ...obs.metrics_registry import REGISTRY
from .router import FleetRouter, Replica

_ACTIONS = REGISTRY.counter(
    "ff_autoscaler_actions_total", "autoscaler actions, by kind")
_TARGET = REGISTRY.gauge(
    "ff_autoscaler_replicas", "autoscaler view of the fleet size")


@dataclasses.dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    #: SLO band: scale up when the best replica's predicted wait
    #: exceeds ``wait_band_fraction`` of the deadline
    deadline_ms: float = 100.0
    wait_band_fraction: float = 0.8
    #: consecutive hot ticks before a scale-up
    sustain_polls: int = 2
    #: consecutive idle ticks before a scale-down
    idle_polls: int = 10
    poll_interval_s: float = 0.5
    #: queue-depth EWMA smoothing (weight of the newest sample)
    ewma_alpha: float = 0.3


def decide(cfg: AutoscalerConfig, alive: int, pending: int,
           hot_streak: int, idle_streak: int) -> str:
    """Pure scaling policy: ``repair`` | ``scale_up`` | ``scale_down``
    | ``hold``. ``alive`` counts ready routable replicas; ``pending``
    counts spawned-but-not-yet-ready ones (they block duplicate
    spawns but do not serve yet)."""
    if alive + pending < cfg.min_replicas:
        return "repair"
    if pending > 0:
        return "hold"  # one cold start in flight at a time
    if alive < cfg.max_replicas and hot_streak >= cfg.sustain_polls:
        return "scale_up"
    if alive > cfg.min_replicas and idle_streak >= cfg.idle_polls:
        return "scale_down"
    return "hold"


class Autoscaler:
    """Control loop bound to a :class:`FleetRouter` that owns spawn
    capability (``spawn_argv``). Call :meth:`start` after the initial
    fleet is up; :meth:`stop` before tearing the router down."""

    def __init__(self, router: FleetRouter,
                 cfg: Optional[AutoscalerConfig] = None):
        self.router = router
        self.cfg = cfg or AutoscalerConfig()
        self._lock = threading.Lock()
        # guarded by _lock:
        self._queue_ewma = 0.0
        self._hot_streak = 0
        self._idle_streak = 0
        self._last_slo_total: Optional[int] = None
        self._actions: List[Dict] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="ff-autoscaler", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout_s)

    def actions(self) -> List[Dict]:
        with self._lock:
            return list(self._actions)

    # -- signal gathering ------------------------------------------

    def _signals(self) -> Dict:
        """Read the router's cached health view (no extra HTTP): per
        model the MIN estimated wait across routable replicas (the
        wait the router can actually achieve), then the max over
        models (the binding constraint); plus summed queue depth and
        the fleet-wide SLO violation total."""
        alive = pending = 0
        queue_sum = 0
        slo_total = 0
        best_wait: Dict[str, float] = {}
        with self.router._lock:
            replicas = list(self.router._replicas)
            for r in replicas:
                ok = r.alive_locked()
                if r.draining:
                    continue
                if not ok:
                    if r.proc is not None and r.proc.poll() is None \
                            and r.ready_at is None:
                        pending += 1
                    continue
                alive += 1
                serving = (r.health or {}).get("serving", {})
                for model, m in serving.items():
                    w = float(m.get("estimated_wait_s", 0.0))
                    queue_sum += int(m.get("queue_depth", 0))
                    slo_total += int(m.get("slo_violations", 0))
                    if m.get("circuit") == "open":
                        # an open breaker is un-routable capacity:
                        # treat as infinite wait on this replica
                        continue
                    cur = best_wait.get(model)
                    if cur is None or w < cur:
                        best_wait[model] = w
        wait = max(best_wait.values()) if best_wait else 0.0
        return {"alive": alive, "pending": pending,
                "queue_sum": queue_sum, "wait_s": wait,
                "slo_total": slo_total}

    # -- loop ------------------------------------------------------

    def tick(self) -> str:
        """One control iteration (public so tests can step it
        deterministically without the thread)."""
        dead = self.router.retire_dead()
        sig = self._signals()
        cfg = self.cfg
        with self._lock:
            self._queue_ewma = ((1 - cfg.ewma_alpha) * self._queue_ewma
                                + cfg.ewma_alpha * sig["queue_sum"])
            prev = self._last_slo_total
            self._last_slo_total = sig["slo_total"]
            slo_delta = 0 if prev is None \
                else max(0, sig["slo_total"] - prev)
            band_s = cfg.deadline_ms / 1e3 * cfg.wait_band_fraction
            hot = sig["wait_s"] > band_s or slo_delta > 0
            idle = (self._queue_ewma < 0.5 and sig["wait_s"] == 0.0
                    and slo_delta == 0)
            self._hot_streak = self._hot_streak + 1 if hot else 0
            self._idle_streak = self._idle_streak + 1 if idle else 0
            hot_streak, idle_streak = \
                self._hot_streak, self._idle_streak
        action = decide(cfg, sig["alive"], sig["pending"],
                        hot_streak, idle_streak)
        if action in ("repair", "scale_up"):
            self.router.spawn()
            with self._lock:
                self._hot_streak = 0
                self._actions.append(
                    {"action": action, "t": time.monotonic(),
                     "dead": [r.name for r in dead],
                     "signals": sig})
            _ACTIONS.inc(kind=action)
        elif action == "scale_down":
            victim = self._pick_drain_victim()
            if victim is not None:
                self.router.drain(victim)
                with self._lock:
                    self._idle_streak = 0
                    self._actions.append(
                        {"action": action, "t": time.monotonic(),
                         "replica": victim.name, "signals": sig})
                _ACTIONS.inc(kind=action)
        _TARGET.set(sig["alive"] + sig["pending"])
        return action

    def _pick_drain_victim(self) -> Optional[Replica]:
        """Newest SPAWNED replica (adopted ones have no drain path)."""
        with self.router._lock:
            cands = [r for r in self.router._replicas
                     if r.proc is not None and not r.draining]
        if not cands:
            return None
        return max(cands, key=lambda r: r.spawned_at)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the control loop must
                # survive transient scrape/spawn errors; next tick
                # re-reads ground truth
                pass
            self._stop.wait(timeout=self.cfg.poll_interval_s)
