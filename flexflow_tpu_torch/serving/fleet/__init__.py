"""Serving fleet: continuous batching, multi-replica routing, and
signal-driven autoscaling.

The port of ``flexflow_tpu/serving/fleet``. The three cooperating parts:

* :mod:`.continuous` — :class:`ContinuousBatcher`, the iteration-level
  decode engine: a fixed KV-slot pool, admission/eviction at
  ``decode_segment`` boundaries, bit-exact per sequence vs the
  sequential ``generate`` oracle.
* :mod:`.router` — :class:`FleetRouter` + ``serve_fleet``: least-
  estimated-wait routing over replica ``/healthz`` signals, failover,
  remaining-deadline propagation, sketch-merged fleet metrics.
* :mod:`.autoscale` — :class:`Autoscaler`: repair / scale-up /
  scale-down from queue-depth EWMA and SLO-violation deltas.
"""
from .autoscale import Autoscaler, AutoscalerConfig, decide
from .continuous import (ContinuousBatcher, EngineClosedError,
                         SequenceError, kv_slot_capacity)
from .router import (FleetHandle, FleetRouter, NoReplicaAvailableError,
                     Replica, free_port, merge_replica_metrics,
                     serve_fleet)

__all__ = [
    "Autoscaler", "AutoscalerConfig", "ContinuousBatcher",
    "EngineClosedError", "FleetHandle", "FleetRouter",
    "NoReplicaAvailableError", "Replica", "SequenceError", "decide",
    "free_port", "kv_slot_capacity", "merge_replica_metrics",
    "serve_fleet",
]
