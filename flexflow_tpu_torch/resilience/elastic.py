"""Elastic sizing: what a machine or a world shrinks to after a loss.

The port of ``flexflow_tpu/resilience/elastic.py``'s arithmetic, which
the :class:`~.supervisor.WorldSupervisor`'s shrink path uses to re-form
a world of ranks after rank loss (it records each shrink as an
``elastic_replans`` fact in :mod:`.status`, as the JAX package does):

  - :func:`surviving_device_count` — the largest device count <= the
    survivors that divides the global batch (batch divisibility is the
    same constraint the search itself obeys);
  - :func:`shrunken_world_size` — the same one level up, in processes;
  - :func:`shrunken_spec` — a :class:`MachineSpec` for the post-loss
    machine.

The JAX package's ``replan_on_device_loss`` re-plans ONE process's mesh
onto fewer of its own devices and reshards the restored state onto it.
A port process drives one device, so there is no mesh of its own to
shrink until a process can hold a mesh larger than the world (ROADMAP
queue 1, item 4.1's leftover); ``Supervisor(elastic=True)`` refuses a
``DeviceLoss`` until then.
"""
from __future__ import annotations

import dataclasses


def surviving_device_count(n_alive: int, batch_size: int) -> int:
    """Largest usable device count <= ``n_alive``: the global batch must
    divide over the data-parallel shards (the constraint every strategy
    the search emits already satisfies)."""
    for n in range(max(1, n_alive), 0, -1):
        if batch_size % n == 0:
            return n
    return 1


def shrunken_world_size(n_alive_ranks: int, batch_size: int,
                        devices_per_rank: int = 1) -> int:
    """Largest usable PROCESS count <= ``n_alive_ranks`` after rank
    loss: the global batch must divide over the shrunken world's total
    devices, same constraint as :func:`surviving_device_count` one
    level up. ``batch_size`` 0/unknown accepts any survivor count.
    Used by the world supervisor's shrink path."""
    n_alive_ranks = max(1, n_alive_ranks)
    if batch_size <= 0:
        return n_alive_ranks
    for n in range(n_alive_ranks, 0, -1):
        if batch_size % (n * max(1, devices_per_rank)) == 0:
            return n
    return 1


def shrunken_spec(spec, n_devices: int):
    """A :class:`MachineSpec` for the post-loss machine: same hardware
    generation/constants, fewer devices. The physical ICI shape and any
    explicit fabric no longer describe the surviving set — drop them so
    the mesh refactorizes from the device count (the detect() path)."""
    return dataclasses.replace(
        spec, num_devices=n_devices, ici_shape=None,
        topology_override=None, num_slices=1, num_hosts=1)
