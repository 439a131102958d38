"""Pipeline parallelism over the ranks of a pp mesh axis: GPipe, the
interleaved (circular) schedule, tensor parallelism inside the stages and
the ragged schedule.

The port of ``flexflow_tpu/parallel/pipeline.py``. The reference only
reserves an enum and task ids for pipelining (``OP_PIPELINE``,
``ffconst.h:159``; ``PIPELINE_*_TASK_ID``, ``model.h:190-192``). The JAX
package runs the schedule as one SPMD ``lax.scan`` whose hand-off is a
``ppermute``: every stage computes every step, masked garbage in the
bubble, and the backward comes from AD through the scan. Here each stage
is a rank (or the tp ranks of one stage) and runs only its real
(chunk, microbatch) slots, in the order of the JAX schedule's local
clock:

- forward: stage s takes microbatch m's activation from stage s - 1 (or,
  at stage 0's first chunk, from the rows entering the region), runs its
  chunk, and sends the result on (``Handoff``: point-to-point transfers
  between neighbours on the pp axis, non-blocking sends, blocking
  receives, each message tagged by its slot);
- backward, in the reverse order: the cotangent of a slot's output comes
  from the next stage (or, at the last one, from the layers past the
  region), ``torch.autograd.backward`` runs the chunk's backward from the
  saved output, and the cotangent of its input goes back.

Schedule, ``n_chunks == 1`` (GPipe): each stage runs microbatches
0 ... M - 1 forward, then backward in reverse. ``n_chunks = v > 1``
(interleaved): the block run is cut into v*S chunks, stage s owns chunks
{s, S + s, ...}, and the activation ring wraps from stage S - 1 to 0, so
each microbatch circles the ring v times (requires M % S == 0). The
ragged schedule runs ``counts[s]`` blocks on stage s, with the embedding
prologue inside stage 0 and the head epilogue inside stage S - 1.

The layers before and after the region, and the loss, run as ordinary
sharded ops on every rank (``Executor``); the region's edges are
``pipeline_lowering.region_entry_transition`` /
``region_exit_transition``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from .distributed import Handoff

__all__ = ["Handoff", "gpipe", "gpipe_backward", "schedule_slots",
           "tp_copy", "tp_reduce"]


def schedule_slots(n_stages: int, n_microbatches: int, n_chunks: int = 1
                   ) -> List[Tuple[int, int]]:
    """A stage's (chunk slot k, microbatch m) in the order it runs them:
    the JAX schedule's local clock u = 0 ... M*v - 1, with
    ``k = (u // S) % v`` and ``m = u % S + S * (u // (S*v))`` (u itself
    under GPipe)."""
    S, M, v = n_stages, n_microbatches, max(n_chunks, 1)
    return [((u // S) % v, (u % S) + S * (u // (S * v)))
            for u in range(M * v)]


class _TpCopy(torch.autograd.Function):
    """Megatron's f: the identity forward; the cotangent summed over the
    tp group backward (each tp rank's partial through its column-split
    product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _TpReduce(torch.autograd.Function):
    """Megatron's g: the partial sums of the tp group added forward (the
    row-split product's output); the same cotangent on every tp rank
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    return _TpCopy.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _TpReduce.apply(x, group)


def _tag(chunk: int, m: int, n_micro: int, backward: bool) -> int:
    """The tag of the message that slot (global chunk ``chunk``,
    microbatch ``m``) receives."""
    return 2 * (chunk * n_micro + m) + int(backward)


def gpipe(run_slot: Callable, first_in: Callable, handoff: Handoff,
          stage: int, n_stages: int, n_microbatches: int, n_chunks: int,
          act_shape, act_dtype, device, training: bool):
    """The forward half of the schedule on this stage. ``run_slot(k, m,
    x)`` runs chunk slot ``k`` on microbatch ``m``'s activation ``x``;
    ``first_in(m)`` is microbatch m's activation entering the region (at
    stage 0). Returns ``(outputs, saved)``: the region's output of each
    microbatch (on the last stage; empty elsewhere), and the slots'
    (k, m, x, y) for :func:`gpipe_backward`."""
    S, M, v = n_stages, n_microbatches, max(n_chunks, 1)
    s = stage
    outputs: Dict[int, torch.Tensor] = {}
    saved = []
    for k, m in schedule_slots(S, M, v):
        c = k * S + s
        if s == 0 and k == 0:
            x = first_in(m)
        else:
            x = handoff.recv(act_shape, act_dtype, device, (s - 1) % S,
                             _tag(c, m, M, False))
            if training:
                x.requires_grad_(True)
        y = run_slot(k, m, x)
        if s == S - 1 and k == v - 1:
            outputs[m] = y
        else:
            handoff.send(y, (s + 1) % S, _tag(c + 1, m, M, False))
        if training:
            saved.append((k, m, x, y))
    handoff.flush()
    return outputs, saved


def gpipe_backward(saved, g_final: Callable, handoff: Handoff, stage: int,
                   n_stages: int, n_microbatches: int, n_chunks: int
                   ) -> None:
    """The backward half: the slots of ``saved`` in reverse order, each
    slot's output cotangent from the next stage (or ``g_final(m)`` for
    the region's output), its input's sent back. Stage 0's first chunk
    takes the cotangent of the region's entry into its autograd graph
    (the entry rows, or the ragged prologue)."""
    S, M, v = n_stages, n_microbatches, max(n_chunks, 1)
    s = stage
    while saved:
        k, m, x, y = saved.pop()
        c = k * S + s
        if s == S - 1 and k == v - 1:
            g = g_final(m)
        else:
            g = handoff.recv(y.shape, y.dtype, y.device, (s + 1) % S,
                             _tag(c, m, M, True))
        torch.autograd.backward(y, g)
        del y
        if not (s == 0 and k == 0):
            gx = x.grad if x.grad is not None else torch.zeros_like(x)
            handoff.send(gx, (s - 1) % S, _tag(c - 1, m, M, True))
        del x
    handoff.flush()
