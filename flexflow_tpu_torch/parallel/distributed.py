"""Multi-process execution: the torch.distributed control plane.

The port of ``flexflow_tpu/parallel/distributed.py``. The JAX package
joins one controller process per host into a global device world with
``jax.distributed.initialize``, and GSPMD carries the traffic. Here each
rank is a process that drives one device, the ranks meet in one
``torch.distributed`` process group, and the strategy runs over a
``torch.distributed`` device mesh of those ranks (``parallel/machine.py``)
with DTensor placements in the place of GSPMD's shardings.

Launch convention (the JAX package's): set ``FF_COORDINATOR_ADDRESS``
(``host:port``) / ``FF_NUM_PROCESSES`` / ``FF_PROCESS_ID`` on each rank, or
pass ``--coordinator-address`` / ``--nodes`` / ``--process-id``.
``FF_DIST_TIMEOUT_S`` bounds the rendezvous and every collective (120 s
by default), so a rank that dies never leaves its peers waiting for good.

The backend follows the deployment, never a caught error:

- ``nccl`` where each rank has a card of its own (the deployment the port
  is for: one rank per GPU);
- ``gloo`` on the CPU;
- ``gloo`` too where ranks share one card (more ranks than cards: how a
  one-card machine runs a world): NCCL refuses two ranks on one GPU
  ("Duplicate GPU detected").

Gloo runs ``all_reduce``, ``broadcast``, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``all_to_all_single`` on CUDA tensors, but
its functional all-gather (``_c10d_functional.all_gather_into_tensor``,
which DTensor issues to make a sharded value whole) kills the rank on the
card (torch 2.11, ``tools/torch_dist_probe.py``). Ranks that share a card
therefore register :func:`gather_by_c10d`, the c10d all-gather that
runs there, as that op's CUDA kernel (:func:`use_c10d_gather`, which the
CPU tests call on the CPU's kernel). :data:`ROUTES` records the route
each collective takes.
"""
from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

log = logging.getLogger("flexflow_tpu_torch")

DEFAULT_TIMEOUT_S = 120.0


def is_initialized() -> bool:
    """True when this process belongs to a torch.distributed world."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if is_initialized() else 0


def timeout_s() -> float:
    return float(os.environ.get("FF_DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S))


def ranks_share_a_card(world: int) -> bool:
    """More ranks than cards: several ranks drive one GPU."""
    return torch.cuda.is_available() and world > torch.cuda.device_count()


def backend_for(device_type: str, world: int) -> str:
    """The process-group backend for ranks on ``device_type``."""
    if device_type != "cuda" or ranks_share_a_card(world):
        return "gloo"
    return "nccl"


def rank_device(device_type: str, rank: Optional[int] = None
                ) -> torch.device:
    """The device a rank drives: ``cuda:<rank mod cards>`` (every rank on
    ``cuda:0`` when they share one card), or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    rank = process_index() if rank is None else rank
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


#: collective -> the route it takes in this process's world
ROUTES: Dict[str, str] = {}
_ROUTE_LIB = None
#: the ``host:port`` this process's world met at (its TCPStore)
_ADDRESS = ""


def gather_by_c10d(input: torch.Tensor, group_size: int,
                   group_name: str) -> torch.Tensor:
    """``_c10d_functional.all_gather_into_tensor`` (blocks concatenated on
    dim 0) as the synchronous c10d all-gather."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    x = input.reshape(-1) if input.dim() == 0 else input.contiguous()
    out = x.new_empty((group_size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x,
                                group=_resolve_process_group(group_name))
    return out


def use_c10d_gather(device_type: str) -> None:
    """Register :func:`gather_by_c10d` as the functional all-gather's
    kernel for ``device_type`` tensors in this process."""
    global _ROUTE_LIB
    if _ROUTE_LIB is None:
        _ROUTE_LIB = torch.library.Library("_c10d_functional", "IMPL")
        _ROUTE_LIB.impl("all_gather_into_tensor", gather_by_c10d,
                        "CUDA" if device_type == "cuda" else "CPU")
    ROUTES["all_gather"] = f"{ROUTES.get('all_gather', 'gloo')}, c10d " \
        "all_gather_into_tensor for the functional op"


class _GatherDim(torch.autograd.Function):
    """The blocks of ``x`` of every rank of ``group`` concatenated along
    ``dim`` (rank order), by the c10d all-gather. The gathered
    value is replicated over the group, so its cotangent is the same on
    every rank (DTensor sums a partial one before it reaches here): the
    gradient is this rank's block of it."""

    @staticmethod
    def forward(ctx, x, dim, group):
        import torch.distributed as dist
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        x0 = x.movedim(dim, 0).contiguous()
        buf = x0.new_empty((n * x0.shape[0], *x0.shape[1:]))
        dist.all_gather_into_tensor(buf, x0, group=group)
        return buf.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        n = dist.get_world_size(ctx.group)
        blk = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, dist.get_rank(ctx.group) * blk, blk), \
            None, None


class _AllToAllDim(torch.autograd.Function):
    """``x`` split along ``split_dim`` into one block per rank of
    ``group``, block k sent to rank k, the received blocks concatenated
    along ``concat_dim`` (rank order); its gradient is the reverse
    exchange."""

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        import torch.distributed as dist
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        n = dist.get_world_size(group)
        parts = torch.stack(torch.chunk(x, n, dim=split_dim)).contiguous()
        recv = torch.empty_like(parts)
        dist.all_to_all_single(recv, parts, group=group)
        return torch.cat(list(recv.unbind(0)), dim=concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _AllToAllDim.apply(g, concat_dim, split_dim, ctx.group), \
            None, None, None


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather of this rank's block along ``dim`` over ``group``
    (differentiable; synchronous c10d calls)."""
    return _GatherDim.apply(x, dim, group)


def all_to_all_dim(x: torch.Tensor, split_dim: int, concat_dim: int,
                   group) -> torch.Tensor:
    """All-to-all moving ``x``'s split along ``split_dim`` to a
    concatenation along ``concat_dim`` over ``group``
    (differentiable)."""
    return _AllToAllDim.apply(x, split_dim, concat_dim, group)


class _ChunkDim(torch.autograd.Function):
    """This rank's block along ``dim`` of a value replicated over
    ``group`` (blocks in rank order), the adjoint of :class:`_GatherDim`:
    each rank's gradient covers its block only, so the backward gathers
    the blocks' gradients into the whole one, the same on every rank, as
    the replicated value's gradient is."""

    @staticmethod
    def forward(ctx, x, dim, group):
        import torch.distributed as dist
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split evenly {n} ways")
        blk = x.shape[dim] // n
        return x.narrow(dim, dist.get_rank(group) * blk, blk)

    @staticmethod
    def backward(ctx, g):
        return _GatherDim.apply(g.contiguous(), ctx.dim, ctx.group), \
            None, None


def chunk_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, replicated over
    ``group``; the gradient comes back whole on every rank (an all-gather
    in the backward)."""
    return _ChunkDim.apply(x, dim, group)


def p2p_route(device_type: str) -> str:
    """How a point-to-point transfer travels in this world (see
    :class:`Handoff`): ``"host"`` where gloo carries CUDA tensors (ranks
    sharing a card), else ``"direct"``."""
    import torch.distributed as dist
    return "host" if device_type == "cuda" \
        and dist.get_backend() == "gloo" else "direct"


class Handoff:
    """Point-to-point transfers between the ranks of one group along a
    mesh dim ``dim`` (a pipeline's pp group, a ring's seq group): this
    rank's peers are the ranks at the other positions along ``dim`` with
    its own coordinates on every other mesh dim. ``route`` says how a
    tensor travels:

    - ``"direct"``: ``isend`` / ``irecv`` of the tensor itself (the CPU
      under gloo; NCCL with a card a rank);
    - ``"host"``: the tensor staged in host memory and sent by gloo
      (ranks that share a card: gloo's point-to-point reads and writes
      the buffer from the host, and fails on a CUDA tensor's).

    Sends are non-blocking and waited for at :meth:`flush`; receives
    block. Each ordered pair of neighbouring positions (the ring's wrap
    included) talks over a process group of its own, which carries one
    direction only: NCCL runs a communicator's operations in the order
    they were issued, so two ranks sending to each other over one
    communicator would each wait for a receive queued behind its own
    send. Building the groups is collective: every rank constructs its
    ``Handoff`` at the same point (under NCCL each group's communicator
    is made there too, in a fixed order). ``calls`` and ``bytes`` count
    what this rank sent."""

    def __init__(self, mesh, dim: int, route: str):
        import torch.distributed as dist
        self.mesh, self.dim, self.route = mesh, dim, route
        self._pending: List = []
        self.calls = 0
        self.bytes = 0
        S = mesh.size(dim)
        me = dist.get_rank()
        rows = mesh.mesh.movedim(dim, -1).reshape(-1, S).tolist()
        pairs = sorted({(a, (a + 1) % S) for a in range(S)}
                       | {((a + 1) % S, a) for a in range(S)})
        self._groups: Dict[Tuple[int, int], object] = {}
        for row in rows:
            for a, b in pairs:
                if a == b:
                    continue
                g = dist.new_group([row[a], row[b]])
                if me in (row[a], row[b]):
                    self._groups[(a, b)] = g
        self.index = mesh.get_coordinate()[dim]
        # NCCL makes a group's point-to-point communicator at the group's
        # first send or receive, which both its ranks must reach: made
        # here by one transfer a group, in the order the groups were
        # built, so that two ranks whose first transfers fall on
        # different groups do not each wait in the other's
        for (a, b), g in self._groups.items():
            if dist.get_backend(g) == "nccl":
                z = torch.zeros(1, device=torch.device(
                    "cuda", torch.cuda.current_device()))
                if a == self.index:
                    dist.send(z, self.peer(b), group=g)
                else:
                    dist.recv(z, self.peer(a), group=g)

    def peer(self, pos: int) -> int:
        """The global rank at position ``pos`` along ``dim``."""
        coord = list(self.mesh.get_coordinate())
        coord[self.dim] = pos
        return int(self.mesh.mesh[tuple(coord)])

    def send(self, t: torch.Tensor, pos: int, tag: int) -> None:
        import torch.distributed as dist
        t = t.detach().contiguous()
        if self.route == "host":
            t = t.to("cpu")
        work = dist.isend(t, self.peer(pos),
                          group=self._groups[(self.index, pos)], tag=tag)
        self._pending.append((work, t))
        self.calls += 1
        self.bytes += t.numel() * t.element_size()

    def recv(self, shape, dtype, device, pos: int, tag: int
             ) -> torch.Tensor:
        import torch.distributed as dist
        dev = "cpu" if self.route == "host" else device
        buf = torch.empty(tuple(shape), dtype=dtype, device=dev)
        dist.irecv(buf, self.peer(pos),
                   group=self._groups[(pos, self.index)], tag=tag).wait()
        return buf.to(device) if self.route == "host" else buf

    def flush(self) -> None:
        for work, _ in self._pending:
            work.wait()
        self._pending = []


class SyncStats:
    """The train step's gradient-sync and ZeRO collectives in this
    process: calls issued and the bytes each rank put on the wire (its
    send buffer: a reduction's input, a gather's block)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0

    def add(self, t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()


SYNC_STATS = SyncStats()

_GROUPS: Dict[tuple, object] = {}


def mesh_group(mesh, dims: Sequence[int]):
    """``(group, size, index)`` of the c10d process group spanning the
    mesh dims ``dims`` of ``mesh`` (a ``torch.distributed`` DeviceMesh)
    through this rank: the group's size and this rank's index in it, the
    mixed-radix coordinate over ``dims`` in mesh order (major first), as
    the JAX package's tuple-axis collectives enumerate a group. One mesh
    dim is the mesh's own group; every dim of a mesh laid out in rank
    order is the default group (``None``); other sets are built once
    with ``new_subgroups_by_enumeration``, which every rank must reach
    in the same order (the train step's fixed sequence of collectives
    does)."""
    import torch.distributed as dist
    dims = tuple(sorted(int(d) for d in dims))
    coord = mesh.get_coordinate()
    size, index = 1, 0
    for d in dims:
        size *= mesh.size(d)
        index = index * mesh.size(d) + coord[d]
    if len(dims) == 1:
        return mesh.get_group(dims[0]), size, index
    layout = mesh.mesh
    if dims == tuple(range(mesh.ndim)) and torch.equal(
            layout.flatten(), torch.arange(layout.numel())):
        return None, size, index
    key = (tuple(layout.flatten().tolist()), tuple(layout.shape), dims)
    if key not in _GROUPS:
        rest = [d for d in range(mesh.ndim) if d not in dims]
        rows = layout.permute(*rest, *dims).reshape(-1, size).tolist()
        _GROUPS[key] = dist.new_subgroups_by_enumeration(rows)[0]
    return _GROUPS[key], size, index


def maybe_initialize(config=None, device_type: str = "cuda") -> bool:
    """Join the world if one is configured; True when running with more
    than one rank after the call. Idempotent: ``FFModel.compile`` calls
    it every time. Resolution order: the config's flags, then the
    ``FF_*`` environment variables."""
    import torch.distributed as dist
    if is_initialized():
        return dist.get_world_size() > 1
    addr = os.environ.get("FF_COORDINATOR_ADDRESS", "")
    nproc = int(os.environ.get("FF_NUM_PROCESSES", "0"))
    pid = int(os.environ.get("FF_PROCESS_ID", "-1"))
    if config is not None:
        addr = getattr(config, "coordinator_address", "") or addr
        if getattr(config, "process_id", -1) >= 0:
            pid = config.process_id
        if getattr(config, "num_nodes", 1) > 1 and nproc == 0:
            nproc = config.num_nodes
    if not addr:
        return False
    if nproc < 1 or not 0 <= pid < nproc:
        raise ValueError(
            f"a world needs FF_NUM_PROCESSES >= 1 and 0 <= FF_PROCESS_ID < "
            f"it (got {nproc} and {pid}) beside the coordinator address")
    backend = backend_for(device_type, nproc)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda", pid))
    init = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=init, world_size=nproc,
                            rank=pid, timeout=timedelta(seconds=timeout_s()))
    global _ADDRESS
    _ADDRESS = init.split("://", 1)[1]
    ROUTES.clear()
    ROUTES.update({c: backend for c in (
        "all_reduce", "broadcast", "all_gather", "reduce_scatter",
        "all_to_all")})
    if device_type == "cuda" and ranks_share_a_card(nproc):
        use_c10d_gather(device_type)
    log.info("distributed: rank %d of %d, backend %s, routes %s", pid,
             nproc, backend, ROUTES)
    return nproc > 1


def coordinator_address() -> str:
    """``host:port`` of the store this process's world met at (rank 0
    serves it); empty outside a world."""
    return _ADDRESS if is_initialized() else ""


# ----------------------------------------------------------------------
# placement of host arrays
# ----------------------------------------------------------------------

def shard_bounds(global_shape: Sequence[int], mesh, placements
                 ) -> Tuple[Tuple[int, int], ...]:
    """[lo, hi) of every dim that this rank holds under ``placements`` on
    ``mesh`` (a ``torch.distributed`` DeviceMesh). Mesh dims that shard
    one tensor dim split it in mesh order, the earlier one major (the
    order of a GSPMD spec's axis tuple). Dims must divide evenly."""
    from torch.distributed.tensor import Shard
    bounds = [[0, int(n)] for n in global_shape]
    coord = mesh.get_coordinate()
    for m, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        d = p.dim % len(bounds)
        n = mesh.size(m)
        lo, hi = bounds[d]
        if (hi - lo) % n:
            raise ValueError(f"dim {d} of {tuple(global_shape)} does not "
                             f"split evenly {n} ways")
        step = (hi - lo) // n
        bounds[d] = [lo + coord[m] * step, lo + (coord[m] + 1) * step]
    return tuple((lo, hi) for lo, hi in bounds)


def block_owner(mesh, placements) -> int:
    """The lowest rank that holds the same block as this rank under
    ``placements``: the ranks that differ from it only along mesh dims
    the value is not sharded over hold the same block."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    at = tuple(coord[m] if isinstance(p, Shard) else slice(None)
               for m, p in enumerate(placements))
    return int(mesh.mesh[at].min())


def local_row_range(mesh, placements, global_shape) -> Tuple[int, int]:
    """[lo, hi) rows of the leading dim owned by this rank: which rows of
    a host-resident global batch this rank must materialize (a
    replicated layout returns the full range)."""
    return shard_bounds(global_shape, mesh, placements)[0]


def local_slice(value, global_shape, mesh, placements):
    """This rank's block of a global array (numpy or torch)."""
    idx = tuple(slice(lo, hi)
                for lo, hi in shard_bounds(global_shape, mesh, placements))
    return value[idx]


def put_global(value, mesh, placements, device=None, dtype=None,
               global_shape: Optional[Sequence[int]] = None):
    """A DTensor of ``placements`` over ``mesh`` from a host value. The
    value is either the whole global array, of which each rank keeps its
    block, or (``global_shape`` given and differing in its rows) this
    rank's own rows, as a loader that read only ``local_row_range``
    hands them."""
    from .local_ops import from_local
    shape = tuple(value.shape) if global_shape is None \
        else tuple(global_shape)
    bounds = shard_bounds(shape, mesh, placements)
    idx = []
    for d, (lo, hi) in enumerate(bounds):
        if value.shape[d] == shape[d]:
            idx.append(slice(lo, hi))      # the whole dim: keep the block
        elif value.shape[d] == hi - lo:
            idx.append(slice(None))        # this rank's part already
        else:
            raise ValueError(
                f"rank {process_index()} holds {tuple(value.shape)}, its "
                f"block of {shape} is {tuple(h - l for l, h in bounds)}")
    value = value[tuple(idx)]
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    value = value.to(device=device, dtype=dtype)
    if value.untyped_storage().nbytes() > value.numel() * \
            value.element_size():
        # a block of a larger tensor already in place: a copy of its own,
        # or the block would keep the whole array alive on this rank
        value = value.clone(memory_format=torch.contiguous_format)
    return from_local(value, mesh, placements, shape)
