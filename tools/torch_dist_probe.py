"""Which collectives a gloo world runs on CUDA tensors, on one card.

Starts two rank processes on ``cuda:0`` joined by a gloo process group
(``tcp://localhost:<free port>``) and tries, on CUDA tensors,
``all_reduce``, ``broadcast``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single`` and DTensor's
``redistribute`` for Shard -> Replicate, Partial -> Replicate and
Partial -> Shard, each checked against the values it must give;
``--routes`` adds other routes of the same collectives and the
point-to-point transfers (``send`` / ``recv``, ``isend`` / ``irecv``
over one group and with a group for each direction,
``batch_isend_irecv``, and a CUDA tensor staged through host memory).
Then it starts a one-rank NCCL world and runs an ``all_reduce`` there,
and, where there are two cards, a two-rank NCCL world with a card each
for the point-to-point transfers. Prints one line per probe and, last,
one JSON object with the card's name and power limit.

Run on the card: ``python3 tools/torch_dist_probe.py`` (about 30 s).
``--device cpu`` runs the same probes on CPU tensors.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist

PROBES = ("barrier", "all_reduce", "broadcast", "all_gather_into_tensor",
          "reduce_scatter_tensor", "all_to_all_single",
          "redistribute_shard_to_replicate",
          "redistribute_partial_to_replicate",
          "redistribute_partial_to_shard")
# point-to-point (the pipeline's hand-off between stages): rank 0 sends
# to rank 1 and rank 1 back to rank 0, each checked on the receiver;
# "isend_irecv_groups" sends each direction over a process group of its
# own, as the pipeline's ``Handoff`` does
P2P = ("send_recv", "isend_irecv", "isend_irecv_groups",
       "batch_isend_irecv", "send_recv_host")
# the same collectives by other routes: 2-D tensors, the functional
# collectives DTensor issues, the list all_gather
ROUTES = ("all_gather_into_tensor_2d", "all_gather_list",
          "funcol_all_gather_1d", "funcol_all_gather_2d",
          "funcol_all_to_all_single", "funcol_reduce_scatter",
          "redistribute_shard_to_replicate_1d",
          "redistribute_shard1_to_replicate",
          "redistribute_shard0_to_shard1",
          # the quantized gradient sync's wire payloads (int8, and fp8
          # as its bytes) and the overlap schedule's asynchronous calls
          "all_to_all_single_int8", "all_to_all_single_uint8",
          "all_gather_into_tensor_int8", "all_reduce_async",
          "reduce_scatter_tensor_async")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _probe(name: str, rank: int, world: int, dev: torch.device) -> None:
    """Run one collective; raise if it fails or gives a wrong value."""
    n = 4 * world
    base = torch.arange(n, dtype=torch.float32, device=dev)
    if name == "barrier":
        dist.barrier()
        return
    if name in P2P:
        peer = 1 - rank
        src = base + 10 * (rank + 1)
        x = torch.empty_like(src)
        if name == "send_recv_host":
            # staged in host memory: the tensor travels as a CPU copy
            h = torch.empty(n, dtype=src.dtype)
            if rank == 0:
                dist.send(src.cpu(), peer)
                dist.recv(h, peer)
            else:
                dist.recv(h, peer)
                dist.send(src.cpu(), peer)
            x = h.to(dev)
        elif name == "send_recv":
            if rank == 0:
                dist.send(src, peer)
                dist.recv(x, peer)
            else:
                dist.recv(x, peer)
                dist.send(src, peer)
        elif name == "isend_irecv":
            works = [dist.isend(src, peer), dist.irecv(x, peer)]
            for w in works:
                w.wait()
        elif name == "isend_irecv_groups":
            # (building a group is collective: both ranks build both,
            # then make their point-to-point communicators by one
            # transfer a group in one order, as ``Handoff`` does: NCCL
            # makes one at a group's first send or receive, which both
            # ranks must reach)
            groups = {(0, 1): dist.new_group([0, 1]),
                      (1, 0): dist.new_group([0, 1])}
            for (a, b), g in groups.items():
                z = torch.zeros(1, device=dev)
                if a == rank:
                    dist.send(z, b, group=g)
                else:
                    dist.recv(z, a, group=g)
            works = [dist.isend(src, peer, group=groups[(rank, peer)]),
                     dist.irecv(x, peer, group=groups[(peer, rank)])]
            for w in works:
                w.wait()
        else:
            ops = [dist.P2POp(dist.isend, src, peer),
                   dist.P2POp(dist.irecv, x, peer)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        want = base + 10 * (peer + 1)
        torch.cuda.synchronize() if dev.type == "cuda" else None
        if x.device != want.device or not torch.equal(x, want):
            raise AssertionError(f"wrong values: {x.tolist()} != "
                                 f"{want.tolist()}")
        return
    if name == "all_reduce":
        x = base + rank
        dist.all_reduce(x)
        want = world * base + sum(range(world))
    elif name == "broadcast":
        x = base + rank
        dist.broadcast(x, src=0)
        want = base
    elif name == "all_gather_into_tensor":
        x = torch.empty(n * world, device=dev)
        dist.all_gather_into_tensor(x, base + rank)
        want = torch.cat([base + r for r in range(world)])
    elif name == "reduce_scatter_tensor":
        x = torch.empty(n // world, device=dev)
        dist.reduce_scatter_tensor(x, base + rank)
        full = world * base + sum(range(world))
        want = full.chunk(world)[rank]
    elif name == "all_gather_into_tensor_2d":
        x = torch.empty(world, n, device=dev)
        dist.all_gather_into_tensor(x, (base + rank)[None])
        want = torch.stack([base + r for r in range(world)])
    elif name == "all_gather_list":
        parts = [torch.empty(n, device=dev) for _ in range(world)]
        dist.all_gather(parts, base + rank)
        x = torch.cat(parts)
        want = torch.cat([base + r for r in range(world)])
    elif name.startswith("funcol_"):
        import torch.distributed._functional_collectives as funcol
        group = dist.group.WORLD
        if name == "funcol_all_gather_1d":
            x = funcol.all_gather_tensor(base + rank, 0, group).wait()
            want = torch.cat([base + r for r in range(world)])
        elif name == "funcol_all_gather_2d":
            x = funcol.all_gather_tensor((base + rank)[None], 0,
                                         group).wait()
            want = torch.stack([base + r for r in range(world)])
        elif name == "funcol_all_to_all_single":
            x = funcol.all_to_all_single(base + 100 * rank, None, None,
                                         group).wait()
            want = torch.cat([(base + 100 * r).chunk(world)[rank]
                              for r in range(world)])
        else:
            x = funcol.reduce_scatter_tensor(base + rank, "sum", 0,
                                             group).wait()
            want = (world * base + sum(range(world))).chunk(world)[rank]
    elif name == "all_to_all_single":
        x = torch.empty(n, device=dev)
        dist.all_to_all_single(x, base + 100 * rank)
        want = torch.cat([(base + 100 * r).chunk(world)[rank]
                          for r in range(world)])
    elif name in ("all_to_all_single_int8", "all_to_all_single_uint8"):
        dt = torch.uint8 if "uint8" in name else torch.int8
        src = (base + 10 * rank).to(dt)
        x = torch.empty_like(src)
        dist.all_to_all_single(x, src)
        want = torch.cat([(base + 10 * r).to(dt).chunk(world)[rank]
                          for r in range(world)])
    elif name == "all_gather_into_tensor_int8":
        x = torch.empty(n * world, device=dev, dtype=torch.int8)
        dist.all_gather_into_tensor(x, (base + rank).to(torch.int8))
        want = torch.cat([(base + r).to(torch.int8) for r in range(world)])
    elif name == "all_reduce_async":
        x = base + rank
        dist.all_reduce(x, async_op=True).wait()
        want = world * base + sum(range(world))
    elif name == "reduce_scatter_tensor_async":
        x = torch.empty(n // world, device=dev)
        dist.reduce_scatter_tensor(x, base + rank, async_op=True).wait()
        want = (world * base + sum(range(world))).chunk(world)[rank]
    else:
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard, init_device_mesh)
        mesh = init_device_mesh(dev.type, (world,))
        if name == "redistribute_shard_to_replicate_1d":
            d = DTensor.from_local(base.chunk(world)[rank].contiguous(),
                                   mesh, [Shard(0)])
            x = d.redistribute(mesh, [Replicate()]).to_local()
            want = base
        elif name == "redistribute_shard1_to_replicate":
            full = base.view(4, world)
            d = DTensor.from_local(full[:, rank:rank + 1].contiguous(), mesh,
                                   [Shard(1)])
            x = d.redistribute(mesh, [Replicate()]).to_local()
            want = full
        elif name == "redistribute_shard0_to_shard1":
            full = base.view(world, 4)
            d = DTensor.from_local(full[rank:rank + 1].contiguous(), mesh,
                                   [Shard(0)])
            x = d.redistribute(mesh, [Shard(1)]).to_local()
            want = full.chunk(world, dim=1)[rank]
        elif name == "redistribute_shard_to_replicate":
            d = DTensor.from_local((base + rank).view(world, 4)[rank:rank + 1]
                                   .contiguous(), mesh, [Shard(0)])
            x = d.redistribute(mesh, [Replicate()]).to_local()
            want = torch.stack([(base + r).view(world, 4)[r]
                                for r in range(world)])
        else:
            d = DTensor.from_local((base + rank).view(world, 4), mesh,
                                   [Partial()])
            full = (world * base + sum(range(world))).view(world, 4)
            if name == "redistribute_partial_to_replicate":
                x = d.redistribute(mesh, [Replicate()]).to_local()
                want = full
            else:
                x = d.redistribute(mesh, [Shard(0)]).to_local()
                want = full[rank:rank + 1]
    torch.cuda.synchronize() if dev.type == "cuda" else None
    if x.device != want.device or not torch.equal(x, want):
        raise AssertionError(f"wrong values: {x.tolist()} != "
                             f"{want.tolist()}")


def rank_main(rank: int, world: int, port: int, backend: str, device: str,
              probe: str, out: str) -> None:
    # a card each under NCCL; every gloo rank on the first card
    idx = rank if backend == "nccl" else 0
    dev = torch.device(f"{device}:{idx}" if device == "cuda" else "cpu")
    if device == "cuda":
        torch.cuda.set_device(idx)
    from datetime import timedelta
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        _probe(probe, rank, world, dev)
        res = "ok"
    except Exception as e:  # the probe's failure is its answer
        res = f"{type(e).__name__}: " + str(e).strip().splitlines()[0][:200]
        if os.environ.get("FF_PROBE_TRACE"):
            traceback.print_exc()
    with open(out, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def run_world(world: int, backend: str, device: str, probe: str,
              timeout: float) -> str:
    """One probe in a world of its own (a probe that kills its ranks
    leaves the next one a clean start)."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs, outs = [], []
        for r in range(world):
            outs.append(os.path.join(tmp, f"rank{r}.json"))
            procs.append(subprocess.Popen(
                [sys.executable, "-X", "faulthandler",
                 os.path.abspath(__file__), "--rank", str(r),
                 "--world", str(world), "--port", str(port), "--backend",
                 backend, "--device", device, "--probe", probe, "--out",
                 outs[-1]]))
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=timeout))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.wait()
                return f"timed out after {timeout:.0f} s"
        per_rank = []
        for o, code in zip(outs, codes):
            if os.path.exists(o):
                with open(o) as f:
                    per_rank.append(json.load(f))
            else:
                per_rank.append(f"rank died (exit code {code})")
    # a probe passes when it passed on every rank
    return next((r for r in per_rank if r != "ok"), "ok")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=-1)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--probe", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--routes", action="store_true",
                    help="also probe the other routes (ROUTES) and the "
                    "point-to-point transfers (P2P)")
    ap.add_argument("--only", default="",
                    help="comma-separated probes to run, of PROBES, "
                    "ROUTES and P2P, and no others")
    a = ap.parse_args()
    if a.rank >= 0:
        rank_main(a.rank, a.world, a.port, a.backend, a.device, a.probe,
                  a.out)
        return 0
    if a.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = ""
    if a.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    gloo = {}
    names = a.only.split(",") if a.only else \
        PROBES + (ROUTES + P2P if a.routes else ())
    for name in names:
        gloo[name] = run_world(2, "gloo", a.device, name, 60)
        print(f"[probe] gloo, 2 ranks on one {a.device} device, {name}: "
              f"{gloo[name]}", flush=True)
    nccl = {}
    if a.device == "cuda":
        nccl["all_reduce"] = run_world(1, "nccl", a.device, "all_reduce", 60)
        print(f"[probe] nccl, 1 rank: all_reduce: {nccl['all_reduce']}")
        if a.routes and torch.cuda.device_count() >= 2:
            for name in P2P[:-1]:
                if a.only and name not in names:
                    continue
                nccl["2_ranks_" + name] = run_world(2, "nccl", a.device,
                                                    name, 60)
                print(f"[probe] nccl, 2 ranks on a card each, {name}: "
                      f"{nccl['2_ranks_' + name]}", flush=True)
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "gloo_2_ranks": gloo,
                      "nccl_1_rank": nccl}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
