"""A world of port ranks on the CPU for the tests: one launcher, and the
scenarios the ranks run.

``run_world(name, world, payload)`` starts ``world`` processes, each
``python tests/_torch_world.py <name> <dir>``, joined through the port's
own rendezvous (``FF_COORDINATOR_ADDRESS`` on a port bound to 0 and passed
on, ``FF_NUM_PROCESSES``, ``FF_PROCESS_ID``; gloo), runs the scenario
``name`` on ``payload`` in each, and returns each rank's result, in rank
order. Every rank and the launch have a time limit, so a rank that dies or
hangs fails the test rather than leaving it waiting. The ranks import the
port only; the tests compute the JAX package's references in their own
process and pass data both ways as numpy arrays.
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS: Dict[str, Callable] = {}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(name: str, world: int, payload: Any = None,
              timeout: float = 90.0) -> List[Any]:
    """Each rank's result of scenario ``name`` in a gloo world of
    ``world`` CPU ranks. A launch whose rendezvous port another process
    took between its probe and rank 0's bind (parallel test workers) is
    launched once more on a new port."""
    try:
        return _launch(name, world, payload, timeout)
    except _PortTaken:
        return _launch(name, world, payload, timeout)


class _PortTaken(AssertionError):
    pass


def _launch(name: str, world: int, payload: Any, timeout: float):
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        port = free_port()
        procs = []
        for r in range(world):
            rank_env = dict(os.environ)
            rank_env.update(FF_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                            FF_NUM_PROCESSES=str(world),
                            FF_PROCESS_ID=str(r),
                            FF_DIST_TIMEOUT_S=str(int(timeout)),
                            FF_CACHE_DIR=os.path.join(tmp, "cache"),
                            OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                            PYTHONPATH=ROOT + os.pathsep
                            + os.environ.get("PYTHONPATH", ""))
            log = open(os.path.join(tmp, f"rank{r}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), name, tmp],
                env=rank_env, stdout=log, stderr=subprocess.STDOUT,
                cwd=tmp))
        end = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(end - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            tails = []
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    tails.append(f"--- rank {r} (exit {codes[r]}) ---\n"
                                 + f.read()[-3000:])
            err = _PortTaken if "EADDRINUSE" in tails[0] else AssertionError
            raise err(f"world {name!r} of {world} ranks failed (exit codes "
                      f"{codes}):\n" + "\n".join(tails))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def scenario(fn: Callable) -> Callable:
    SCENARIOS[fn.__name__] = fn
    return fn


def _main(name: str, tmp: str) -> None:
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    import torch
    torch.manual_seed(0)
    from flexflow_tpu_torch.parallel.distributed import (maybe_initialize,
                                                         process_index)
    maybe_initialize(device_type="cpu")
    result = SCENARIOS[name](payload)
    with open(os.path.join(tmp, f"result{process_index()}.pkl"),
              "wb") as f:
        pickle.dump(result, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


# ----------------------------------------------------------------------
# helpers of the scenarios (rank side)
# ----------------------------------------------------------------------

def _np(x):
    """A port value as a host array: a DTensor whole (a collective)."""
    import torch
    from flexflow_tpu_torch.parallel.local_ops import is_dtensor
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        x = x.redistribute(x.device_mesh,
                           [Replicate()] * x.device_mesh.ndim).to_local()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return x


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else _np(v)
            for k, v in tree.items()}


def _world_mesh(shape):
    from flexflow_tpu_torch.parallel.machine import DeviceMesh, MachineSpec
    import torch
    n = 1
    for s in shape:
        n *= s
    spec = MachineSpec(num_devices=n, generation="cpu-sim")
    return DeviceMesh(spec, devices=[torch.device("cpu")] * n,
                      mesh_shape=tuple(shape))


def _bert_model(argv, batch, seq, dropout, impl, opt):
    from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                    SGDOptimizer)
    from flexflow_tpu_torch.models import BertConfig, build_bert
    cfg = FFConfig.parse_args(list(argv))
    cfg.batch_size, cfg.device, cfg.seed = batch, "cpu", 0
    cfg.use_bf16_compute = False
    cfg.kernel_impls = f"attention:{impl}"
    ff = FFModel(cfg)
    b = BertConfig.tiny()
    b.max_position, b.dropout = seq, dropout
    out = build_bert(ff, batch, seq, b)
    optimizer = SGDOptimizer(lr=0.05) if opt == "sgd" else AdamOptimizer(
        alpha=1e-3, epsilon=1e-4)
    ff.compile(optimizer, "sparse_categorical_crossentropy", ["accuracy"],
               output_tensor=out)
    return ff


def _train_run(ff, params, layers, batches, steps, fused=False):
    """Forward, first-step gradients and a loss history of a compiled
    model from the reference's weights."""
    from flexflow_tpu_torch.interop import load_reference_params
    load_reference_params(ff, params, layers)
    if fused:
        ff.executor._kernel_impls["opt_update"] = "fused"
    ex = ff.executor
    b0 = batches[0]
    res = {"forward": _np(ex.make_forward()(ff.params, ff.state, {
        k: v for k, v in b0.items() if k != "label"}))}
    grads, _, _ = ex._grads(ff.params, ff.state, b0, 0)
    res["grads"] = _tree_np(grads)
    step = ex.make_train_step()
    res["losses"] = [float(_np(ff._run_train_step(step, batches[i % len(
        batches)])["loss"])) for i in range(steps)]
    res["names"] = [l.name for l in ex.program.layers]
    return res


@scenario
def bert(payload):
    """BERT-tiny under each (name, argv) of the payload: forward, first-
    step gradients and a loss history from the reference weights, plus
    the mesh, the local head count of the first attention's wq and the
    flash wrapper's plain calls."""
    from flexflow_tpu_torch.kernels.flash_attention import flash_attention
    out = {}
    for name, argv, dropout, impl in payload["runs"]:
        ff = _bert_model(argv, payload["batch"], payload["seq"], dropout,
                         impl, payload["opt"])
        calls = flash_attention.plain_calls
        r = _train_run(ff, payload["params"], payload["layers"],
                       payload["batches"], payload["steps"],
                       payload.get("fused", False))
        r["flash_calls"] = flash_attention.plain_calls - calls
        r["mesh"] = dict(ff.dmesh.axis_sizes)
        mha = next(l for l in ff.executor.program.layers
                   if l.op_type.name == "OP_MULTIHEAD_ATTENTION")
        r["wq_local"] = tuple(ff.params[mha.name]["wq"].to_local().shape)
        # the weights API returns global arrays; a world's checkpoint
        # waits for the multi-host format
        r["wq_global"] = ff.get_weights(mha.name, "wq").shape
        try:
            import tempfile
            ff.save_checkpoint(tempfile.mkdtemp())
            r["save"] = "saved"
        except NotImplementedError as e:
            r["save"] = str(e)
        out[name] = r
    return out


def _strategy(ff, dmesh, kind):
    """A preset over the model's mesh: "tp" / "sp" (tp over the last
    axis, dp over the others), "ep" (ep over the last axis, dp over the
    others), or None (data parallel)."""
    from flexflow_tpu_torch.parallel.presets import (
        expert_parallel_strategy, transformer_strategy)
    axes = dmesh.axis_names
    dp, last = tuple(axes[:-1]), (axes[-1],)
    if kind in ("tp", "sp"):
        return transformer_strategy(ff.layers, ff.input_tensors, dmesh,
                                    dp_axes=dp, tp_axes=last,
                                    sp=kind == "sp")
    if kind == "ep":
        return expert_parallel_strategy(ff.layers, ff.input_tensors, dmesh,
                                        dp_axes=dp, ep_axes=last)
    return None


def _compile_preset(build, kind, mesh_shape, loss, opt_lr=0.01):
    """Build a model on the CPU and compile it over the world under the
    preset ``kind`` on a mesh of ``mesh_shape``."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.parallel.machine import DeviceMesh, MachineSpec
    cfg = FFConfig()
    cfg.device, cfg.use_bf16_compute, cfg.mesh_shape = "cpu", False, \
        tuple(mesh_shape)
    ff = FFModel(cfg)
    out = build(ff)
    dmesh = DeviceMesh(MachineSpec.detect("cpu"),
                       devices=[ff.device] * MachineSpec.detect(
                           "cpu").num_devices, mesh_shape=mesh_shape)
    st = _strategy(ff, dmesh, kind)
    if st is None:
        cfg.only_data_parallel = True
    ff.compile(SGDOptimizer(opt_lr), loss, [], strategy=st,
               output_tensor=out)
    return ff


@scenario
def presets(payload):
    """The Transformer (hidden 32, 4 heads, 2 layers, seq 16, batch 8)
    under dp, tp and sp and the tiny MoE under ep, each from the
    reference's weights: forward, first-step gradients and an SGD loss
    history; the Transformer's local wq shape under tp."""
    from flexflow_tpu_torch.models import (MoeConfig, TransformerConfig,
                                           build_moe_mnist,
                                           build_transformer)
    out = {}
    tf = payload["transformer"]
    tcfg = TransformerConfig(hidden_size=32, num_heads=4, num_layers=2,
                             sequence_length=16)
    for kind in ("dp", "tp", "sp"):
        ff = _compile_preset(lambda f: build_transformer(f, 8, tcfg), kind,
                             payload["mesh"], "mean_squared_error")
        r = _train_run(ff, tf["params"], tf["layers"], tf["batches"],
                       payload["steps"])
        mha = next(l for l in ff.executor.program.layers
                   if l.op_type.name == "OP_MULTIHEAD_ATTENTION")
        r["wq_local"] = tuple(ff.params[mha.name]["wq"].to_local().shape)
        r["wq_placements"] = str(ff.params[mha.name]["wq"].placements)
        out[kind] = r
    moe = payload["moe"]
    ff = _compile_preset(lambda f: build_moe_mnist(f, 16, MoeConfig.tiny()),
                         "ep", payload["mesh"],
                         "sparse_categorical_crossentropy")
    out["ep"] = _train_run(ff, moe["params"], moe["layers"],
                           moe["batches"], payload["steps"])
    return out


@scenario
def searched(payload):
    """An MLP compiled with a search budget over the world (the search
    adopts its strategy and may insert parallel ops), the reference's
    weights set leaf by leaf on the weighted layers in order, then a
    forward, first-step gradients and an SGD loss history."""
    from flexflow_tpu_torch import (ActiMode, FFConfig, FFModel,
                                    SGDOptimizer)
    cfg = FFConfig()
    cfg.device, cfg.use_bf16_compute = "cpu", False
    cfg.batch_size = payload["batch"]
    ff = FFModel(cfg)
    x = ff.create_tensor((payload["batch"], 16), name="x")
    h = ff.dense(x, 32, activation=ActiMode.AC_MODE_RELU)
    h = ff.dense(h, 32, activation=ActiMode.AC_MODE_RELU)
    ff.softmax(ff.dense(h, 4))
    ff.compile(SGDOptimizer(0.05), "sparse_categorical_crossentropy", [],
               search_budget=payload["budget"])
    weighted = [l for l in ff.executor.program.layers
                if l.name in ff.params]
    for l, ref in zip(weighted, payload["weights"]):
        for wn, arr in ref.items():
            ff.set_weights(l.name, wn, arr)
    ex = ff.executor
    b0 = payload["batches"][0]
    res = {"forward": _np(ex.make_forward()(ff.params, ff.state,
                                            {"x": b0["x"]}))}
    grads, _, _ = ex._grads(ff.params, ff.state, b0, 0)
    res["grads"] = [_tree_np(grads[l.name]) for l in weighted]
    step = ex.make_train_step()
    res["losses"] = [float(_np(ff._run_train_step(step, b)["loss"]))
                     for b in payload["batches"]]
    res["mesh"] = dict(ff.dmesh.axis_sizes)
    res["live"] = ff.dmesh.live
    res["parallel_ops"] = sorted(
        l.op_type.name for l in ex.program.layers
        if l.op_type.name in ("OP_REPARTITION", "OP_COMBINE",
                              "OP_REPLICATE", "OP_REDUCTION",
                              "OP_ALLTOALL", "OP_FUSED_PARALLEL"))
    res["sharded_outputs"] = sum(
        1 for os_ in ff.strategy.ops.values()
        for spec in os_.outputs if spec and any(spec))
    return res


@scenario
def placement(payload):
    """Rendezvous, placement, planned transitions, the parallel ops and
    the products on blocks, on a mesh of ``payload["mesh"]`` over the
    world; every value returned whole or as this rank's block, for the
    test to hold against numpy."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Partial, Replicate, Shard
    from flexflow_tpu_torch.ffconst import OperatorType
    from flexflow_tpu_torch.ops import EmitCtx, get_op_def
    from flexflow_tpu_torch.ops.registry import mm_f32
    from flexflow_tpu_torch.parallel import distributed as D
    from flexflow_tpu_torch.parallel.local_ops import from_local
    from flexflow_tpu_torch.parallel.reshard import (STATS, ReshardPlanner,
                                                     place_host)
    from flexflow_tpu_torch.parallel.strategy import (ShardingStrategy,
                                                      spec_placements)
    gathers = []
    if payload.get("c10d_gather"):
        # the all-gather route of ranks that share a card, on the CPU,
        # counting the functional all-gathers that reach it
        def counted(*a, _gather=D.gather_by_c10d):
            gathers.append(a[0].shape)
            return _gather(*a)
        D.gather_by_c10d = counted
        D.use_c10d_gather("cpu")
    dmesh = _world_mesh(payload["mesh"])
    mesh = dmesh.mesh
    out = {"live": dmesh.live, "coord": list(mesh.get_coordinate()),
           "rank": D.process_index(), "world": D.process_count(),
           "routes": dict(D.ROUTES), "rows": {}, "put": {}, "place": {},
           "reshard": {}, "ops": {}, "mm": {}}
    A = payload["A"]
    for name, spec in payload["specs"].items():
        pl = spec_placements(spec, dmesh, A.ndim)
        out["rows"][name] = D.local_row_range(mesh, pl, A.shape)
        whole = D.put_global(A, mesh, pl)
        lo, hi = out["rows"][name]
        mine = D.put_global(A[lo:hi], mesh, pl, global_shape=A.shape)
        out["put"][name] = (whole.to_local().numpy(),
                            mine.to_local().numpy())
        before = STATS.host_placements
        out["place"][name] = (place_host(A, dmesh, spec).to_local().numpy(),
                              STATS.host_placements - before)
    planner = ReshardPlanner(dmesh, cache_dir=payload["cache"])
    W = torch.from_numpy(payload["W"])
    for i, (src, dst) in enumerate(payload["pairs"]):
        x = place_host(A, dmesh, src).detach().requires_grad_(True)
        y = planner.apply(x, dst)
        plan = planner.plan(src, dst, A.shape, 4)
        (y * from_local(W, mesh, [Replicate()] * mesh.ndim, W.shape)
         ).sum().backward()
        out["reshard"][i] = {"block": y.to_local().detach().numpy(),
                             "placements": str(y.placements),
                             "steps": plan.describe(),
                             "grad": _np(x.grad)}
    st = ShardingStrategy(dmesh)
    ctx = EmitCtx(training=False)
    ctx.strategy = st
    for i, (op, src, dst) in enumerate(payload["ops"]):
        name = f"op{i}"
        st.set_op(name, [dst])
        if op == "OP_REDUCTION":
            # each rank holds A * (rank + 1) / sum(ranks + 1): a Partial
            n = D.process_count()
            part = torch.from_numpy(A) * (D.process_index() + 1) \
                / (n * (n + 1) / 2)
            x = from_local(part, mesh, [Partial()] * mesh.ndim, A.shape)
        else:
            x = place_host(A, dmesh, src)
        y = get_op_def(OperatorType[op]).emit({}, [x], {}, ctx, name)[0]
        out["ops"][i] = {"block": y.to_local().numpy(), "whole": _np(y),
                         "placements": str(y.placements)}
    for i, (ma, mb, mg, pa, pb) in enumerate(payload["mm"]):
        a_, b_, g_ = (torch.from_numpy(t) for t in (ma, mb, mg))

        def dt(t, p):
            pl = [Partial() if q == "P" else Replicate() if q == "R"
                  else Shard(int(q)) for q in p]
            if any(q == "P" for q in p):
                # each rank's block times (rank + 1) / sum(ranks + 1): the
                # parts sum to the block over the Partial mesh dims
                n = D.process_count()
                blk = D.local_slice(t, t.shape, mesh, pl) \
                    * (D.process_index() + 1) / (n * (n + 1) / 2)
                if len(p) > 1:
                    # a Partial dim of 2 ranks beside a sharded one: the
                    # parts sum over the Partial dim's group only
                    pm = [m for m, q in enumerate(p) if q == "P"][0]
                    c = mesh.get_coordinate()[pm]
                    blk = D.local_slice(t, t.shape, mesh, pl) * (c + 1) / 3
                return from_local(blk, mesh, pl, t.shape)
            return D.put_global(t, mesh, pl)
        xa = dt(a_, pa).detach().requires_grad_(True)
        xb = dt(b_, pb).detach().requires_grad_(True)
        y = mm_f32(xa, xb)
        (y * from_local(g_, mesh, [Replicate()] * mesh.ndim, g_.shape)
         ).sum().backward()
        grads = []
        for x in (xa, xb):
            g = x.grad
            if any(isinstance(p, Partial) for p in g.placements):
                g = g.redistribute(mesh, [Replicate() if isinstance(
                    p, Partial) else p for p in g.placements])
            grads.append(_np(g))
        out["mm"][i] = {"whole": _np(y), "placements": str(y.placements),
                        "grads": grads}
    # FF_NAIVE_RESHARD=1: DTensor's redistribute, counted as naive
    import os
    from flexflow_tpu_torch.obs.metrics_registry import REGISTRY
    before = STATS.executed_naive
    os.environ["FF_NAIVE_RESHARD"] = "1"
    y = planner.apply(place_host(A, dmesh, payload["pairs"][0][0]),
                      payload["pairs"][0][1])
    del os.environ["FF_NAIVE_RESHARD"]
    out["naive"] = {"block": y.to_local().numpy(),
                    "counted": STATS.executed_naive - before,
                    "metrics": [ln for ln in REGISTRY.render().splitlines()
                                if ln.startswith("ff_reshard")]}
    # the collective rows, keyed by the world's transport; a second pass
    # reads them back without measuring
    from flexflow_tpu_torch.search.calibration import (CalibrationTable,
                                                       calibrate_mesh)
    tab = CalibrationTable(payload["cache"] + f"/calib{D.process_index()}")
    calib = calibrate_mesh(dmesh, table=tab, sizes=(1 << 12, 1 << 14))
    first = tab.measured
    calibrate_mesh(dmesh, table=tab, sizes=(1 << 12, 1 << 14))
    out["calib"] = {"backend": calib.coll_backend, "measured": first,
                    "again": tab.measured - first,
                    "keys": sorted(k for k in tab._load() if "coll_" in k),
                    "all_reduce_4k": calib.collective_time(
                        "all_reduce", D.process_count(), 1 << 12)}
    out["functional_gathers"] = len(gathers)
    return out


@scenario
def suite(payload):
    """Every parallel configuration of the tests in one world: the
    ``bert``, ``presets`` and ``searched`` scenarios on their payloads."""
    return {"bert": bert(payload["bert"]),
            "presets": presets(payload["presets"]),
            "searched": searched(payload["searched"])}


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _main(sys.argv[1], sys.argv[2])
