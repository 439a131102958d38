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


def run_world_raw(name: str, world: int, payload: Any = None,
                  timeout: float = 90.0, env: Dict[str, str] = None):
    """``(exit codes, results, logs)`` of scenario ``name`` in a world
    whose ranks may fail on purpose (the fault drills): nothing raises
    on a rank's exit code, a rank that wrote no result has None, and
    ``env`` joins every rank's environment. Every rank runs to its own
    end within ``timeout`` (a survivor's bounded detection is what the
    drills test)."""
    return _launch(name, world, payload, timeout, env=env, check=False)


class _PortTaken(AssertionError):
    pass


def _launch(name: str, world: int, payload: Any, timeout: float,
            env: Dict[str, str] = None, check: bool = True):
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        port = free_port()
        procs = []
        for r in range(world):
            rank_env = dict(os.environ)
            rank_env.update(env or {})
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
        if not check:
            logs, out = [], []
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    logs.append(f.read())
                res = os.path.join(tmp, f"result{r}.pkl")
                if os.path.exists(res):
                    with open(res, "rb") as f:
                        out.append(pickle.load(f))
                else:
                    out.append(None)
            return codes, out, logs
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


def _local_state(ff) -> dict:
    """This rank's blocks of the params and Adam's moments, copied."""
    return {f"{slot}/{ln}/{wn}": t.to_local().detach().clone()
            for slot, tree in (("params", ff.params),
                               ("m", ff.opt_state["m"]),
                               ("v", ff.opt_state["v"]))
            for ln, ws in tree.items() for wn, t in ws.items()}


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
    optimizer = SGDOptimizer(lr=0.05) if opt == "sgd" else \
        SGDOptimizer(lr=0.05, momentum=0.9) if opt == "sgdm" else \
        AdamOptimizer(alpha=1e-3, epsilon=1e-4)
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
        # the weights API returns global arrays, and so does a world's
        # checkpoint (the multi-host format, in the directory the ranks
        # share), read back whole by the quorum restore
        r["wq_global"] = ff.get_weights(mha.name, "wq").shape
        from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager
        d = os.path.join(os.getcwd(), f"ckpt_bert_{name}")
        ff.save_checkpoint(d)
        state, meta = CheckpointManager(d).restore()
        wq = state["params"][mha.name]["wq"]
        r["save"] = (meta["step"], meta["world_size"], wq.shape,
                     bool((wq == ff.get_weights(mha.name, "wq")).all()))
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


def _transformer_model(argv, opt):
    """The Transformer (hidden 32, 4 heads, 2 layers, seq 16, batch 8)
    compiled under ``argv``, MSE loss."""
    from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                    SGDOptimizer)
    from flexflow_tpu_torch.models import TransformerConfig, build_transformer
    cfg = FFConfig.parse_args(list(argv))
    cfg.batch_size, cfg.device, cfg.seed = 8, "cpu", 0
    cfg.use_bf16_compute = False
    cfg.kernel_impls = "attention:xla"
    ff = FFModel(cfg)
    out = build_transformer(ff, 8, TransformerConfig(
        hidden_size=32, num_heads=4, num_layers=2, sequence_length=16))
    ff.compile(SGDOptimizer(lr=0.05, momentum=0.9) if opt == "sgdm"
               else AdamOptimizer(alpha=1e-3, epsilon=1e-4),
               "mean_squared_error", [], output_tensor=out)
    return ff


def _sync_run(argv, payload, opt="adam", steps=4, model="bert"):
    """BERT-tiny (or the Transformer) compiled under ``argv`` over the
    world from the reference's weights, the fused Adam's plan on (its
    plain version on the CPU): the forward, first-step gradients, a loss
    history, the weights after it, the optimizer state's local shapes,
    and per step the fused Adam's calls and the sync collectives' calls
    and bytes."""
    from flexflow_tpu_torch.kernels.opt_update import fused_adam_update
    from flexflow_tpu_torch.parallel.distributed import SYNC_STATS
    if model == "bert":
        ff = _bert_model(argv, payload["batch"], payload["seq"], 0.0,
                         "xla", opt)
    else:
        ff = _transformer_model(argv, opt)
    ref = payload[model]
    calls = fused_adam_update.plain_calls
    SYNC_STATS.reset()
    r = _train_run(ff, ref["params"], ref["layers"], ref["batches"], steps,
                   fused=opt == "adam")
    r["adam_per_step"] = (fused_adam_update.plain_calls - calls) / steps
    r["sync_calls"] = SYNC_STATS.calls / steps
    r["sync_bytes"] = SYNC_STATS.bytes / steps
    r["weights"] = _tree_np(ff.params)
    from flexflow_tpu_torch.runtime.zero import state_sharding_doc
    r["sharding_doc"] = state_sharding_doc(ff.opt_state)
    r["state_local"] = {
        slot: {f"{ln}/{wn}": tuple(t.to_local().shape)
               for ln, ws in layers.items() for wn, t in ws.items()}
        for slot, layers in ff.opt_state.items()}
    ex = ff.executor
    r["overlap"] = None if ex._overlap_schedule is None \
        else ex._overlap_schedule.record()
    r["qsync"] = ex._qsync is not None
    r["plan"] = None if ff.strategy.qsync is None \
        else ff.strategy.qsync.to_json()
    from flexflow_tpu_torch.ops.quantized_collectives import RESIDUAL_SLOT
    if RESIDUAL_SLOT in ff.opt_state:
        r["residual_abs"] = float(sum(
            float(t.to_local().abs().sum())
            for ws in ff.opt_state[RESIDUAL_SLOT].values()
            for t in ws.values()))
    r["ff"] = ff
    return r


def _renamed(obj, names):
    """A strategy file's JSON with every layer name in ``names`` (old ->
    new) replaced, keys and values alike."""
    if isinstance(obj, dict):
        return {names.get(k, k): _renamed(v, names) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_renamed(v, names) for v in obj]
    return names.get(obj, obj) if isinstance(obj, str) else obj


def _import_run(src, argv, payload, block):
    """A model built under ``argv`` that imports ``src``'s strategy (its
    ``block`` set as the source has it), the layer names mapped by
    position: which leaves' moments it shards and whether its quantized
    sync runs, then one step's loss."""
    import json
    import tempfile
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models import BertConfig, build_bert
    from flexflow_tpu_torch.search.serialization import save_strategy
    cfg = FFConfig.parse_args(list(argv))
    cfg.batch_size, cfg.device, cfg.seed = payload["batch"], "cpu", 0
    cfg.use_bf16_compute, cfg.kernel_impls = False, "attention:xla"
    ff = FFModel(cfg)
    b = BertConfig.tiny()
    b.max_position, b.dropout = payload["seq"], 0.0
    out = build_bert(ff, payload["batch"], payload["seq"], b)
    names = {a.name: n.name for a, n in zip(src.layers, ff.layers)}
    path = os.path.join(tempfile.mkdtemp(), "s.json")
    save_strategy(path, src.strategy)
    with open(path) as f:
        doc = _renamed(json.load(f), names)
    with open(path, "w") as f:
        json.dump(doc, f)
    cfg.import_strategy_file = path
    ff.compile(AdamOptimizer(alpha=1e-3, epsilon=1e-4),
               "sparse_categorical_crossentropy", [], output_tensor=out)
    from flexflow_tpu_torch.interop import load_reference_params
    ref = payload["bert"]
    load_reference_params(ff, ref["params"], ref["layers"])
    inv = {v: k for k, v in names.items()}
    sharded = sorted(
        f"{inv[ln]}/{wn}" for ln, ws in ff.opt_state.get("m", {}).items()
        for wn, t in ws.items()
        if tuple(t.to_local().shape) != tuple(ff.params[ln][wn].shape))
    plan = ff.strategy.qsync
    loss = float(_np(ff._run_train_step(ff.executor.make_train_step(),
                                        ref["batches"][0])["loss"]))
    return {"sharded": sharded, "plan": plan is not None,
            "plan_layers": None if plan is None else sorted(
                inv.get(k, k) for k in plan.decisions),
            "qsync": ff.executor._qsync is not None, "loss": loss}


@scenario
def sync(payload):
    """The train step's multi-device branches (each run of
    ``payload["runs"]``: (name, argv, optimizer, model)), then
    ``payload["imports"]`` ((tag, source run, argv, block): a model that
    imports the source's strategy, with the ZeRO assignment of
    ``payload["assign"]`` attached to it), and the quantized collectives
    on ``payload["qx"]`` / ``payload["qres"]`` over each set of mesh axes
    of ``payload["groups"]`` and each phase list of
    ``payload["phases"]``."""
    import torch
    from flexflow_tpu_torch.ops import quantized_collectives as Q
    from flexflow_tpu_torch.parallel.distributed import mesh_group
    from flexflow_tpu_torch.runtime.zero import ZeroAssignment
    out = {"runs": {}, "imports": {}, "qar": {}, "phased": {}}
    from flexflow_tpu_torch.runtime import zero
    models = {}
    cap = zero.ZERO_CHUNK_BYTES
    for name, argv, opt, model in payload["runs"]:
        # a run of payload["chunk_bytes"] cuts ZeRO's collectives small
        zero.ZERO_CHUNK_BYTES = payload.get("chunk_bytes", {}).get(name,
                                                                   cap)
        r = _sync_run(argv, payload, opt, model=model)
        models[name] = r.pop("ff")
        out["runs"][name] = r
    for tag, src, argv, block in payload.get("imports", ()):
        a = models[src]
        if block == "zero":
            meta = {l.name: {w.name: tuple(w.shape) for w in l.weights}
                    for l in a.executor.program.layers if l.weights}
            z = ZeroAssignment.uniform(meta, a.strategy,
                                       dict(a.dmesh.axis_sizes))
            for ws in z.decisions.values():
                for wn, rec in ws.items():
                    if wn not in payload["assign"]:
                        rec["spec"], rec["degree"] = None, 1
            a.strategy.zero = z
        r = _import_run(a, argv, payload, block)
        if block == "zero":
            r["assigned"] = sorted(f"{ln}/{wn}"
                                   for ln, wn in a.strategy.zero
                                   .sharded_params())
        out["imports"][tag] = r
    out["refused"] = {}
    for tag, argv in payload.get("refuse", ()):
        try:
            _bert_model(argv, payload["batch"], payload["seq"], 0.0, "xla",
                        "adam")
            out["refused"][tag] = None
        except NotImplementedError as e:
            out["refused"][tag] = str(e)
    for name, ff in models.items():
        if name in payload.get("save", ()):
            # a ZeRO world's checkpoint (the directory the ranks share)
            # restores into its model: every weight and moment block
            # comes back bit for bit
            d = os.path.join(os.getcwd(), f"ckpt_{name}")
            try:
                ff.save_checkpoint(d)
                out["refused"]["save_" + name] = None
            except NotImplementedError as e:
                out["refused"]["save_" + name] = str(e)
                continue
            before = _local_state(ff)
            with torch.no_grad():
                for tree in (ff.params, ff.opt_state["m"],
                             ff.opt_state["v"]):
                    for ws in tree.values():
                        for t in ws.values():
                            t.to_local().zero_()
            step = ff.restore_checkpoint(d)
            after = _local_state(ff)
            out["restored_" + name] = (step, len(before), sum(
                not torch.equal(before[k], after[k]) for k in before))
    if payload.get("groups"):
        mesh = next(iter(models.values())).dmesh.mesh
        names = list(mesh.mesh_dim_names)
        for axes in payload["groups"]:
            group, n, idx = mesh_group(mesh, [names.index(a) for a in axes])
            row = mesh.get_rank()
            for wire in ("int8", "float8_e4m3", "float8_e5m2"):
                x = torch.from_numpy(payload["qx"][row])
                res = torch.from_numpy(payload["qres"][row])
                o, rn = Q.quantized_all_reduce(x, group, wire, n, idx,
                                               residual=res)
                out["qar"][(axes, wire)] = (o.numpy(), rn.numpy())
        for key, phases in payload["phases"]:
            x = torch.from_numpy(payload["qx"][mesh.get_rank()])
            res = torch.from_numpy(payload["qres"][mesh.get_rank()])
            o, rn = Q.phased_sync(x, phases, mesh, residual=res)
            out["phased"][key] = (o.numpy(), None if rn is None
                                  else rn.numpy())
    return out


def _gpt_model(argv, batch, dropout, layers=4):
    """GPT-2 at small widths (vocab 64, hidden 32, 4 heads, seq 16) in f32
    under ``argv``, SGD."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import GPTConfig, build_gpt2
    cfg = FFConfig.parse_args(list(argv))
    cfg.batch_size, cfg.device, cfg.seed = batch, "cpu", 0
    cfg.use_bf16_compute = False
    cfg.kernel_impls = "attention:xla"
    ff = FFModel(cfg)
    out = build_gpt2(ff, batch, 16, GPTConfig(
        vocab_size=64, hidden_size=32, num_layers=layers, num_heads=4,
        max_position=16, dropout=dropout))
    ff.compile(SGDOptimizer(0.05), "sparse_categorical_crossentropy", [],
               output_tensor=out)
    return ff


def _bert4_model(argv, batch):
    """BERT-tiny with 4 layers at seq 16 in f32 under ``argv``, SGD."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import BertConfig, build_bert
    cfg = FFConfig.parse_args(list(argv))
    cfg.batch_size, cfg.device, cfg.seed = batch, "cpu", 0
    cfg.use_bf16_compute = False
    cfg.kernel_impls = "attention:xla"
    ff = FFModel(cfg)
    b = BertConfig.tiny()
    b.max_position, b.dropout, b.num_layers = 16, 0.0, 4
    out = build_bert(ff, batch, 16, b)
    ff.compile(SGDOptimizer(0.05), "sparse_categorical_crossentropy", [],
               output_tensor=out)
    return ff


def _region(ff):
    pipe = ff.executor.pipe
    return None if pipe is None else {
        "start": pipe.start, "end": pipe.end, "stages": pipe.n_stages,
        "chunks": pipe.n_chunks, "micro": pipe.n_microbatches,
        "counts": pipe.counts, "tp_axis": pipe.tp_axis,
        "prologue": len(pipe.prologue), "epilogue": len(pipe.epilogue)}


@scenario
def pipeline(payload):
    """Pipelined models over the world (each run of ``payload["runs"]``:
    (name, model, argv, dropout, reference)) from the reference's weights
    (a JAX pipelined model's ``pp::`` leaves or a plain model's, grafted):
    the forward on the first batch, the first-step gradients (stacked
    leaves whole), a loss history, the region, the mesh, each rank's
    local leaf shapes and the hand-off's sends a step."""
    from flexflow_tpu_torch.interop import load_reference_params
    out = {}
    for name, model, argv, dropout, ref_key in payload["runs"]:
        ref = payload["refs"][ref_key]
        ff = _gpt_model(argv, payload["batch"], dropout) \
            if model == "gpt" else _bert4_model(argv, payload["batch"])
        load_reference_params(ff, ref["params"], ref["layers"])
        ex = ff.executor
        b0 = ref["batches"][0]
        r = {"forward": _np(ex.make_forward()(ff.params, ff.state, {
            k: v for k, v in b0.items() if k != "label"}))}
        r["grads"] = _tree_np(ex._grads(ff.params, ff.state, b0, 0)[0])
        hand = ex._handoff
        calls = hand.calls
        step = ex.make_train_step()
        r["losses"] = [float(_np(ff._run_train_step(
            step, ref["batches"][i % len(ref["batches"])])["loss"]))
            for i in range(payload["steps"])]
        r["sends_per_step"] = (hand.calls - calls) / payload["steps"]
        r["route"] = hand.route
        r["region"] = _region(ff)
        r["mesh"] = dict(ff.dmesh.axis_sizes)
        r["local"] = {f"{ln}/{wn}": tuple(t.to_local().shape)
                      for ln, ws in ff.params.items()
                      if ln.startswith("pp::") for wn, t in ws.items()}
        r["names"] = [l.name for l in ex.program.layers]
        out[name] = r
    return out


def _dlrm_model(vocabs, batch=32, dim=16):
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import DLRMConfig, build_dlrm
    cfg = FFConfig()
    cfg.batch_size, cfg.device, cfg.seed = batch, "cpu", 0
    cfg.only_data_parallel, cfg.use_bf16_compute = True, False
    ff = FFModel(cfg)
    out = build_dlrm(ff, batch, DLRMConfig(
        embedding_size=tuple(vocabs), sparse_feature_size=dim,
        mlp_bot=(4, 16, dim), mlp_top=(dim, 16, 2)))
    ff.compile(SGDOptimizer(0.05), "sparse_categorical_crossentropy", [],
               output_tensor=out)
    return ff, out


def _bank_pipe_model(vocabs):
    """Four tables -> concat -> a 4-block MLP region (pp 2, 4
    microbatches) -> the head, which re-reads the concat (the prologue
    stays outside the region): the JAX package's banks-with-a-pipeline
    model."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ffconst import AggrMode
    cfg = FFConfig()
    cfg.batch_size, cfg.device, cfg.seed = 32, "cpu", 0
    cfg.pipeline_stages, cfg.pipeline_microbatches = 2, 4
    cfg.use_bf16_compute = False
    ff = FFModel(cfg)
    embs = []
    for i, v in enumerate(vocabs):
        s = ff.create_tensor((32, 1), name=f"sparse_{i}", dtype="int32")
        embs.append(ff.embedding(s, v, 16, aggr=AggrMode.AGGR_MODE_SUM,
                                 name=f"emb_{i}"))
    x = ff.concat(embs, axis=1)
    h = x
    for _ in range(4):
        h = ff.dense(h, 64, activation="relu")
    out = ff.softmax(ff.dense(ff.concat([h, x], axis=1), 2))
    ff.compile(SGDOptimizer(0.05), "sparse_categorical_crossentropy", [],
               output_tensor=out)
    return ff, out


def _place_model():
    """An embedding (vocab 50) and a linear (32 -> 24), independent ops
    of two types, feeding one head."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ffconst import AggrMode
    cfg = FFConfig()
    cfg.batch_size, cfg.device, cfg.seed = 8, "cpu", 0
    cfg.only_data_parallel, cfg.use_bf16_compute = True, False
    ff = FFModel(cfg)
    ids = ff.create_tensor((8, 4), name="ids", dtype="int32")
    x = ff.create_tensor((8, 32), name="x")
    e = ff.embedding(ids, 50, 16, aggr=AggrMode.AGGR_MODE_SUM, name="emb")
    d = ff.dense(x, 24, name="proj")
    out = ff.softmax(ff.dense(ff.concat([e, d], axis=1), 4))
    ff.compile(SGDOptimizer(0.05), "sparse_categorical_crossentropy", [],
               output_tensor=out)
    return ff, out


@scenario
def banks(payload):
    """Banks and place groups over the world (each run of
    ``payload["runs"]``: (name, model, reference)), recompiled with the
    grouping attached to the data-parallel (or pipeline) strategy, from
    the reference's weights: forward, first-step gradients, a loss
    history, each rank's local shape of the stacked leaf."""
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.interop import load_reference_params
    from flexflow_tpu_torch.parallel.banks import (BankSpec, PlaceGroup,
                                                   choose_bank_axes,
                                                   find_bank_groups,
                                                   group_is_padded)
    from flexflow_tpu_torch.parallel.strategy import ShardingStrategy
    out = {}
    for name, model, ref_key in payload["runs"]:
        ref = payload["refs"][ref_key]
        if model == "place":
            ff, o = _place_model()
            st = ShardingStrategy.data_parallel(ff.layers, ff.graph_inputs,
                                                ff.dmesh)
            st.place_groups = [PlaceGroup(["emb", "proj"],
                                          ff.dmesh.axis_names[0])]
        else:
            if model == "bank_pipe":
                ff, o = _bank_pipe_model(payload["vocabs"][name])
                st = ff.strategy
                reserved = (st.pipeline.pp_axis,)
            else:
                ff, o = _dlrm_model(payload["vocabs"][name])
                st = ShardingStrategy.data_parallel(ff.layers,
                                                    ff.graph_inputs,
                                                    ff.dmesh)
                reserved = ()
            group = [g for g in find_bank_groups(ff.layers)
                     if g[0].op_type.name == "OP_EMBEDDING"][0]
            bank_axes, batch_axes = choose_bank_axes(ff.dmesh, len(group),
                                                     reserved)
            st.banks = [BankSpec([l.name for l in group], bank_axes,
                                 batch_axes=batch_axes,
                                 param_name="__bank0__EMB",
                                 padded=group_is_padded(group))]
        ff.compile(SGDOptimizer(0.05), "sparse_categorical_crossentropy",
                   [], output_tensor=o, strategy=st)
        load_reference_params(ff, ref["params"], ref["layers"])
        ex = ff.executor
        b0 = ref["batches"][0]
        r = {"forward": _np(ex.make_forward()(ff.params, ff.state, {
            k: v for k, v in b0.items() if k != "label"}))}
        r["grads"] = _tree_np(ex._grads(ff.params, ff.state, b0, 0)[0])
        step = ex.make_train_step()
        r["losses"] = [float(_np(ff._run_train_step(
            step, ref["batches"][i % len(ref["batches"])])["loss"]))
            for i in range(payload["steps"])]
        r["local"] = {ln: tuple(ws["kernel"].to_local().shape)
                      for ln, ws in ff.params.items()
                      if ln.startswith("__bank")}
        r["banks"] = [(list(b.members), list(b.axes), list(b.batch_axes),
                       b.padded) for b in ff.strategy.banks]
        r["region"] = _region(ff)
        r["mesh"] = dict(ff.dmesh.axis_sizes)
        out[name] = r
    return out


def _seq_mesh(n):
    """A (1, n) mesh of the world's ``n`` ranks whose trailing dim is
    ``seq``, as ``--seq-parallel n`` builds it."""
    import torch
    from flexflow_tpu_torch.parallel.machine import DeviceMesh, MachineSpec
    return DeviceMesh(MachineSpec(num_devices=n, generation="cpu-sim"),
                      devices=[torch.device("cpu")] * n, seq=n)


def _seq_calibration(cache):
    """The ring's calibration rows over the world's seq group: the
    collective rows with the hop's (``coll_ppermute``) and the
    kernel-impl rows with ring's, then the same calls again (a warm
    table measures nothing), and what the cost model reads from them."""
    import torch.distributed as dist
    from flexflow_tpu_torch.search.calibration import (
        CalibrationTable, calibrate_kernel_impls, calibrate_mesh)
    dm = _seq_mesh(dist.get_world_size())
    tab = CalibrationTable(f"{cache}/calib{dist.get_rank()}")
    sizes = (1 << 12, 1 << 14)
    calib = calibrate_mesh(dm, table=tab, sizes=sizes)
    calibrate_kernel_impls(dm, tab, impls=("ring",))
    first = tab.measured
    calibrate_mesh(dm, table=tab, sizes=sizes)
    calibrate_kernel_impls(dm, tab, impls=("ring",))
    return {"backend": calib.coll_backend, "measured": first,
            "again": tab.measured - first,
            "keys": sorted(k for k in tab._load()
                           if "ppermute" in k or "@ring" in k),
            "hop_4k": calib.collective_time("ppermute", 2, 1 << 12),
            "ring_s512": calib.op_time("attention@ring", 4 * 8 * 64 * 512,
                                       degree=2),
            "ring_deg0": calib.op_time("attention@ring", 4 * 8 * 64 * 512)}


def _ring_fns(cases):
    """``ring_attention`` / ``ulysses_attention`` on each case (name, fn,
    q, k, v, do whole (b, h, s, d) arrays, causal, dtype): this rank's
    chunk of o and of the q, k, v gradients (do's chunk the cotangent),
    the ring's hops and bytes and the flash wrapper's plain calls, each
    forward and backward."""
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    from flexflow_tpu_torch.kernels.ring_attention import (
        ring_attention, ulysses_attention)
    flash = (flash_attention, flash_attention_bwd_dq,
             flash_attention_bwd_dkv)
    comm = _seq_mesh(dist.get_world_size()).seq_group()
    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    out = {}
    for name, fn, q, k, v, do, causal, dtype in cases:
        dt = getattr(torch, dtype)
        c = q.shape[2] // comm.size
        cut = slice(comm.index * c, (comm.index + 1) * c)
        q_, k_, v_ = (torch.from_numpy(t[:, :, cut]).to(dt)
                      .requires_grad_(True) for t in (q, k, v))
        do_ = torch.from_numpy(do[:, :, cut]).to(dt)
        hops, nbytes = comm.hops, comm.bytes
        calls = [f.plain_calls for f in flash]
        o = fns[fn](q_, k_, v_, comm, causal=causal)
        fwd = (comm.hops - hops, comm.bytes - nbytes)
        gq, gk, gv = torch.autograd.grad(o, (q_, k_, v_), do_)
        out[name] = {
            "o": _np(o), "dq": _np(gq), "dk": _np(gk), "dv": _np(gv),
            "dtype": str(o.dtype), "fwd_hops": fwd,
            "bwd_hops": (comm.hops - hops - fwd[0],
                         comm.bytes - nbytes - fwd[1]),
            "flash_calls": [f.plain_calls - n0
                            for f, n0 in zip(flash, calls)]}
    return out


def _seq_model(kind, argv, batch, seq):
    """GPT-2 (vocab 64, hidden 32, 4 heads, 2 layers) or LLaMA-tiny with
    fused attention, GQA (2 kv heads of 4) and RoPE, in f32 under
    ``argv`` with attention on ``ring``, SGD."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import (GPTConfig, LlamaConfig,
                                           build_gpt2, build_llama)
    cfg = FFConfig.parse_args(list(argv))
    cfg.batch_size, cfg.device, cfg.seed = batch, "cpu", 0
    cfg.use_bf16_compute, cfg.only_data_parallel = False, True
    cfg.kernel_impls = "attention:ring"
    ff = FFModel(cfg)
    if kind == "gpt":
        out = build_gpt2(ff, batch, seq, GPTConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_position=seq, dropout=0.0))
    else:
        lc = LlamaConfig.tiny()
        lc.max_position, lc.num_kv_heads = seq, 2
        out = build_llama(ff, batch, seq, lc, fused_attention=True)
    ff.compile(SGDOptimizer(0.05), "sparse_categorical_crossentropy", [],
               output_tensor=out)
    return ff


def _seq_models(runs, refs, steps):
    """Each run (name, model, argv, reference) from the reference's
    weights: forward, first-step gradients and loss history
    (``_train_run``), the mesh, the kernel plan, the gradient sync's
    collectives and the ring's hops a step."""
    from flexflow_tpu_torch.parallel.distributed import SYNC_STATS
    out = {}
    for name, kind, argv, ref_key in runs:
        ref = refs[ref_key]
        seq = ref["batches"][0]["input_ids"].shape[1]
        ff = _seq_model(kind, argv, ref["batches"][0]["input_ids"]
                        .shape[0], seq)
        ring = ff.executor._seq_ring
        SYNC_STATS.reset()
        hops = ring.hops
        r = _train_run(ff, ref["params"], ref["layers"], ref["batches"],
                       steps)
        # the forward, the first-step gradients, then the steps
        r["hops"] = ring.hops - hops
        r["sync_calls"] = SYNC_STATS.calls
        r["mesh"] = dict(ff.dmesh.axis_sizes)
        r["plan"] = sorted(set(ff.executor._kernel_impls.values()))
        out[name] = r
    return out


def _seq_refusals():
    """What compile refuses over a seq world: a length the seq degree
    does not divide (the forced ring's predicate)."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    cfg = FFConfig.parse_args(["--seq-parallel", "2"])
    cfg.batch_size, cfg.device, cfg.only_data_parallel = 2, "cpu", True
    cfg.kernel_impls = "attention:ring"
    ff = FFModel(cfg)
    q = ff.create_tensor((2, 15, 16), name="q")
    ff.multihead_attention(q, q, q, embed_dim=16, num_heads=4)
    try:
        ff.compile(SGDOptimizer(0.01), "identity", [])
    except ValueError as e:
        return {"indivisible": str(e)}
    return {"indivisible": None}


@scenario
def seq(payload):
    """Sequence parallelism over the world: the functions on
    ``payload["fns"]``, the models of ``payload["runs"]``, where
    ``payload["refusals"]`` the compile refusals, and where
    ``payload["cache"]`` names a directory the calibration rows."""
    out = {"fns": _ring_fns(payload["fns"]),
           "models": _seq_models(payload["runs"], payload["refs"],
                                 payload["steps"])}
    if payload.get("refusals"):
        out["refusals"] = _seq_refusals()
    if payload.get("cache"):
        out["calib"] = _seq_calibration(payload["cache"])
    return out


@scenario
def suite(payload):
    """Every parallel configuration of the tests in one world: the
    ``bert``, ``presets`` and ``searched`` scenarios on their payloads."""
    return {"bert": bert(payload["bert"]),
            "presets": presets(payload["presets"]),
            "searched": searched(payload["searched"])}


# ----------------------------------------------------------------------
# the multi-host checkpoint and the fault drills
# ----------------------------------------------------------------------

def ckpt_state(step: int):
    """The state the checkpoint scenarios save at ``step``, as host
    arrays: ``w`` (8, 4) and ``h`` (4, 2, bf16) are sharded over the
    ranks by rows, ``r`` (3,) is replicated, ``bias`` a plain scalar (the
    JAX package's torn-checkpoint worker saves the same ``w`` and
    ``bias``)."""
    import numpy as np
    import torch
    return {"w": np.arange(32, dtype=np.float32).reshape(8, 4)
            * float(step + 1),
            "h": torch.arange(8, dtype=torch.float32).reshape(4, 2)
            .div(4).add(step).bfloat16(),
            "r": np.full(3, float(step), np.float32),
            "bias": np.float32(step)}


def _placed_state(step: int, mesh):
    from torch.distributed.tensor import Replicate, Shard
    from flexflow_tpu_torch.parallel.distributed import put_global
    st = ckpt_state(step)
    return {"w": put_global(st["w"], mesh, [Shard(0)]),
            "h": put_global(st["h"], mesh, [Shard(0)]),
            "r": put_global(st["r"], mesh, [Replicate()]),
            "bias": st["bias"]}


def _shard_blocks(path: str) -> dict:
    """leaf -> the [start, stop] index of every block in one shard file."""
    from flexflow_tpu_torch.runtime.checkpoint import _Unpickler
    with open(path, "rb") as f:
        tree = _Unpickler(f).load()
    out = {}

    def walk(t, key):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{key}/{k}" if key else k)
        else:
            out[key] = [idx for idx, _ in t.blocks]
    walk(tree, "")
    return out


def mlp_model(argv, device="cpu", seed=0, opt="adam"):
    """The JAX package's resilience smoke MLP: 16 -> 32 relu -> 4
    softmax, batch 8, under ``argv`` (data parallel over a world)."""
    from flexflow_tpu_torch import (ActiMode, AdamOptimizer, FFConfig,
                                    FFModel, SGDOptimizer)
    cfg = FFConfig.parse_args(list(argv))
    cfg.batch_size, cfg.device, cfg.seed = 8, device, seed
    cfg.use_bf16_compute = False
    ff = FFModel(cfg)
    x = ff.create_tensor((8, 16), name="x")
    t = ff.dense(x, 32, activation=ActiMode.AC_MODE_RELU)
    ff.softmax(ff.dense(t, 4))
    ff.compile(SGDOptimizer(lr=0.1) if opt == "sgd"
               else AdamOptimizer(alpha=1e-2, epsilon=1e-4),
               "sparse_categorical_crossentropy", [])
    return ff


def mlp_data(rows: int = 48):
    import numpy as np
    rng = np.random.default_rng(0)   # same data on every rank
    return (rng.normal(size=(rows, 16)).astype(np.float32),
            rng.integers(0, 4, size=rows).astype(np.int32))


def host_state(ff) -> dict:
    """The params and Adam's moments whole, as host arrays (a DTensor is
    gathered: a collective)."""
    return {slot: _tree_np(tree) for slot, tree in (
        ("params", ff.params), ("m", ff.opt_state["m"]),
        ("v", ff.opt_state["v"]))}


def _mlp_steps(ff, n: int) -> None:
    xs, ys = mlp_data()
    loader = ff._combined_loader(xs, ys, shuffle=False)
    step = ff.executor.make_train_step()
    for _ in range(n):
        ff._run_train_step(step, loader.next_batch())


@scenario
def ckpt_world(payload):
    """The multi-host format over the world: (a) ``ckpt_state`` placed
    on the world's mesh saved at steps 1 and 2 into ``payload["dir"]``
    /plain (each rank's shard blocks per leaf, then the quorum restore);
    (b) the MLP trained two Adam steps under ``--zero`` and saved into
    /zero (the whole state, gathered; the moments' shard blocks); (c) a
    fresh MLP of the same build restoring it (every local block
    bit-equal to the saved model's); (d) the one-process checkpoint at
    ``payload["single"]`` restored onto this world, gathered whole."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.parallel.distributed import process_index
    from flexflow_tpu_torch.resilience import coord
    from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager
    rank = process_index()
    coord.ensure_started()
    mesh = _world_mesh((2,)).mesh
    plain = os.path.join(payload["dir"], "plain")
    mgr = CheckpointManager(plain)
    mgr.save(1, _placed_state(1, mesh), metadata={"tag": "one"})
    mgr.save(2, _placed_state(2, mesh), metadata={"tag": "two"})
    out = {"blocks": _shard_blocks(os.path.join(plain, "2",
                                                f"shard-{rank}.pkl"))}
    state, meta = mgr.restore()
    out["restored"] = (meta["step"], meta["tag"], meta["world_size"], {
        k: np.asarray(v) for k, v in state.items()})
    zdir = os.path.join(payload["dir"], "zero")
    ff = mlp_model(["--only-data-parallel", "--zero"])
    _mlp_steps(ff, 2)
    ff.save_checkpoint(zdir)
    out["zero_state"] = host_state(ff)
    out["zero_blocks"] = _shard_blocks(os.path.join(zdir, "2",
                                                    f"shard-{rank}.pkl"))
    out["zero_placements"] = {
        f"{slot}/{ln}/{wn}": str(t.placements)
        for slot, tree in (("params", ff.params), ("m", ff.opt_state["m"]))
        for ln, ws in tree.items() for wn, t in ws.items()}
    import json
    with open(os.path.join(zdir, "2", "meta.json")) as f:
        zmeta = json.load(f)
    out["zero_meta"] = {k: zmeta.get(k) for k in ("world_size",
                                                  "opt_shardings")}
    out["zero_meta"]["strategy_ops"] = len(zmeta["strategy"] or {})
    before = _local_state(ff)
    fresh = mlp_model(["--only-data-parallel", "--zero"], seed=5)
    out["fresh_step"] = fresh.restore_checkpoint(zdir)
    after = _local_state(fresh)
    out["fresh_differ"] = sorted(k for k in before
                                 if not torch.equal(before[k], after[k]))
    one = mlp_model(["--only-data-parallel", "--zero"], seed=7)
    out["single_step"] = one.restore_checkpoint(payload["single"])
    out["single_state"] = host_state(one)
    return out


@scenario
def torn(payload):
    """The JAX package's torn-checkpoint drill on the port: in mode
    "train" save ``ckpt_state`` at steps 1 and 2 (a fault plan in the
    environment tears or corrupts step 2) under ``run_world_member``; in
    mode "restore" quorum-restore and report the adopted step, a CRC of
    the assembled ``w`` and the steps on disk."""
    import zlib

    import numpy as np
    from flexflow_tpu_torch.resilience import coord, run_world_member
    from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager
    coord.ensure_started()
    mesh = _world_mesh((2,)).mesh
    mgr = CheckpointManager(payload["dir"])
    if payload["mode"] == "train":
        def run():
            mgr.save(1, _placed_state(1, mesh), metadata={"tag": "good"})
            # crash_after_stage@2:1 fires inside this save on rank 1
            mgr.save(2, _placed_state(2, mesh), metadata={"tag": "torn"})
            return "TRAIN_OK"
        return run_world_member(run)
    state, meta = mgr.restore()
    w = np.asarray(state["w"])
    return {"step": meta["step"],
            "crc": zlib.crc32(w.tobytes()) & 0xFFFFFFFF,
            "bias": float(np.asarray(state["bias"])),
            "steps": sorted(mgr.all_steps())}


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _main(sys.argv[1], sys.argv[2])
