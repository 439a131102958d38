"""World resilience smoke of the PyTorch/CUDA port (``flexflow_tpu_torch``).

    python tools/torch_dist_resilience_smoke.py            # the CPU drill
    python tools/torch_dist_resilience_smoke.py --worker   # one member

Launcher mode (default): a ``WorldSupervisor`` drives a 2-process gloo
world on the CPU training the JAX package's smoke MLP (16 -> 32 relu ->
4, batch 8, 48 rows, SGD 0.1, 2 epochs) under per-process Supervisors
with a two-phase multi-host checkpoint every step.
``FF_FAULT_PLAN_EPOCH0`` (default ``rank_crash@3:1``) kills rank 1 hard
(``os._exit``, no cleanup) before global step 3 in world epoch 0. The
world must notice within its bounds, re-form at epoch 1 (relaunch under
the restart budget, or shrink with ``FF_SMOKE_POLICY=shrink``), resume
from the last committed checkpoint and finish with one finite loss on
every rank. Exit code 0 = the cross-process recovery path works.

Worker mode (``--worker``; the world's environment comes from the
WorldSupervisor): one member of the world. ``FF_SMOKE_CKPT_DIR`` is the
shared checkpoint directory, ``FF_SMOKE_OUT`` a directory for this
member's record (``rank<r>_epoch<e>.json``, rewritten after every step:
the times it joined the world and compiled, the start step, the loss
history, each step's time and kernel launches, each save's time in the
caller and in the writer and its shard bytes, the restore's time and
its check against the assembled
step, the CRC32 of every local block of the params and Adam's moments at
the end, and a detected ``RankFailure``), ``FF_SMOKE_SPEC`` a JSON file
naming the model and run (default: the MLP above on the CPU):

  - ``model``: "mlp" or "bert" (``bert``: "base" or "tiny", ``seq``,
    ``layers``, ``dropout``; Adam 1e-4, flash attention and the fused
    Adam, as the card check's resilience phase trains it);
  - ``device`` ("cpu" or "cuda"), ``argv`` (the compile flags, e.g.
    ``["--only-data-parallel", "--zero"]``), ``rows``, ``epochs``,
    ``shuffle`` (the loader's seeded shuffle, off by default as in the
    JAX smoke), ``every`` (steps between checkpoints), ``keep``,
    ``async_save`` (the file writes and commit barriers on the
    manager's writer thread),
    ``params`` (a
    pickle of ``{"params", "layers"}`` to start from, as
    ``interop.load_reference_params`` takes them);
  - ``mode``: "train" (the Supervisor's run), "torn" (save after step 1
    and after step 2: the torn-checkpoint drill under
    ``crash_after_stage@2:1``) or "restore" (quorum-restore the newest
    committed step's files, no model, and record their CRC32);
    ``epoch_modes`` maps a world epoch to
    another mode (``{"1": "restore"}``: the re-formed world restores);
  - ``bf16`` (the compute dtype; the config's default otherwise).

``chip_smoke.py``'s world phase runs this worker with BERT-base on the
card; ``tests/test_torch_world_drill.py`` with the MLP on the CPU.
"""
import json
import os
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the MLP smoke's run (the JAX package's tools/dist_resilience_smoke.py)
DEFAULT_SPEC = {"model": "mlp", "device": "cpu", "bf16": False,
                "argv": ["--only-data-parallel"], "rows": 48, "epochs": 2,
                "every": 1, "keep": 3, "mode": "train"}


# ----------------------------------------------------------------------
# the member
# ----------------------------------------------------------------------
def build(spec):
    """The spec's model, compiled (over the world: the coordinator
    starts here), and its training data (the same on every rank)."""
    import numpy as np
    from flexflow_tpu_torch import FFConfig, FFModel
    cfg = FFConfig.parse_args(list(spec.get("argv", ())))
    cfg.batch_size, cfg.seed = spec.get("batch", 8), 0
    cfg.device = spec["device"]
    if "bf16" in spec:
        cfg.use_bf16_compute = bool(spec["bf16"])
    rng = np.random.default_rng(spec.get("seed", 0))
    rows = spec["rows"]
    if spec["model"] == "mlp":
        from flexflow_tpu_torch import ActiMode, SGDOptimizer
        ff = FFModel(cfg)
        x = ff.create_tensor((cfg.batch_size, 16), name="x")
        t = ff.dense(x, 32, activation=ActiMode.AC_MODE_RELU)
        ff.softmax(ff.dense(t, 4))
        ff.compile(SGDOptimizer(lr=0.1),
                   "sparse_categorical_crossentropy", [])
        xs = rng.normal(size=(rows, 16)).astype(np.float32)
        ys = rng.integers(0, 4, size=rows).astype(np.int32)
        return ff, xs, ys
    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch.models import BertConfig, build_bert
    cuda = spec["device"] == "cuda"
    # (the fused Adam's predicate refuses the CPU: a CPU run sets the
    # plan after the compile, and the kernel's plain version runs)
    cfg.kernel_impls = "attention:flash,opt_update:fused" if cuda \
        else "attention:flash"
    ff = FFModel(cfg)
    bcfg = getattr(BertConfig, spec.get("bert", "base"))()
    bcfg.max_position, bcfg.dropout = spec["seq"], spec.get("dropout", 0.1)
    bcfg.num_layers = spec.get("layers", bcfg.num_layers)
    out = build_bert(ff, cfg.batch_size, spec["seq"], bcfg)
    ff.compile(AdamOptimizer(1e-4), "sparse_categorical_crossentropy",
               ["accuracy"], output_tensor=out)
    ff.executor._kernel_impls["opt_update"] = "fused"
    ids = rng.integers(0, bcfg.vocab_size, (rows, spec["seq"])).astype(
        np.int32)
    pos = np.tile(np.arange(spec["seq"], dtype=np.int32), (rows, 1))
    ys = rng.integers(0, bcfg.num_labels, (rows, 1)).astype(np.int32)
    return ff, [ids, pos], ys


def kernel_counts(cuda: bool) -> dict:
    """Each kernel wrapper's launches (its plain version's calls on the
    CPU, where they stand in for launches)."""
    from flexflow_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    from flexflow_tpu_torch.kernels.opt_update import fused_adam_update
    fns = {"flash_attention_fwd": flash_attention,
           "flash_attention_bwd_dq": flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
           "adam_update": fused_adam_update}
    return {n: f.launches if cuda else f.plain_calls
            for n, f in fns.items()}


def state_leaves(ff, blocks: bool = True) -> dict:
    """key -> every param and optimizer-state leaf (``params/...``,
    ``opt_state/<slot>/...``): this rank's block of it, or with
    ``blocks=False`` the leaf itself."""
    from flexflow_tpu_torch.parallel.local_ops import is_dtensor
    out = {}
    for top, tree in (("params", ff.params), ("opt_state", ff.opt_state)):
        stack = [(top, tree)]
        while stack:
            key, t = stack.pop()
            if isinstance(t, dict):
                stack.extend((f"{key}/{k}", v) for k, v in t.items())
            else:
                out[key] = t.to_local() if blocks and is_dtensor(t) else t
    return out


def crcs(ff) -> dict:
    """CRC32 of every local block (bit-equality of two runs' states
    without moving them)."""
    import torch
    out = {}
    for key, t in state_leaves(ff).items():
        t = t.detach()
        if t.dtype.is_floating_point and t.element_size() == 2:
            t = t.view(torch.int16)   # numpy has no bfloat16
        out[key] = zlib.crc32(t.cpu().contiguous().numpy().tobytes()) \
            & 0xFFFFFFFF
    return out


def assembled_crc(state: dict) -> tuple:
    """(leaves, CRC32) of an assembled host state's params and
    optimizer state, every leaf in key order."""
    import numpy as np
    leaves = {}
    for top in ("params", "opt_state"):
        stack = [(top, state[top])]
        while stack:
            key, t = stack.pop()
            if isinstance(t, dict):
                stack.extend((f"{key}/{k}", v) for k, v in t.items())
            else:
                leaves[key] = t
    crc = 0
    for key in sorted(leaves):
        crc = zlib.crc32(np.ascontiguousarray(leaves[key]).tobytes(), crc)
    return len(leaves), crc & 0xFFFFFFFF


def check_restore(ff, directory: str, step: int) -> dict:
    """The live blocks against the committed step ``step`` assembled
    from its files: how many leaves differ in any bit, and the CRC32 of
    the assembled state."""
    import torch
    from flexflow_tpu_torch.parallel.distributed import shard_bounds
    from flexflow_tpu_torch.parallel.local_ops import is_dtensor
    from flexflow_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                       _host_to_torch)
    state, _ = CheckpointManager(directory)._load_step(step, verify=False)
    differ = []
    live = state_leaves(ff, blocks=False)
    for key, t in live.items():
        node = state
        for k in key.split("/"):
            node = node[k]
        src = _host_to_torch(node).reshape(t.shape)
        if is_dtensor(t):
            src = src[tuple(slice(lo, hi) for lo, hi in shard_bounds(
                t.shape, t.device_mesh, t.placements))]
            t = t.to_local()
        if not torch.equal(t.detach().cpu(), src.to(t.dtype)):
            differ.append(key)
    n, crc = assembled_crc(state)
    return {"step": step, "leaves": n, "differ": differ,
            "assembled_crc": crc}


def member(spec, ckpt: str, out_dir: str, spawned: float) -> None:
    import torch
    from flexflow_tpu_torch.parallel.distributed import (maybe_initialize,
                                                         process_count,
                                                         process_index)
    from flexflow_tpu_torch.resilience import Supervisor, coord, status
    from flexflow_tpu_torch.runtime.checkpoint import (
        CheckpointManager, save_model_checkpoint)
    t_main = time.time()
    cuda = spec["device"] == "cuda"
    epoch = int(os.environ.get("FF_WORLD_EPOCH", "0"))
    mode = spec.get("epoch_modes", {}).get(str(epoch), spec["mode"])
    rec = {"epoch": epoch, "spawned": spawned, "main": t_main,
           "steps": [], "saves": [], "save_calls": [], "mode": mode}
    path = [None]
    writes = []

    def dump():
        rec["saves"] = list(writes)
        if path[0] is not None:
            with open(path[0] + ".tmp", "w") as f:
                json.dump(rec, f)
            os.replace(path[0] + ".tmp", path[0])

    try:
        maybe_initialize(None, spec["device"])   # the world's rendezvous
        rank = process_index()
        rec.update(rank=rank, world=process_count(), joined=time.time())
        path[0] = os.path.join(out_dir, f"rank{rank}_epoch{epoch}.json")
        if mode == "restore":
            # a fresh world quorum-restores the newest committed step
            # (no model: the step's files against each other)
            coord.ensure_started()
            t0 = time.time()
            state, meta = CheckpointManager(ckpt).restore()
            rec["restore_s"] = time.time() - t0
            rec["start"] = meta["step"]
            n, crc = assembled_crc(state)
            rec["restore_check"] = {"step": meta["step"], "leaves": n,
                                    "differ": [], "assembled_crc": crc}
            rec["steps_on_disk"] = CheckpointManager(ckpt).all_steps()
            rec["done"] = time.time()
            dump()
            print(f"SMOKE_OK rank={rank} epoch={epoch} "
                  f"world={process_count()} start={rec['start']}",
                  flush=True)
            return
        ff, xs, ys = build(spec)
        rec["compiled"] = time.time()
        alive = os.path.join(out_dir, f"alive_rank{rank}_epoch{epoch}")
        if spec.get("params"):
            import pickle
            from flexflow_tpu_torch.interop import load_reference_params
            with open(spec["params"], "rb") as f:
                ref = pickle.load(f)
            load_reference_params(ff, ref["params"], ref["layers"])
        run_step = ff._run_train_step

        def counted(step_fn, batch):
            # the last step this rank began, on disk before it runs: a
            # rank killed inside it leaves the time of its death behind
            with open(alive, "w") as f:
                f.write(f"{ff._step} {time.time()!r}")
            before = kernel_counts(cuda)
            step, t0 = ff._step, time.time()
            bm = run_step(step_fn, batch)
            if cuda:
                torch.cuda.synchronize()
            after = kernel_counts(cuda)
            rec["steps"].append({"step": step, "t0": t0, "t": time.time(),
                                 "launches": {k: after[k] - before[k]
                                              for k in after}})
            dump()   # a rank that dies later keeps its steps on record
            return bm
        ff._run_train_step = counted

        def timed_writes(mgr):
            """Time the manager's file writes (the shard and the
            commit), wherever they run."""
            for name in ("_write_multihost", "_write_step"):
                write = getattr(mgr, name)

                def timed(step, *args, _write=write, **kw):
                    t0 = time.time()
                    _write(step, *args, **kw)
                    sdir = os.path.join(ckpt, str(step))
                    p = os.path.join(sdir, f"shard-{rank}.pkl")
                    if not os.path.exists(p):
                        p = os.path.join(sdir, "state.pkl")
                    writes.append({"step": step, "t0": t0,
                                   "s": time.time() - t0,
                                   "bytes": os.path.getsize(p)})
                setattr(mgr, name, timed)
            return mgr

        if mode == "train":
            sup = Supervisor(ff, ckpt, checkpoint_every=spec["every"],
                             max_to_keep=spec.get("keep", 3),
                             async_save=bool(spec.get("async_save")))
            timed_writes(sup._mgr)
            resume, save = sup._try_resume, sup._save

            def timed_resume(loader):
                t0 = time.time()
                ok = resume(loader)
                rec["restore_s"] = time.time() - t0
                rec["start"] = ff._step if ok else -1
                if ok:
                    rec["restore_check"] = check_restore(ff, ckpt,
                                                         ff._step)
                return ok

            def timed_save(loader):
                # the caller's part: the host copy (the writes too,
                # unless they run on the writer thread)
                t0 = rec["save_t0"] = time.time()
                save(loader)
                rec["save_calls"].append({"step": ff._step,
                                          "s": time.time() - t0})
            sup._try_resume, sup._save = timed_resume, timed_save
            hist = sup.run(x=xs, y=ys, epochs=spec["epochs"],
                           shuffle=bool(spec.get("shuffle", False)))
            rec["history"] = [h["loss"] for h in hist]
            rec["loss"] = hist[-1]["loss"]
        else:   # "torn"
            mgr = timed_writes(CheckpointManager(
                ckpt, max_to_keep=spec.get("keep", 3)))
            loader = ff._combined_loader(xs, ys, shuffle=False)
            step_fn = ff.executor.make_train_step()
            for _ in range(2):
                ff._run_train_step(step_fn, loader.next_batch())
                t0 = rec["save_t0"] = time.time()
                # crash_after_stage@2:1 fires inside the second save
                save_model_checkpoint(ff, ckpt, manager=mgr)
                rec["save_calls"].append({"step": ff._step,
                                          "s": time.time() - t0})
        rec["crcs"] = crcs(ff)
        # the fused Adam's leaves on this rank: each moment's local
        # block (a ZeRO block, or the whole leaf)
        m = (ff.opt_state or {}).get("m", {})
        rec["adam_shapes"] = [list(t.to_local().shape if hasattr(
            t, "to_local") else t.shape) for ws in m.values()
            for t in ws.values()]
        rec["done"] = time.time()
        dump()
        print(f"SMOKE_OK rank={rank} epoch={epoch} world={process_count()}"
              f" start={rec.get('start', -1)} "
              f"loss={rec.get('loss', float('nan'))!r}", flush=True)
    except Exception as e:
        rf = coord.as_rank_failure(e)
        if rf is not None:
            # the error the step caught (a collective's, before the
            # Supervisor attributed it), and the restarts it consumed
            cause = e.__cause__ or e
            rec["failure"] = {"rank": rf.rank, "reason": rf.reason,
                              "t": time.time(),
                              "error": f"{type(cause).__name__}: "
                                       f"{cause}"[:400],
                              "restarts": status.snapshot()["restarts"]}
            dump()
            raise rf from e
        raise


def worker() -> None:
    from flexflow_tpu_torch.resilience import run_world_member
    spec = dict(DEFAULT_SPEC)
    if os.environ.get("FF_SMOKE_SPEC"):
        with open(os.environ["FF_SMOKE_SPEC"]) as f:
            spec.update(json.load(f))
    spawned = float(sys.argv[sys.argv.index("--spawned") + 1]) \
        if "--spawned" in sys.argv else float("nan")
    out_dir = os.environ.get("FF_SMOKE_OUT") or os.environ[
        "FF_SMOKE_CKPT_DIR"]
    os.makedirs(out_dir, exist_ok=True)
    run_world_member(member, spec, os.environ["FF_SMOKE_CKPT_DIR"],
                     out_dir, spawned)


# ----------------------------------------------------------------------
# the launcher: the CPU drill
# ----------------------------------------------------------------------
def launch() -> None:
    import glob
    import shutil
    import tempfile

    from flexflow_tpu_torch.obs import flight
    from flexflow_tpu_torch.resilience import WorldSupervisor

    ckpt = tempfile.mkdtemp(prefix="ff_torch_dist_smoke_")
    policy = os.environ.get("FF_SMOKE_POLICY", "auto")
    env = {
        "FF_SMOKE_CKPT_DIR": ckpt,
        "FF_FAULT_PLAN_EPOCH0": os.environ.get(
            "FF_FAULT_PLAN_EPOCH0", "rank_crash@3:1"),
        "FF_HB_INTERVAL_S": "0.1",
        "FF_HB_TIMEOUT_S": "3",
        "FF_BARRIER_TIMEOUT_S": "20",
        "OMP_NUM_THREADS": "1",
        "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
    }
    for p in glob.glob(flight.flight_path("*", "*")):
        os.remove(p)   # an earlier run's records must not count here
    ws = WorldSupervisor(
        [sys.executable, os.path.abspath(__file__), "--worker"],
        nprocs=2, max_world_restarts=1, policy=policy, batch_size=8,
        world_timeout_s=240.0, env=env)
    try:
        records = ws.run()
        assert ws.world_restarts + ws.shrinks >= 1, \
            "fault injected but the world never needed re-forming"
        flights = glob.glob(flight.flight_path("*", "*"))
        assert any(r.get("flight_records") for r in ws.report), \
            "WorldSupervisor report references no flight record"
        losses = []
        for rec in records:
            toks = [t for ln in rec["out"].splitlines()
                    if ln.startswith("SMOKE_OK") for t in ln.split()
                    if t.startswith(("loss=", "start="))]
            assert toks, f"rank {rec['rank']} printed no SMOKE_OK:\n" \
                f"{rec['out'][-800:]}\n{rec['err'][-800:]}"
            assert int(toks[0].split("=")[1]) >= 0, \
                "the re-formed world did not resume from a checkpoint"
            losses.append(float(toks[-1].split("=")[1]))
        assert len(set(losses)) == 1, f"final losses disagree: {losses}"
        print(f"torch dist resilience smoke OK: {len(ws.report)} world "
              f"epoch(s) {[(r['epoch'], r['nprocs'], r['rcs']) for r in ws.report]}"
              f", {ws.world_restarts} relaunch(es), {ws.shrinks} "
              f"shrink(s), final world {ws.nprocs} proc(s), loss "
              f"{losses[0]!r}; {len(flights)} flight record(s)")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker()
    else:
        launch()
