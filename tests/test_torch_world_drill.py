"""The port's world recovery drill on the CPU, held against the JAX
package's training of the same model.

``tools/torch_dist_resilience_smoke.py --worker`` trains the JAX
package's resilience smoke MLP (16 -> 32 relu -> 4, batch 8, 48 rows,
SGD 0.1, 2 epochs, the loader's seeded shuffle) in a 2-rank gloo world
under a per-process ``Supervisor`` with a two-phase checkpoint every
step, launched by the port's ``WorldSupervisor``, from the JAX model's
initial weights (``interop.load_reference_params``). Clean, its final
loss is within 1e-6 of the JAX package's ``fit`` of the same model data
parallel on 2 of the conftest's CPU devices. Under
``FF_FAULT_PLAN_EPOCH0=rank_crash@3:1`` rank 1 dies before step 3, rank
0 exits the detector code naming rank 1, the relaunched epoch resumes
from a committed step, and the world ends bit-equal to the clean one
(the final loss, and the CRC32 of every block of every param on both
ranks).
"""
import json
import os
import pickle
import sys

import jax
import numpy as np

import flexflow_tpu as ffj
from flexflow_tpu.parallel.machine import MachineSpec
from flexflow_tpu_torch.resilience import WorldSupervisor
from flexflow_tpu_torch.resilience.coord import EXIT_RANK_FAILURE
from flexflow_tpu_torch.resilience.faults import RANK_CRASH_EXIT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "torch_dist_resilience_smoke.py")
LOSS_TOL = 1e-6
_RUNS = {}


def _jax_reference(tmp):
    """The JAX package's dp-2 ``fit`` of the smoke MLP and the initial
    weights it started from (saved for the port's ranks)."""
    cfg = ffj.FFConfig()
    cfg.batch_size, cfg.only_data_parallel = 8, True
    cfg.use_bf16_compute = False
    ff = ffj.FFModel(cfg)
    x = ff.create_tensor((8, 16), name="x")
    t = ff.dense(x, 32, activation=ffj.ActiMode.AC_MODE_RELU)
    ff.softmax(ff.dense(t, 4))
    spec = MachineSpec.detect()
    spec.num_devices = 2
    ff.compile(ffj.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
               [], machine_spec=spec)
    path = os.path.join(tmp, "init.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": jax.device_get(ff.params),
                     "layers": [(l.name, int(l.op_type))
                                for l in ff.layers]}, f)
    rng = np.random.default_rng(0)   # the worker's data
    xs = rng.normal(size=(48, 16)).astype(np.float32)
    ys = rng.integers(0, 4, size=48).astype(np.int32)
    hist = ff.fit(xs, ys, epochs=2, verbose=False)
    return path, float(hist[-1]["loss"]), dict(ff.dmesh.axis_sizes)


def _world(tmp, name, fault):
    """The drill's world under ``fault`` (an epoch-0 plan): the
    WorldSupervisor and each epoch's member records."""
    d = os.path.join(tmp, name)
    spec = {"model": "mlp", "device": "cpu", "rows": 48, "epochs": 2,
            "every": 1, "keep": 3, "mode": "train", "shuffle": True,
            "argv": ["--only-data-parallel"], "params": _RUNS["init"]}
    os.makedirs(d)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    env = {"FF_SMOKE_SPEC": os.path.join(d, "spec.json"),
           "FF_SMOKE_CKPT_DIR": os.path.join(d, "ckpt"),
           "FF_SMOKE_OUT": os.path.join(d, "out"),
           "FF_FAULT_PLAN_EPOCH0": fault, "FF_FAULT_PLAN": "",
           "FF_HB_INTERVAL_S": "0.1", "FF_HB_TIMEOUT_S": "5",
           "FF_BARRIER_TIMEOUT_S": "20", "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}
    ws = WorldSupervisor([sys.executable, TOOL, "--worker"], nprocs=2,
                         max_world_restarts=1, policy="auto", batch_size=8,
                         world_timeout_s=55.0, env=env)
    records = ws.run()
    assert all(r["rc"] == 0 for r in records), \
        [r["err"][-2000:] for r in records]
    recs = {}
    out = os.path.join(d, "out")
    for fn in sorted(os.listdir(out)):
        if fn.endswith(".json"):
            with open(os.path.join(out, fn)) as f:
                r = json.load(f)
            recs[(r["epoch"], r["rank"])] = r
    return ws, recs


def _runs(tmp_path_factory):
    if not _RUNS:
        tmp = str(tmp_path_factory.mktemp("drill"))
        _RUNS["init"], _RUNS["jax_loss"], _RUNS["jax_mesh"] = \
            _jax_reference(tmp)
        _RUNS["clean"] = _world(tmp, "clean", "")
        _RUNS["faulted"] = _world(tmp, "faulted", "rank_crash@3:1")
    return _RUNS


def test_clean_world_matches_jax_fit(tmp_path_factory):
    runs = _runs(tmp_path_factory)
    ws, recs = runs["clean"]
    assert int(np.prod(list(runs["jax_mesh"].values()))) == 2
    assert (ws.epoch, ws.world_restarts, ws.shrinks) == (0, 0, 0)
    losses = [recs[(0, r)]["loss"] for r in (0, 1)]
    assert losses[0] == losses[1]
    assert [recs[(0, r)]["start"] for r in (0, 1)] == [-1, -1]
    assert len(recs[(0, 0)]["steps"]) == 12
    assert abs(losses[0] - runs["jax_loss"]) <= LOSS_TOL, \
        (losses, runs["jax_loss"])


def test_rank_crash_world_recovers_bit_exact(tmp_path_factory):
    runs = _runs(tmp_path_factory)
    ws, recs = runs["faulted"]
    _, clean = runs["clean"]
    assert (ws.epoch, ws.world_restarts, ws.shrinks) == (1, 1, 0)
    # rank 1 died hard; rank 0 named it and exited the detector code
    assert ws.report[0]["rcs"] == [EXIT_RANK_FAILURE, RANK_CRASH_EXIT]
    fail = recs[(0, 0)]["failure"]
    assert fail["rank"] == 1, fail
    assert fail["restarts"] == 0, fail   # a dead peer costs no restart
    # rank 1 ran steps 0-2 and died before step 3
    assert [s["step"] for s in recs.get((0, 1), {"steps": []})["steps"]] \
        in ([], [0, 1, 2])
    for r in (0, 1):
        e1 = recs[(1, r)]
        # the relaunched epoch resumed from a committed step, restored
        # bit-equal to the assembled step, and ends bit-equal to clean
        assert 2 <= e1["start"] <= 3, e1["start"]
        chk = e1["restore_check"]
        assert chk["step"] == e1["start"] and chk["differ"] == []
        assert e1["steps"][0]["step"] == e1["start"]
        assert e1["loss"] == clean[(0, r)]["loss"]
        assert e1["crcs"] == clean[(0, r)]["crcs"]
    assert recs[(1, 0)]["restore_check"]["assembled_crc"] == \
        recs[(1, 1)]["restore_check"]["assembled_crc"]
