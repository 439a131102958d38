"""The port's resilience subsystem (flexflow_tpu_torch/resilience,
runtime/checkpoint.py) against the JAX package's single-process tests
(tests/test_resilience.py): fault plans, verified atomic checkpoints,
the dataloader's resumable state and the Supervisor.

Fault plans parse to the same clauses in both packages. The Supervisor
runs the reference's MLP (20 -> 64 ReLU -> 4, SGD 0.1, batch 64, 256
seeded rows, checkpoint every step) from the JAX model's initial
weights: a crash with a corrupted newest checkpoint, and a NaN
rollback, each end bit-identical to the port's clean run, within 1e-5
of the JAX package's supervised run under the same plan (f32; the JAX
run is data-parallel over the conftest's 8 CPU devices, so only the
summation order differs), and with the same resilience status counts.
"""
import json
import os
import pickle
import re

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.resilience import Supervisor as JaxSupervisor
from flexflow_tpu.resilience import faults as jax_faults
from flexflow_tpu.resilience import status as jax_status
from flexflow_tpu_torch.interop import load_reference_params
from flexflow_tpu_torch.resilience import (DeviceLoss, FaultPlan,
                                           RestartBudgetExceeded,
                                           SimulatedCrash, Supervisor,
                                           faults, run_supervised, status)
from flexflow_tpu_torch.runtime.checkpoint import (
    CheckpointCorruption, CheckpointManager, UnsupportedCheckpointFormat,
    save_model_checkpoint)
from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_faults(tmp_path, monkeypatch):
    from flexflow_tpu.obs import flight as jax_flight
    from flexflow_tpu_torch.obs import flight
    # NaN rollbacks write flight records: keep them out of the repo
    for mod in (flight, jax_flight):
        monkeypatch.setattr(mod, "_DEFAULT_DIR", str(tmp_path / "ffcache"))
    for f, s in ((faults, status), (jax_faults, jax_status)):
        f.install("")
        s.reset()
    yield
    for f, s in ((faults, status), (jax_faults, jax_status)):
        f.clear()
        s.reset()


# ======================================================================
# fault plan grammar
# ======================================================================
def _docstring_plans():
    """Every FF_FAULT_PLAN example string in the JAX package's faults.py
    docstring."""
    return re.findall(r'FF_FAULT_PLAN="([^"]*)"', jax_faults.__doc__)


def _clauses(plan):
    return [(f.kind, f.step, f.arg, tuple(f.args), f.fired)
            for f in plan.faults]


@pytest.mark.parametrize("text", _docstring_plans() + [
    "lose@1;nan_grad@2;corrupt@3;truncate@4;infer@5;degrade@6:ici:3;"
    "shift@7:32",
    "crash@2; nan@5, lose_device@9:2;corrupt_ckpt@3",
    "infer_crash@4;rank_crash@1:0;rank_hang@2:1", ""])
def test_fault_plans_parse_like_jax(text):
    assert _clauses(FaultPlan.parse(text)) == \
        _clauses(jax_faults.FaultPlan.parse(text))


def test_docstring_examples_cover_every_kind():
    plans = _docstring_plans()
    assert len(plans) >= 14
    kinds = {f.kind for p in plans for f in FaultPlan.parse(p).faults}
    assert kinds >= {"crash", "nan", "corrupt_ckpt", "truncate_ckpt",
                     "lose_device", "rank_crash", "rank_hang",
                     "corrupt_shard", "crash_after_stage",
                     "degrade_link", "workload_shift"}


@pytest.mark.parametrize("bad,match", [("crash", "bad fault clause"),
                                       ("meteor@3", "unknown fault kind")])
def test_bad_plans_refused_like_jax(bad, match):
    for mod in (faults, jax_faults):
        with pytest.raises(ValueError, match=match):
            mod.FaultPlan.parse(bad)


def test_fault_fires_exactly_once():
    plan = faults.install("crash@2")
    assert faults.active()
    with pytest.raises(SimulatedCrash):
        faults.raise_pending(2)
    # consumed: an in-process restart replaying step 2 must not re-crash
    faults.raise_pending(2)
    assert not faults.active()
    assert plan.unfired() == 0
    assert status.snapshot()["faults_injected"] == 1


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_poison_clause_fires_once(kind):
    faults.install(f"{kind}@3")
    assert faults.poison_value(2) is None
    v = faults.poison_value(3)
    assert (np.isnan(v) if kind == "nan" else v == float("inf"))
    assert faults.poison_value(3) is None
    assert status.snapshot()["last_fault"] == f"{kind}@3"


def test_device_loss_carries_count():
    faults.install("lose_device@4:3")
    with pytest.raises(DeviceLoss) as ei:
        faults.raise_pending(4)
    assert ei.value.n_lost == 3


def test_rank_scoped_and_drill_clauses_in_one_process():
    """Rank-scoped kinds fire only where the rank matches (rank 0 here,
    no process group); degrade_link / workload_shift record."""
    faults.install("rank_crash@3:1;degrade_link@2:dcn:4;"
                   "workload_shift@5:16")
    faults.raise_pending(3)     # rank 1's clause: left unfired here
    assert faults.get_plan().faults[0].fired is False
    faults.raise_pending(2)
    assert faults.degraded_links() == {"dcn": 4.0}
    faults.raise_pending(5)
    assert faults.pending_workload_shift() == 16
    assert faults.pending_workload_shift() is None


def test_infer_fault_counter_resets_per_plan():
    faults.install("infer_fail@0")
    with pytest.raises(faults.FaultError):
        faults.raise_infer_fault()
    assert faults.get_plan().unfired() == 0
    faults.install("infer_fail@0")
    with pytest.raises(faults.FaultError):
        faults.raise_infer_fault()


# ======================================================================
# checkpoint hardening
# ======================================================================
def _mgr(tmp_path, **kw):
    return CheckpointManager(str(tmp_path / "ckpt"), **kw)


def _state(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(8, 4)).astype(np.float32)},
            "opt_state": {"m": rng.normal(size=(8, 4)).astype(np.float32)}}


def test_all_steps_skips_truncated_meta_and_orphans(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    os.makedirs(tmp_path / "ckpt" / "3")
    with open(tmp_path / "ckpt" / "3" / "meta.json", "w") as f:
        f.write('{"step": 3')
    os.makedirs(tmp_path / "ckpt" / "4")
    with open(tmp_path / "ckpt" / "4" / "state.pkl", "wb") as f:
        f.write(b"partial")
    os.makedirs(tmp_path / "ckpt" / "tmp-5")
    assert mgr.all_steps() == [1, 2]
    state, meta = mgr.restore()
    assert meta["step"] == 2
    np.testing.assert_array_equal(state["params"]["w"],
                                  _state(2)["params"]["w"])


def test_crash_between_state_and_meta_write(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1))
    real_dump = json.dump

    def die(*a, **k):  # first json.dump in _write_step is the manifest
        raise KeyboardInterrupt("kill -9")
    json.dump = die
    try:
        with pytest.raises(KeyboardInterrupt):
            mgr.save(2, _state(2))
    finally:
        json.dump = real_dump
    assert os.path.isdir(tmp_path / "ckpt" / "tmp-2")
    assert not os.path.isdir(tmp_path / "ckpt" / "2")
    assert mgr.all_steps() == [1]
    _, meta = mgr.restore()
    assert meta["step"] == 1
    mgr.save(2, _state(2))
    assert mgr.all_steps() == [1, 2]


def test_manifest_detects_bit_rot_and_falls_back(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    p = tmp_path / "ckpt" / "2" / "state.pkl"
    bad = _state(2)
    bad["params"]["w"][0, 0] += 1.0
    with open(p, "wb") as f:
        pickle.dump(bad, f)
    with pytest.raises(CheckpointCorruption, match="CRC32"):
        mgr.restore(step=2)
    state, meta = mgr.restore()
    assert meta["step"] == 1
    assert status.snapshot()["corrupt_checkpoints_skipped"] >= 1
    assert mgr.verify_step(1) and not mgr.verify_step(2)


@pytest.mark.parametrize("clause,listed", [("corrupt_ckpt@2", [1, 2]),
                                           ("truncate_ckpt@2", [1])])
def test_injected_checkpoint_faults(tmp_path, clause, listed):
    """corrupt_ckpt flips bytes in the just-saved step (listed, skipped
    by restore); truncate_ckpt halves its meta.json (unlisted)."""
    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1))
    faults.install(clause)
    mgr.save(2, _state(2))
    assert mgr.all_steps() == listed
    _, meta = mgr.restore()
    assert meta["step"] == 1


def test_async_save_restores_identically(tmp_path):
    mgr = _mgr(tmp_path, async_save=True)
    s = _state(3)
    mgr.save(7, s, metadata={"tag": "async"})
    mgr.wait()
    state, meta = mgr.restore()
    assert meta["step"] == 7 and meta["tag"] == "async"
    np.testing.assert_array_equal(state["params"]["w"], s["params"]["w"])


def test_in_place_step_after_async_save_does_not_leak(tmp_path):
    """The port's optimizers update tensors in place: a step run right
    after a non-blocking save must not reach the saved step. The
    writer thread is held until the step has run."""
    import threading
    t = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    b = torch.ones(3, dtype=torch.bfloat16)
    want_t, want_b = t.clone(), b.clone()
    mgr = _mgr(tmp_path)
    gate = threading.Event()
    real = mgr._write_step

    def held(*a, **k):
        gate.wait(30)
        return real(*a, **k)
    mgr._write_step = held
    mgr.save(5, {"params": {"l": {"w": t, "b": b}}}, blocking=False)
    t.mul_(float("nan"))           # the next step, in place
    b.add_(1)
    gate.set()
    mgr.wait()
    state, _ = mgr.restore()
    np.testing.assert_array_equal(state["params"]["l"]["w"], want_t.numpy())
    got_b = state["params"]["l"]["b"]
    assert got_b.dtype == np.uint16
    assert torch.equal(torch.from_numpy(got_b.view(np.int16)).view(
        torch.bfloat16), want_b)
    with open(tmp_path / "ckpt" / "5" / "manifest.json") as f:
        man = json.load(f)["leaves"]
    assert man["['params']['l']['b']"]["dtype"] == "bfloat16"
    assert man["['params']['l']['w']"]["dtype"] == "float32"


def test_orbax_and_multihost_steps_refused(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    os.makedirs(tmp_path / "ckpt" / "2" / "state")
    with pytest.raises(UnsupportedCheckpointFormat, match="orbax"):
        mgr.restore()
    # the multi-host format is read now: a multi-host manifest that
    # names no shard file is a corrupt step, not a format the port
    # refuses
    with open(tmp_path / "ckpt" / "1" / "manifest.json", "w") as f:
        json.dump({"version": 2, "format": "multihost"}, f)
    with pytest.raises(CheckpointCorruption, match="no shard files"):
        mgr.restore(step=1)
    with pytest.raises(ValueError, match="orbax is JAX-only"):
        CheckpointManager(str(tmp_path / "o"), writer="orbax")


# ======================================================================
# dataloader resumable state
# ======================================================================
def test_dataloader_state_roundtrip_mid_epoch():
    rng = np.random.default_rng(0)
    arrays = {"x": rng.normal(size=(64, 6)).astype(np.float32)}
    a = SingleDataLoader(dict(arrays), 8, shuffle=True, seed=3)
    a.reset()
    for _ in range(3):
        a.next_batch()
    sd = a.state_dict()
    # consumed batches, not the prefetched ones
    assert sd["idx"] == 3 and len(a._prefetched) == 2
    assert "order" not in sd
    sd = json.loads(json.dumps(sd))
    b = SingleDataLoader(dict(arrays), 8, shuffle=True, seed=999)
    b.reset()
    b.next_batch()
    b.load_state_dict(sd)
    assert len(b._prefetched) == 0   # a restore drops the prefetch
    for _ in range(5):
        np.testing.assert_array_equal(a.next_batch()["x"].numpy(),
                                      b.next_batch()["x"].numpy())
    assert a.next_batch() is None and b.next_batch() is None
    a.reset()
    b.reset()
    np.testing.assert_array_equal(a.next_batch()["x"].numpy(),
                                  b.next_batch()["x"].numpy())


def test_dataloader_state_matches_jax():
    """The same position in both packages' loaders gives the same
    state dict (so a loader position crosses packages too)."""
    from flexflow_tpu.runtime.dataloader import \
        SingleDataLoader as JaxLoader
    rng = np.random.default_rng(1)
    arrays = {"x": rng.normal(size=(40, 3)).astype(np.float32)}
    a = SingleDataLoader(dict(arrays), 8, shuffle=True, seed=5)
    j = JaxLoader(dict(arrays), 8, None, shuffle=True, seed=5)
    for ld in (a, j):
        ld.reset()
        ld.next_batch()
        ld.next_batch()
    assert json.loads(json.dumps(a.state_dict())) == \
        json.loads(json.dumps(j.state_dict()))


# ======================================================================
# supervisor end-to-end
# ======================================================================
def _mlp(pkg, **model_kw):
    cfg = pkg.FFConfig()
    cfg.batch_size = 64
    cfg.only_data_parallel = True
    cfg.seed = 7
    ff = pkg.FFModel(cfg, **model_kw)
    x = ff.create_tensor((cfg.batch_size, 20), name="x")
    t = ff.dense(x, 64, activation=pkg.ActiMode.AC_MODE_RELU)
    t = ff.dense(t, 4)
    ff.softmax(t)
    ff.compile(pkg.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
               [])
    return ff


_JAX_MLP = {}


def _jax_init():
    if "init" not in _JAX_MLP:
        jff = _mlp(ffj)
        _JAX_MLP["init"] = (jax.device_get(jff.params),
                            [(l.name, l.op_type) for l in jff.layers])
    return _JAX_MLP["init"]


def _build_mlp():
    """The port's MLP from the JAX model's initial weights."""
    ff = _mlp(fft, device="cpu")
    init, names = _jax_init()
    load_reference_params(ff, init, names)
    return ff


def _blobs():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(256, 20)).astype(np.float32)
    ys = rng.integers(0, 4, size=256).astype(np.int32)
    return xs, ys


def _params(ff):
    return {ln: {wn: t.detach().clone() for wn, t in ws.items()}
            for ln, ws in ff.params.items()}


def _assert_identical(a, b):
    assert a.keys() == b.keys()
    for ln in a:
        for wn in a[ln]:
            assert torch.equal(a[ln][wn], b[ln][wn]), (ln, wn)


_CLEAN = {}


def _clean_run(tmp_path):
    if "run" not in _CLEAN:
        ff = _build_mlp()
        hist = Supervisor(ff, str(tmp_path / "clean"),
                          checkpoint_every=1).run(*_blobs(), epochs=2)
        _CLEAN["run"] = (_params(ff), hist)
    return _CLEAN["run"]


def _jax_supervised(tmp_path, plan):
    """The JAX package's MLP from the same weights, supervised under the
    same plan: (final params, history, status snapshot)."""
    jax_status.reset()
    jax_faults.install(plan)
    jff = _mlp(ffj)
    init, _ = _jax_init()
    jff.params = jax.tree.map(
        lambda t, n: jax.device_put(n, t.sharding), jff.params, init)
    hist = JaxSupervisor(jff, str(tmp_path / "jax"),
                         checkpoint_every=1).run(*_blobs(), epochs=2)
    return jax.device_get(jff.params), hist, jax_status.snapshot()


_STATUS_KEYS = ("restarts", "nan_rollbacks", "faults_injected",
                "checkpoints_saved", "corrupt_checkpoints_skipped",
                "last_fault", "last_checkpoint_step")


@pytest.mark.parametrize("plan,restarts,rollbacks", [
    ("corrupt_ckpt@5;crash@5", 1, 0),
    ("nan@5", 1, 1)])
def test_supervised_faults_bit_exact_and_like_jax(tmp_path, plan,
                                                  restarts, rollbacks):
    """Crash + corrupt latest -> resume from the previous valid step;
    NaN -> rollback: both end bit-identical to the clean run, within
    1e-5 of the JAX package's supervised run, with its status counts."""
    clean, h0 = _clean_run(tmp_path)
    status.reset()
    faults.install(plan)
    ff = _build_mlp()
    sup = Supervisor(ff, str(tmp_path / "faulty"), checkpoint_every=1)
    h = sup.run(*_blobs(), epochs=2)
    assert (sup.restarts, sup.nan_rollbacks) == (restarts, rollbacks)
    _assert_identical(_params(ff), clean)
    if rollbacks == 0:
        assert status.snapshot()["corrupt_checkpoints_skipped"] >= 1
        assert h[-1]["loss"] == h0[-1]["loss"]
    port_status = status.snapshot()
    jp, jh, jstatus = _jax_supervised(tmp_path, plan)
    for ln, ws in ff.params.items():
        for wn, t in ws.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[ln][wn]),
                                       atol=ATOL, rtol=0)
    np.testing.assert_allclose(h[-1]["loss"], jh[-1]["loss"], atol=ATOL)
    assert {k: port_status[k] for k in _STATUS_KEYS} == \
        {k: jstatus[k] for k in _STATUS_KEYS}


def test_nan_rollback_writes_flight_record(tmp_path):
    faults.install("nan@3")
    ff = _build_mlp()
    Supervisor(ff, str(tmp_path / "nan"), checkpoint_every=1).run(
        *_blobs(), epochs=1)
    path = status.snapshot()["last_flight_record"]
    assert path == str(tmp_path / "ffcache" / "flight_rank0_epoch0.json")
    with open(path) as f:
        doc = json.load(f)
    assert doc["reason"] == "nan_rollback"
    assert doc["exception"].startswith("NonFiniteMetrics")


def test_nan_recurring_after_rollback_stops(tmp_path):
    """A non-finite loss that recurs at the same step after its
    rollback is a real divergence: the run stops instead of replaying."""
    ff = _build_mlp()
    real = ff._run_train_step

    def diverging(step_fn, batch):
        bm = real(step_fn, batch)
        if ff._step - 1 == 3:
            bm = dict(bm, all_finite=torch.tensor(False))
        return bm
    ff._run_train_step = diverging
    with pytest.raises(RestartBudgetExceeded, match="recurred"):
        Supervisor(ff, str(tmp_path / "div"), checkpoint_every=1).run(
            *_blobs(), epochs=1)


def test_auto_resume_across_supervisor_instances(tmp_path):
    clean, _ = _clean_run(tmp_path)
    faults.install("crash@6")
    ff = _build_mlp()
    sup = Supervisor(ff, str(tmp_path / "ck"), checkpoint_every=1,
                     max_restarts=0)
    with pytest.raises(RestartBudgetExceeded):
        sup.run(*_blobs(), epochs=2)
    assert ff._step == 6
    ff2 = _build_mlp()
    sup2 = Supervisor(ff2, str(tmp_path / "ck"), checkpoint_every=1)
    sup2.run(*_blobs(), epochs=2)
    assert sup2.restarts == 0
    _assert_identical(_params(ff2), clean)


def test_resume_at_epoch_tail_skips_empty_report(tmp_path):
    xs, ys = _blobs()
    ff = _build_mlp()
    loader = ff._combined_loader(xs, ys, None, shuffle=True)
    loader.reset()
    loader.epoch = 0
    while loader.next_batch() is not None:
        pass
    ff._step = loader.num_batches
    save_model_checkpoint(ff, str(tmp_path / "tail"),
                          extra_metadata={"loader": loader.state_dict()})
    ff2 = _build_mlp()
    h = run_supervised(ff2, str(tmp_path / "tail"), xs, ys, epochs=2,
                       checkpoint_every=1)
    assert len(h) == 1 and "loss" in h[0]


def test_restart_budget_bounds_retries(tmp_path):
    faults.install("crash@2;crash@3;crash@4")
    ff = _build_mlp()
    sup = Supervisor(ff, str(tmp_path / "budget"), checkpoint_every=1,
                     max_restarts=2, backoff_base_s=0.0)
    with pytest.raises(RestartBudgetExceeded):
        sup.run(*_blobs(), epochs=2)
    assert sup.restarts == 3


@pytest.mark.parametrize("elastic", [True, False])
def test_device_loss_refused_or_propagated(tmp_path, elastic):
    """``elastic=True`` needs the in-process re-plan onto fewer of the
    process's own devices, which waits for a mesh described larger than
    the world (item 4.1's leftover): it raises NotImplementedError and
    never restarts on the lost device; ``elastic=False`` lets the
    DeviceLoss propagate, as in JAX."""
    faults.install("lose_device@3:2")
    ff = _build_mlp()
    sup = Supervisor(ff, str(tmp_path / "lose"), checkpoint_every=1,
                     elastic=elastic)
    with pytest.raises(NotImplementedError if elastic else DeviceLoss,
                       match="item 4.1's leftover" if elastic
                       else "loss of 2"):
        sup.run(*_blobs(), epochs=2)
    assert sup.restarts == 0 and ff._step == 3


def test_infer_fault_counter_per_top_level_call_on_chunked_batch():
    """A chunked infer (rows > the largest bucket) advances the
    infer_fail@N counter once, as the JAX session's _infer_checked
    does: infer_fail@1 fails the SECOND top-level call, whatever the
    number of chunks of the first."""
    from flexflow_tpu_torch.serving import InferenceSession
    ff = _build_mlp()
    sess = InferenceSession(ff, batch_buckets=(4, 8))
    rng = np.random.default_rng(3)
    big = {"x": rng.normal(size=(20, 20)).astype(np.float32)}  # 3 chunks
    faults.install("infer_fail@1")
    first = sess.infer(big)
    with pytest.raises(faults.FaultError, match="call 1"):
        sess.infer(big)
    np.testing.assert_array_equal(sess.infer(big), first)
    assert first.shape == (20, 4)


def test_metric_help_and_types_match_jax(tmp_path):
    """Every metric both packages' registries hold after a supervised
    crash-and-corrupt run carries the same HELP text and TYPE."""
    from flexflow_tpu.obs.metrics_registry import REGISTRY as JAX_REGISTRY
    from flexflow_tpu_torch.obs.metrics_registry import REGISTRY
    plan = "corrupt_ckpt@2;crash@2;nan@3"
    faults.install(plan)
    Supervisor(_build_mlp(), str(tmp_path / "p"), checkpoint_every=1,
               backoff_base_s=0.0).run(*_blobs(), epochs=1)
    _jax_supervised(tmp_path, plan)

    def heads(reg):
        out = {}
        for ln in reg.render().splitlines():
            if ln.startswith("# "):
                _, kind, name, rest = (ln.split(" ", 3) + [""])[:4]
                out[(name, kind)] = rest
        return out

    port, ref = heads(REGISTRY), heads(JAX_REGISTRY)
    shared = set(port) & set(ref)
    names = {n for n, _ in shared}
    assert {"ff_checkpoint_saves_total", "ff_checkpoint_last_step",
            "ff_resilience_restarts_total",
            "ff_checkpoint_corrupt_skipped_total",
            "ff_train_samples_per_sec", "ff_flight_records_total",
            "ff_time_since_last_checkpoint_seconds",
            "ff_model_compiles_total"} <= names
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
