"""The port's quantized gradient collectives
(``ops/quantized_collectives.py``) against the JAX package's.

Quantization (int8, e4m3, e5m2): payloads and scales equal to the JAX
package's on the same inputs, exact on representable ones, within half
a step (int8) or the format's rounding (fp8) otherwise. One world of four
gloo ranks (``tests/_torch_world.py``, mesh (2, 2)) runs
``quantized_all_reduce`` over x0 (two ranks) and over both axes (four)
and ``phased_sync`` over staged phases, each against the JAX functions
in ``shard_map`` on the same rows: equal except where an input lies
within one f32 ulp of a rounding tie, and there off by one quantization
step; the error-feedback mass (the outputs plus every rank's residual
against the inputs plus the residuals carried in, in f64) conserved to
the f32 rounding of the reduction's adds. The same world trains BERT-tiny
under ``--quantized-collectives all`` (int8): its loss history tracks the
full-precision dp-4 run within the JAX test's bound (5% or 2e-3), and
composes bit-equal with the overlap schedule; gradient accumulation falls
back to the full-precision sync; a plan imported with the strategy is
honored, and stripped by ``--no-quantized-collectives``. On four ranks
the overlap schedule (and ZeRO under it) is held to the serial dp-4 step
within 1e-6 (gloo's four-rank sum may add in another order). The plan
(``plan_qsync`` in off / all / auto / dcn_only, ``quantized_sync_quote``)
equals the JAX package's on the same described machine.
"""
import json

import numpy as np
import pytest

import flexflow_tpu as ffj
from flexflow_tpu.ops import quantized_collectives as jq
from flexflow_tpu.parallel import placement as jplacement
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.ops import quantized_collectives as tq

from _torch_sync import DP, jax_run, payload_of
from _torch_world import run_world

WIRES = ("int8", "float8_e4m3", "float8_e5m2")
N = 3000
RNG = np.random.default_rng(11)
QX = RNG.normal(size=(4, N)).astype(np.float32)
QRES = (RNG.normal(size=(4, N)) * 1e-2).astype(np.float32)
GROUPS = [("x0",), ("x0", "x1")]
PHASES = [("flat_q", [(("x0", "x1"), "int8")]),
          ("flat_fp", [(("x0", "x1"), None)]),
          ("outer_q", [(("x1",), None), (("x0",), "int8")]),
          ("both_q", [(("x1",), "float8_e4m3"), (("x0",), "int8")])]
M4 = DP + ["--mesh-shape", "2x2"]
QALL = ["--quantized-collectives", "all"]
OV = ["--overlap-schedule", "on", "--overlap-bucket-mb", "0.05"]
RUNS = [("dp", M4, "adam", "bert"), ("qsync", M4 + QALL, "adam", "bert"),
        ("qsync_ov", M4 + QALL + OV, "adam", "bert"),
        ("qsync_acc", M4 + QALL + ["--gradient-accumulation-steps", "2"],
         "adam", "transformer"),
        ("ov", M4 + OV, "adam", "bert"),
        ("ovz", M4 + OV + ["--zero"], "adam", "bert"),
        ("zero", M4 + ["--zero"], "adam", "bert")]
_CACHE = {}


def _world():
    if "world" not in _CACHE:
        bert = jax_run("bert", (), "adam", devices=4, what="init")
        t = jax_run("transformer", (), "adam", devices=4, what="init")
        _CACHE["world"] = run_world("sync", 4, {
            "bert": payload_of(bert), "transformer": payload_of(t),
            "batch": 8, "seq": 16, "runs": RUNS, "groups": GROUPS,
            "phases": PHASES, "qx": QX, "qres": QRES,
            "imports": [("honored", "qsync", ["--mesh-shape", "2x2"],
                         "qsync"),
                        ("disabled", "qsync", ["--mesh-shape", "2x2",
                                               "--no-quantized-collectives"],
                         "qsync")]})
    return _CACHE["world"]


def _jax_collectives():
    """The JAX package's results on the same rows (row r = rank r of the
    (2, 2) mesh), once."""
    if "jax" in _CACHE:
        return _CACHE["jax"]
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from flexflow_tpu.utils.jax_compat import shard_map
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x0", "x1"))
    sizes = {"x0": 2, "x1": 2}
    spec = P(("x0", "x1"))

    def run(body):
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                              out_specs=spec, check_vma=False))
        return tuple(np.asarray(a) for a in f(jnp.asarray(QX),
                                              jnp.asarray(QRES)))

    out = {"qar": {}, "phased": {}}
    for axes in GROUPS:
        d = int(np.prod([sizes[a] for a in axes]))
        for wire in WIRES:
            def body(xl, rl, axes=axes, wire=wire, d=d):
                o, r = jq.quantized_all_reduce(xl[0], axes, wire, d, sizes,
                                               residual=rl[0])
                return o[None], r[None]
            out["qar"][(axes, wire)] = run(body)
    for key, phases in PHASES:
        def body(xl, rl, phases=phases):
            o, r = jq.phased_sync(xl[0], phases, sizes, residual=rl[0])
            return o[None], r[None]
        out["phased"][key] = run(body)
    _CACHE["jax"] = out
    return out


def _step(value, wire):
    """One quantization step at ``value`` for a chunk scaled by
    ``scale``-free terms: int8 steps are the chunk's amax / 127 (passed
    in), fp8 steps the format's spacing at the value."""
    import torch
    if wire == "int8":
        return value
    dt = {"float8_e4m3": torch.float8_e4m3fn,
          "float8_e5m2": torch.float8_e5m2}[wire]
    mant = 3 if wire == "float8_e4m3" else 2
    return np.maximum(np.abs(value) * 2.0 ** -mant,
                      float(torch.finfo(dt).tiny) * 2.0 ** -mant)


def _chunk_steps(out, wire, scale_of):
    """Per-element size of one quantization step of a result ``out``
    (rows of dequantized values in chunks of QSYNC_CHUNK)."""
    flat = np.asarray(out, np.float64).reshape(out.shape[0], -1)
    n = flat.shape[1]
    pad = (-n) % tq.QSYNC_CHUNK
    chunks = np.pad(np.abs(flat), ((0, 0), (0, pad))).reshape(
        flat.shape[0], -1, tq.QSYNC_CHUNK)
    amax = chunks.max(axis=-1, keepdims=True)
    if wire == "int8":
        step = np.broadcast_to(amax / 127.0, chunks.shape)
    else:
        fmax = 448.0 if wire == "float8_e4m3" else 57344.0
        step = _step(chunks / np.maximum(amax, 1e-30) * fmax, wire) \
            * amax / fmax
    return step.reshape(flat.shape[0], -1)[:, :n] * scale_of


def _tie_equal(got, want, wire, scale=1.0, mag=None, steps=None):
    """Equal to f32 rounding (four ulps: XLA folds the scale's division
    by the format's maximum into a multiplication by its reciprocal, so
    a scale may sit an ulp from the port's, and each dequantized term of
    a sum carries it), except at elements off by
    one quantization step, which must be few: where an input lies within
    an f32 ulp of a rounding tie the two packages may round it apart.
    ``mag``: the magnitude the ulps are of (``want`` by default);
    ``steps``: the quantization steps (those of ``want`` by default)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    close = diff <= 4 * np.finfo(np.float32).eps * np.abs(
        want if mag is None else mag) + 1e-30
    step = _chunk_steps(want, wire, scale) if steps is None else steps
    assert (close | (diff <= step * (1 + 1e-4))).all(), \
        float((diff - step).max())
    assert np.count_nonzero(~close) <= max(2, diff.size // 500), \
        np.count_nonzero(~close)


@pytest.mark.parametrize("wire", WIRES)
def test_quantize_chunked_matches_jax(wire):
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 1024)).astype(np.float32)
    if wire == "int8":
        exact = rng.integers(-127, 128, size=(4, 1024)).astype(np.float32)
        exact[:, 0] = 127.0
    else:
        # values the format holds, scaled so each chunk's amax is its max
        fmax = 448.0 if wire == "float8_e4m3" else 57344.0
        dt = torch.float8_e4m3fn if wire == "float8_e4m3" \
            else torch.float8_e5m2
        exact = torch.from_numpy(rng.normal(size=(4, 1024)).astype(
            np.float32) * fmax / 8).to(dt).float().numpy()
        exact[:, 0] = fmax
    for arr in (x, exact):
        qj, sj = jq.quantize_chunked(jnp.asarray(arr), wire)
        qt, st = tq.quantize_chunked(torch.from_numpy(arr), wire)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(qt.float().numpy(),
                                      np.asarray(qj.astype(jnp.float32)))
        deq = tq.dequantize_chunked(qt, st).numpy()
        np.testing.assert_array_equal(
            deq, np.asarray(jq.dequantize_chunked(qj, sj)))
    np.testing.assert_array_equal(
        tq.dequantize_chunked(*tq.quantize_chunked(
            torch.from_numpy(exact), wire)).numpy(), exact)
    q, s = tq.quantize_chunked(torch.from_numpy(x), wire)
    err = np.abs(tq.dequantize_chunked(q, s).numpy() - x)
    bound = s.numpy() * 0.5 + 1e-7 if wire == "int8" \
        else np.abs(x) * 2.0 ** -(4 if wire == "float8_e4m3" else 3) \
        + s.numpy() * 2.0 ** -9
    assert (err <= bound).all()


def test_modes_wires_and_refit_match_jax(monkeypatch):
    for env in (None, "off", "all", "disable", "1"):
        for mode in ("off", "auto", "all", "dcn_only", "disable", "yes"):
            if env is None:
                monkeypatch.delenv("FF_QUANTIZED_COLLECTIVES",
                                   raising=False)
            else:
                monkeypatch.setenv("FF_QUANTIZED_COLLECTIVES", env)
            cfg = fft.FFConfig()
            cfg.quantized_collectives = mode
            assert tq.resolve_qsync_mode(cfg) == jq.resolve_qsync_mode(cfg)
            assert tq.qsync_disabled(cfg) == jq.qsync_disabled(cfg)
    monkeypatch.delenv("FF_QUANTIZED_COLLECTIVES", raising=False)
    for wire in WIRES:
        monkeypatch.setenv("FF_QSYNC_WIRE", wire)
        assert tq.resolve_qsync_wire(None) == jq.resolve_qsync_wire(None)
        assert tq.wire_byte_scale(wire) == jplacement.wire_byte_scale(wire)
    assert (tq.QSYNC_CHUNK, tq.WIRE_ITEMSIZE) == \
        (jplacement.QSYNC_CHUNK, jplacement.WIRE_ITEMSIZE)
    r = np.random.default_rng(3).normal(size=(8, 5, 3)).astype(np.float32)
    for d in (4, 8, 3, 16):
        got = tq.refit_residual(r if d != 16 else r[:4], d)
        np.testing.assert_array_equal(
            got, jq.refit_residual(r if d != 16 else r[:4], d))
        np.testing.assert_allclose(
            got.sum(axis=0, dtype=np.float64),
            (r if d != 16 else r[:4]).sum(axis=0, dtype=np.float64),
            atol=1e-5)


def _planning_inputs(pkg, spec):
    cfg = pkg.FFConfig()
    if pkg is fft:
        cfg.device = "cpu"
    ff = pkg.FFModel(cfg)
    from importlib import import_module
    models = import_module(pkg.__name__ + ".models")
    out = models.build_mlp(ff, 16, in_dim=32, hidden=(256, 256),
                           num_classes=8)
    machine = import_module(pkg.__name__ + ".parallel.machine")
    strategy = import_module(pkg.__name__ + ".parallel.strategy")
    cost = import_module(pkg.__name__ + ".search.costmodel")
    dm = machine.DeviceMesh(spec(machine.MachineSpec))
    st = strategy.ShardingStrategy.data_parallel(ff.layers,
                                                 ff.input_tensors, dm)
    return ff, dm, st, cost.OpCostModel(dm.spec), out


def _near(got, want):
    """Equal structures, floats within 1e-9 relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _near(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _near(a, b)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-9)
    else:
        assert got == want


def _eight(MachineSpec):
    return MachineSpec(num_devices=8, generation="cpu-sim")


def _two_slice(MachineSpec):
    s = MachineSpec(num_devices=8, generation="cpu-sim")
    s.num_slices, s.num_hosts = 2, 2
    s.dcn_bandwidth_gbps, s.dcn_latency_us = 1.0, 20.0
    return s


@pytest.mark.parametrize("machine", [_eight, _two_slice])
@pytest.mark.parametrize("mode", ["off", "all", "auto", "dcn_only"])
def test_plan_qsync_matches_jax(machine, mode):
    jff, jdm, jst, jcm, _ = _planning_inputs(ffj, machine)
    tff, tdm, tst, tcm, _ = _planning_inputs(fft, machine)
    assert tq._tier_phases(tdm, tst) == jq._tier_phases(jdm, jst)
    plans = []
    for q, ff, dm, st, cm in ((jq, jff, jdm, jst, jcm),
                              (tq, tff, tdm, tst, tcm)):
        cm.attach_quantization(mode if mode != "off" else None, "int8")
        plan = q.plan_qsync(st, ff.layers, dm, cm, mode=mode, wire="int8")
        pos = {l.name: i for i, l in enumerate(ff.layers)}
        plans.append(None if plan is None else {
            pos[ln]: ws for ln, ws in plan.to_json()["decisions"].items()})
    _near(plans[1], plans[0])
    if mode == "all":
        assert plans[1]
    skel = tq._tier_phases(tdm, tst)
    for nbytes in (64.0, 4096.0, float(1 << 20), float(1 << 24)):
        for q_mode in ("auto", "all", "dcn_only"):
            jcm.attach_quantization(q_mode, "int8")
            tcm.attach_quantization(q_mode, "int8")
            want = jcm.quantized_sync_quote(nbytes, 8, skel)
            got = tcm.quantized_sync_quote(nbytes, 8, skel)
            _near(got, want)


def test_plan_json_round_trips_through_strategy_files(tmp_path):
    from flexflow_tpu_torch.parallel.machine import DeviceMesh, MachineSpec
    from flexflow_tpu_torch.parallel.strategy import ShardingStrategy
    from flexflow_tpu_torch.search.serialization import (load_strategy,
                                                         save_strategy)
    plan = tq.QsyncPlan({"d": {"kernel": {
        "wire": "int8", "phases": [{"axes": ["x0"], "tier": "ici",
                                    "wire": "int8"}],
        "baseline_s": 1e-3, "quantized_s": 4e-4}}}, mode="all")
    dm = DeviceMesh(MachineSpec(num_devices=2, generation="cpu-sim"))
    s = ShardingStrategy(dm)
    s.qsync = plan
    s.overlap = {"enabled": True, "bucket_bytes": 9, "zero_prefetch": 0,
                 "buckets": [{"order": 0, "members": ["d"], "nbytes": 9}]}
    save_strategy(str(tmp_path / "q.json"), s)
    doc = json.load(open(tmp_path / "q.json"))
    # the JAX package reads the same block into the same plan
    assert jq.QsyncPlan.from_json(doc["qsync"]).to_json() == plan.to_json()
    back = load_strategy(str(tmp_path / "q.json"), [], dm)
    assert isinstance(back.qsync, tq.QsyncPlan)
    assert back.qsync.to_json() == plan.to_json()
    assert back.overlap == s.overlap
    assert tq.audit_record(plan) == jq.audit_record(
        jq.QsyncPlan.from_json(plan.to_json()))


@pytest.mark.parametrize("axes", GROUPS)
@pytest.mark.parametrize("wire", WIRES)
def test_quantized_all_reduce_matches_jax(axes, wire):
    ranks = _world()
    j_out, j_res = _jax_collectives()["qar"][(axes, wire)]
    got = np.stack([r["qar"][(axes, wire)][0] for r in ranks])
    res = np.stack([r["qar"][(axes, wire)][1] for r in ranks])
    _tie_equal(got, j_out, wire)
    # the residual takes what the output withheld: equal to JAX's to the
    # ulps of what it is made of, and within one step where a tie
    # rounded apart
    _tie_equal(res, j_res, wire, mag=np.abs(QX) + np.abs(QRES)
               + np.abs(j_out), steps=_chunk_steps(j_out, wire, 1.0))
    # mass over each reduction group: ranks (0, 2) and (1, 3) over x0,
    # all four over both axes
    groups = [[0, 2], [1, 3]] if axes == ("x0",) else [[0, 1, 2, 3]]
    for g in groups:
        x = (QX[g].astype(np.float64) + QRES[g]).sum(axis=0)
        m = got[g[0]].astype(np.float64) + res[g].astype(np.float64).sum(0)
        # f32 rounding of the reduce leg's adds, one ulp a term
        tol = len(g) * np.finfo(np.float32).eps * (
            np.abs(QX[g]).sum(axis=0) + np.abs(QRES[g]).sum(axis=0)) * 2
        assert (np.abs(m - x) <= tol + 1e-12).all(), \
            float(np.abs(m - x).max())
        assert all(np.array_equal(got[g[0]], got[k]) for k in g)


@pytest.mark.parametrize("key", [k for k, _ in PHASES])
def test_phased_sync_matches_jax(key):
    ranks = _world()
    j_out, j_res = _jax_collectives()["phased"][key]
    got = np.stack([r["phased"][key][0] for r in ranks])
    phases = dict(PHASES)[key]
    if not any(w for _, w in phases):
        np.testing.assert_allclose(got, j_out, rtol=1e-6, atol=1e-7)
        assert all(r["phased"][key][1] is not None for r in ranks)
        return
    wire = next(w for _, w in phases[::-1] if w)
    # a mean over four ranks: the steps are a quarter of the sum's
    _tie_equal(got, j_out, wire)
    res = np.stack([r["phased"][key][1] for r in ranks])
    np.testing.assert_allclose(res, j_res, atol=float(
        _chunk_steps(j_out, wire, 4.0).max()) + 1e-6)
    # mass: 4 x the mean plus the residuals is the inputs' sum
    x = (QX.astype(np.float64) + QRES).sum(axis=0)
    m = 4 * got[0].astype(np.float64) + res.astype(np.float64).sum(0)
    assert np.abs(m - x).max() <= 1e-5 * np.abs(QX).max() * 4


def test_int8_training_tracks_full_precision_and_composes_with_overlap():
    for rank in _world():
        r = rank["runs"]
        lq, lb = r["qsync"]["losses"], r["dp"]["losses"]
        assert r["qsync"]["qsync"] and r["qsync"]["plan"]
        assert lq[0] == pytest.approx(lb[0], rel=1e-6)   # pre-update
        for a, b in zip(lq, lb):
            assert abs(a - b) <= max(abs(b) * 0.05, 2e-3), (lq, lb)
        assert lq != lb            # the wire really was int8
        assert r["qsync"]["residual_abs"] > 0
        # overlap is schedule shaping on the synced gradients
        assert r["qsync_ov"]["losses"] == lq
        assert r["qsync_ov"]["adam_per_step"] == \
            len(r["qsync_ov"]["overlap"]["buckets"])
        assert r["qsync"]["adam_per_step"] == 1
        # 4 collectives a tensor (payload and scales, two legs) at about
        # a quarter of the f32 bytes plus the padding of small tensors
        assert r["qsync"]["sync_bytes"] < 0.6 * r["dp"]["sync_bytes"]


def test_runtime_falls_back_on_accumulation():
    r = _world()[0]["runs"]["qsync_acc"]
    assert r["plan"] and not r["qsync"]
    assert "residual_abs" not in r


def test_imported_plan_honored_and_explicit_disable_strips_it():
    imp = _world()[0]["imports"]
    plan = _world()[0]["runs"]["qsync"]["plan"]
    assert imp["honored"]["plan"] and imp["honored"]["qsync"]
    assert imp["honored"]["plan_layers"] == sorted(plan["decisions"])
    assert not imp["disabled"]["plan"] and not imp["disabled"]["qsync"]
    assert np.isfinite(imp["disabled"]["loss"])


@pytest.mark.parametrize("name", ["ov", "ovz", "zero"])
def test_four_rank_overlap_and_zero_track_the_serial_step(name):
    """Four ranks: gloo may add the four partial sums in another order
    than DTensor's all-reduce, so the runs agree to 1e-6, not bit for
    bit."""
    for rank in _world():
        r = rank["runs"]
        np.testing.assert_allclose(r[name]["losses"], r["dp"]["losses"],
                                   atol=1e-6, rtol=0)
        for ln, ws in r["dp"]["weights"].items():
            for wn, w in ws.items():
                np.testing.assert_allclose(r[name]["weights"][ln][wn], w,
                                           atol=1e-6, rtol=0)


def test_plan_records_its_span_counters_and_series():
    """``plan_qsync`` records the ``qsync.plan`` span and the
    ``ff_qsync_*`` series; an ineligible runtime counts
    ``qsync.runtime_fallbacks``, as in the JAX package."""
    import types
    from flexflow_tpu_torch.obs import events
    from flexflow_tpu_torch.obs.metrics_registry import REGISTRY
    was = events.enabled()
    events.enable()
    try:
        before = REGISTRY.counter("ff_qsync_plans_total").value(mode="all")
        fb = events.counters().get("qsync.runtime_fallbacks", 0)
        tff, tdm, tst, tcm, _ = _planning_inputs(fft, _eight)
        tcm.attach_quantization("all", "int8")
        plan = tq.plan_qsync(tst, tff.layers, tdm, tcm, mode="all")
        names = [e.get("name") for e in events.snapshot()["events"]]
        assert "qsync.plan" in names
        assert REGISTRY.counter("ff_qsync_plans_total").value(
            mode="all") == before + 1
        assert REGISTRY.gauge("ff_qsync_quantized_params").value() == \
            len(plan.quantized_params())
        tst.qsync = plan
        cfg = types.SimpleNamespace(gradient_accumulation_steps=2)
        assert tq.runtime_schedule(None, tst, cfg, tdm) is None
        assert events.counters()["qsync.runtime_fallbacks"] == fb + 1
    finally:
        if not was:
            events.disable()
