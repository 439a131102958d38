"""The port's telemetry (flexflow_tpu_torch/obs, utils/logger.py,
utils/profiling.py) against the JAX package's (tests/test_obs.py): the
span ring buffer, the Prometheus exposition (byte-identical to the JAX
registry's after the same operations), the Chrome trace export (equal,
as JSON, to the JAX exporter's for the same event list), the executor's
compile/steady step spans, the spans and metrics of compile, fit and
generate, the end-of-training rank dump, the strategy-audit record, the
profiler summary and the FF_LOG logger."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as fft
from flexflow_tpu.obs import metrics_registry as jax_metrics_registry
from flexflow_tpu.obs import trace_export as jax_trace_export
from flexflow_tpu_torch.obs import events
from flexflow_tpu_torch.obs.metrics_registry import (REGISTRY,
                                                     MetricsRegistry)
from flexflow_tpu_torch.obs.trace_export import (export_chrome_trace,
                                                 to_chrome_trace)


@pytest.fixture
def traced():
    """Tracing on with a fresh buffer; restores the prior enabled state
    after."""
    was_enabled = events.enabled()
    events.enable(capacity=events.DEFAULT_CAPACITY)
    events.clear()
    try:
        yield events
    finally:
        if not was_enabled:
            events.disable()
        events.clear()


# ----------------------------------------------------------------------
# events: spans, counters, ring buffer
# ----------------------------------------------------------------------

def test_span_nesting(traced):
    with events.span("outer", depth=0):
        time.sleep(0.002)
        with events.span("inner"):
            time.sleep(0.002)
    evs = {e["name"]: e for e in events.events()}
    assert set(evs) == {"outer", "inner"}
    o, i = evs["outer"], evs["inner"]
    assert i["ts"] >= o["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-9
    assert o["attrs"] == {"depth": 0}
    assert o["tid"] == threading.get_ident()


def test_ring_buffer_wraparound():
    was_enabled = events.enabled()
    events.enable(capacity=8)
    events.clear()
    before = REGISTRY.counter("ff_trace_events_dropped_total").value()
    try:
        for k in range(12):
            with events.span(f"s{k}"):
                pass
        evs = events.events()
        assert len(evs) == 8
        assert [e["name"] for e in evs] == [f"s{k}" for k in range(4, 12)]
        assert events.dropped() == 4
        assert REGISTRY.counter("ff_trace_events_dropped_total").value() \
            == before + 4
    finally:
        events.enable(capacity=events.DEFAULT_CAPACITY)
        if not was_enabled:
            events.disable()
        events.clear()


def test_counters_and_instants(traced):
    events.counter("x")
    events.counter("x", 2)
    events.instant("tick", why="test")
    assert events.counters() == {"x": 3}
    inst = [e for e in events.events() if e["kind"] == "instant"]
    assert len(inst) == 1 and inst[0]["name"] == "tick"
    assert inst[0]["attrs"] == {"why": "test"}
    snap = events.snapshot(max_events=0)
    assert snap["events"] == [] and snap["counters"] == {"x": 3}


def test_disabled_mode_is_noop():
    was_enabled = events.enabled()
    events.disable()
    events.clear()
    try:
        events.counter("never")
        events.instant("never")
        with events.span("never"):
            pass
        events.record_span("never", 0.0, 1.0)
        assert events.events() == []
        assert events.counters() == {}
        s = events.span("straddle")
        s.__enter__()
        events.enable()
        s.__exit__(None, None, None)
        assert all(e["name"] != "straddle" for e in events.events())
    finally:
        if was_enabled:
            events.enable()
        else:
            events.disable()
        events.clear()


def test_threaded_recording(traced):
    def worker(k):
        for j in range(50):
            with events.span(f"w{k}"):
                events.counter("work")

    ts = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert events.counters()["work"] == 200
    assert len(events.events()) == 200


def test_configure_follows_the_jax_rules(monkeypatch):
    was_enabled = events.enabled()
    try:
        cfg = fft.FFConfig()
        cfg.trace = "false"
        events.enable()
        events.configure(cfg)
        assert not events.enabled()
        cfg.trace = "auto"
        events.configure(cfg)
        assert not events.enabled()       # "auto" leaves it alone
        cfg.trace_export_file = "x.json"  # an export implies tracing
        events.configure(cfg)
        assert events.enabled()
        # attribution is not ported: asked for, it raises
        monkeypatch.setenv("FF_ATTRIB", "1")
        with pytest.raises(NotImplementedError, match="item 6"):
            events.configure(fft.FFConfig())
        cfg = fft.FFConfig()
        cfg.attribution = "false"
        events.configure(cfg)             # config "false" wins
    finally:
        if was_enabled:
            events.enable()
        else:
            events.disable()


# ----------------------------------------------------------------------
# metrics registry: Prometheus exposition, byte-identical to JAX's
# ----------------------------------------------------------------------

def _golden_ops(reg):
    reg.counter("ff_requests_total", "Requests").inc(model="m")
    reg.counter("ff_requests_total").inc(2, model="n")
    reg.gauge("ff_queue_depth", "Queue depth").set(3, model="m")
    h = reg.histogram("ff_lat", "Latency", buckets=(0.01, 0.1))
    h.observe(0.005, model="m")
    h.observe(0.05, model="m")
    h.observe(7.0, model="m")
    reg.gauge("ff_odd", 'odd "values"').set(float("nan"), k='a"b\\c\nd')
    reg.gauge("ff_odd").set(float("inf"), k="inf")
    reg.gauge("ff_odd").set(0.125, k="frac")
    reg.histogram("ff_decode_step_seconds", "Per-token decode-step",
                  buckets=jax_metrics_registry.DECODE_STEP_BUCKETS
                  ).observe(3e-4, bucket="8")


def test_prometheus_exposition_golden_and_like_jax():
    reg = MetricsRegistry()
    jreg = jax_metrics_registry.MetricsRegistry()
    _golden_ops(reg)
    _golden_ops(jreg)
    golden_head = """\
# HELP ff_requests_total Requests
# TYPE ff_requests_total counter
ff_requests_total{model="m"} 1
ff_requests_total{model="n"} 2
# HELP ff_queue_depth Queue depth
# TYPE ff_queue_depth gauge
ff_queue_depth{model="m"} 3
# HELP ff_lat Latency
# TYPE ff_lat histogram
ff_lat_bucket{model="m",le="0.01"} 1
ff_lat_bucket{model="m",le="0.1"} 2
ff_lat_bucket{model="m",le="+Inf"} 3
ff_lat_sum{model="m"} 7.055
ff_lat_count{model="m"} 3
"""
    text = reg.render()
    assert text.startswith(golden_head)
    assert text.encode() == jreg.render().encode()


def test_prometheus_help_escaping_golden_and_like_jax():
    golden = """\
# HELP ff_esc path C:\\\\x "quoted"\\nline two
# TYPE ff_esc counter
ff_esc 1
"""
    for mod in (MetricsRegistry, jax_metrics_registry.MetricsRegistry):
        reg = mod()
        reg.counter("ff_esc", 'path C:\\x "quoted"\nline two').inc()
        assert reg.render() == golden


def test_registry_kind_and_bucket_conflicts():
    reg = MetricsRegistry()
    reg.counter("dup", "c")
    with pytest.raises(TypeError):
        reg.gauge("dup")
    reg.histogram("h", buckets=(1.0, 2.0))
    with pytest.raises(ValueError, match="buckets"):
        reg.histogram("h", buckets=(1.0,))


def test_metric_constants_match_jax():
    from flexflow_tpu_torch.obs import metrics_registry as mr
    assert mr.DEFAULT_BUCKETS == jax_metrics_registry.DEFAULT_BUCKETS
    assert mr.DECODE_STEP_BUCKETS == \
        jax_metrics_registry.DECODE_STEP_BUCKETS


# ----------------------------------------------------------------------
# Chrome trace export: the JAX exporter's document for the same events
# ----------------------------------------------------------------------

def _event_list():
    tid_a, tid_b = 11, 22
    return [
        {"name": "phase_a", "kind": "span", "ts": 10.0, "dur": 0.5,
         "tid": tid_a, "attrs": {"k": 1}},
        {"name": "request.queue", "kind": "span", "ts": 10.1, "dur": 0.1,
         "tid": tid_b, "attrs": {"trace": "t1", "model": "m"}},
        {"name": "phase_b", "kind": "span", "ts": 10.5, "dur": 0.25,
         "tid": tid_a, "attrs": None},
        {"name": "request.response", "kind": "span", "ts": 10.3,
         "dur": 0.2, "tid": tid_a, "attrs": {"trace": "t1"}},
        {"name": "marker", "kind": "instant", "ts": 10.6, "dur": 0.0,
         "tid": tid_b, "attrs": None},
    ]


def test_chrome_trace_equals_the_jax_exporters(traced):
    evts = _event_list()
    counters = {"c": 4, "executor.train_steps": 3}
    for kw in ({}, {"process_name": "rank 1", "sort_index": 3,
                    "base": 9.0}):
        got = to_chrome_trace(evts, counters, pid=77, **kw)
        want = jax_trace_export.to_chrome_trace(evts, counters, pid=77,
                                                **kw)
        assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    flows = [e for e in got["traceEvents"] if e.get("cat") == "request"]
    assert [e["ph"] for e in flows] == ["s", "f"]


def test_chrome_trace_export_golden(tmp_path, traced):
    events.record_span("phase_a", 10.0, 0.5, k=1)
    events.record_span("phase_b", 10.5, 0.25)
    events.instant("marker")
    events.counter("c", 4)
    path = export_chrome_trace(str(tmp_path / "trace.json"))
    doc = json.load(open(path))
    pid = os.getpid()
    te = [e for e in doc["traceEvents"] if e["ph"] in ("X", "i")]
    assert te[0]["name"] == "phase_a" and te[0]["ph"] == "X"
    assert te[0]["ts"] == 0.0 and te[0]["dur"] == 500000.0
    assert te[0]["pid"] == pid and te[0]["args"] == {"k": 1}
    assert te[1]["name"] == "phase_b" and te[1]["ts"] == 500000.0 \
        and te[1]["dur"] == 250000.0
    assert te[2]["ph"] == "i" and te[2]["s"] == "t"
    metas = {e["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert {"process_name", "thread_name"} <= metas
    cs = [e for e in doc["traceEvents"] if e["ph"] == "C"]
    assert [(e["name"], e["args"]["value"]) for e in cs] == [("c", 4)]
    assert doc["otherData"]["counters"] == {"c": 4}
    assert doc["displayTimeUnit"] == "ms"
    assert to_chrome_trace() == doc


def test_rank_and_serving_dumps(tmp_path, traced):
    from flexflow_tpu_torch.obs.trace_export import (dump_rank_trace,
                                                     dump_serving_trace)
    events.record_span("s", 1.0, 0.5)
    p = dump_rank_trace(cache_dir=str(tmp_path))
    assert p == str(tmp_path / "trace_rank0_epoch0.json")
    doc = json.load(open(p))
    assert (doc["rank"], doc["world_size"], doc["schema"]) == (0, 1, 1)
    assert [e["name"] for e in doc["events"]] == ["s"]
    doc = json.load(open(dump_serving_trace(cache_dir=str(tmp_path))))
    assert doc["role"] == "serving"


def _mlp_layers(pkg, device_kw, hidden):
    from importlib import import_module
    build_mlp = import_module(f"{pkg.__name__}.models.misc").build_mlp
    cfg = pkg.FFConfig()
    cfg.batch_size = 16
    ff = pkg.FFModel(cfg, **device_kw)
    build_mlp(ff, 16, in_dim=32, hidden=hidden, num_classes=8)
    return ff.layers


def test_audit_workload_key_and_record_like_jax(tmp_path, monkeypatch):
    """The strategy-audit record: the same graph keys alike in both
    packages (a different graph does not), and the write / annotate /
    load round trip gives the JAX package's document, in a cache
    directory of the test's own (never the shared ``.ffcache``)."""
    import flexflow_tpu as ffj
    from flexflow_tpu.obs import audit as jax_audit
    from flexflow_tpu_torch.obs import audit
    monkeypatch.setattr(audit, "_DEFAULT_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jax_audit, "_DEFAULT_DIR", str(tmp_path / "jax"))
    layers = _mlp_layers(fft, {"device": "cpu"}, (64,))
    key = audit.workload_key(layers, 1)
    assert key == jax_audit.workload_key(_mlp_layers(ffj, {}, (64,)), 1)
    assert key != audit.workload_key(layers, 4)
    assert key != audit.workload_key(
        _mlp_layers(fft, {"device": "cpu"}, (64, 64)), 1)
    entries = [{"op": "op_linear_0", "fwd_s": 1e-3, "bwd_s": 2e-3,
                "xfer_s": 5e-4, "sync_s": 0.0},
               {"op": "op_linear_1", "fwd_s": 4e-4, "bwd_s": 8e-4,
                "sync_s": 1e-4}]
    side = audit.side_record(entries, 4.8e-3)
    assert side == jax_audit.side_record(entries, 4.8e-3)
    record = {"adopted": side, "dp_baseline": side, "model": "mlp"}
    docs = []
    for mod in (audit, jax_audit):
        path = mod.write_strategy_audit(record, key)
        assert path == str(tmp_path / ("port" if mod is audit else "jax")
                           / f"strategy_audit_{key}.json")
        mod.annotate_strategy_audit(path, {"measured": {"dp_s": 0.5}})
        doc = mod.load_strategy_audit(path)
        assert doc.pop("written_unix_s") > 0
        docs.append(doc)
    assert docs[0] == docs[1]
    assert docs[0]["workload_key"] == key and docs[0]["schema"] == 1
    assert docs[0]["measured"] == {"dp_s": 0.5}
    # best-effort: an unwritable directory and a missing record raise
    # nothing
    assert audit.write_strategy_audit(
        record, key, cache_dir=str(tmp_path / "port" / f"strategy_audit_"
                                   f"{key}.json")) is None
    audit.annotate_strategy_audit(str(tmp_path / "missing.json"), {"a": 1})


def test_fit_dumps_the_rank_ring_only_under_ff_trace_dump(tmp_path,
                                                          monkeypatch,
                                                          traced):
    """The end-of-training rank dump (``_end_of_training_telemetry``):
    one process writes it only under FF_TRACE_DUMP=1, strictly after
    the last step, with every step's span in it."""
    from flexflow_tpu_torch.obs import trace_export
    monkeypatch.setattr(trace_export, "_DEFAULT_DIR", str(tmp_path))
    dump = tmp_path / "trace_rank0_epoch0.json"
    ff, batch = _tiny_mlp()
    x = np.concatenate([batch["input"]] * 2)
    y = np.concatenate([batch["label"]] * 2)
    monkeypatch.delenv("FF_TRACE_DUMP", raising=False)
    ff.fit(x, y, epochs=1, verbose=False)
    assert not dump.exists()
    monkeypatch.setenv("FF_TRACE_DUMP", "1")
    ff.fit(x, y, epochs=1, verbose=False)
    doc = json.load(open(dump))
    assert (doc["rank"], doc["world_size"], doc["world_epoch"]) == (0, 1, 0)
    names = [e["name"] for e in doc["events"]]
    assert names.count("executor.train_step") == 4
    assert names.count("fit.epoch") == 2
    assert names[-1] == "fit.epoch"


# ----------------------------------------------------------------------
# executor, compile, fit and generate wiring
# ----------------------------------------------------------------------

def _tiny_mlp(**cfg_kw):
    from flexflow_tpu_torch.models import build_mlp
    cfg = fft.FFConfig()
    cfg.batch_size = 16
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    ff = fft.FFModel(cfg, device="cpu")
    out = build_mlp(ff, 16, in_dim=32, hidden=(64,), num_classes=8)
    ff.compile(fft.SGDOptimizer(0.01), "sparse_categorical_crossentropy",
               [], output_tensor=out)
    rng = np.random.default_rng(0)
    batch = {"input": rng.normal(size=(16, 32)).astype(np.float32),
             "label": rng.integers(0, 8, size=(16, 1)).astype(np.int32)}
    return ff, batch


def test_executor_step_spans_compile_vs_steady(traced):
    before = REGISTRY.counter("ff_model_compiles_total").value(
        model="<unnamed>")
    ff, batch = _tiny_mlp()
    assert REGISTRY.counter("ff_model_compiles_total").value(
        model="<unnamed>") == before + 1
    step = ff.executor.make_train_step()
    for _ in range(3):
        ff._run_train_step(step, batch)
    spans = [e for e in events.events()
             if e["name"] == "executor.train_step"]
    assert len(spans) == 3
    assert [s["attrs"]["phase"] for s in spans] == \
        ["compile", "steady", "steady"]
    assert [s["attrs"]["step"] for s in spans] == [0, 1, 2]
    assert events.counters()["executor.train_steps"] == 3
    comp = [e for e in events.events() if e["name"] == "model.compile"]
    assert len(comp) == 1 and comp[0]["attrs"]["n_devices"] == 1
    assert callable(step.__wrapped__)
    fwd = ff.executor.make_forward()
    fwd(ff.params, ff.state, {"input": batch["input"]})
    assert events.counters()["executor.forward_steps"] == 1


def test_trace_sync_span(traced, monkeypatch):
    monkeypatch.setenv("FF_TRACE_SYNC", "1")
    ff, batch = _tiny_mlp()
    ff._run_train_step(ff.executor.make_train_step(), batch)
    assert [e["attrs"]["phase"] for e in events.events()
            if e["name"] == "executor.train_step"] == ["compile"]


def test_disabled_wrapper_calls_through():
    was_enabled = events.enabled()
    events.disable()
    try:
        ff, batch = _tiny_mlp()
        step = ff.executor.make_train_step()
        bm = ff._run_train_step(step, batch)
        assert np.isfinite(float(bm["loss"]))
        assert events.events() == []
    finally:
        if was_enabled:
            events.enable()


def test_fit_records_epochs_gauge_and_exports(tmp_path):
    was_enabled = events.enabled()
    events.clear()
    try:
        path = str(tmp_path / "fit_trace.json")
        ff, batch = _tiny_mlp(trace_export_file=path)
        assert events.enabled()
        x = np.concatenate([batch["input"]] * 2)
        y = np.concatenate([batch["label"]] * 2)
        hist = ff.fit(x, y, epochs=2, verbose=False)
        assert ff._metrics_buffer is None
        doc = json.load(open(path))
        names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
        assert names.count("fit.epoch") == 2
        assert names.count("executor.train_step") == 4
        assert "model.compile" in names
        assert REGISTRY.gauge("ff_train_samples_per_sec").value() == \
            hist[-1]["samples_per_sec"] > 0
    finally:
        if not was_enabled:
            events.disable()
        events.clear()


def test_generate_spans_and_histograms(traced):
    from flexflow_tpu_torch.models import GPTConfig, build_gpt2
    cfg = fft.FFConfig()
    cfg.batch_size = 2
    ff = fft.FFModel(cfg, device="cpu")
    g = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                  max_position=16)
    build_gpt2(ff, 2, 16, g)
    ff.compile(fft.SGDOptimizer(0.01), "sparse_categorical_crossentropy",
               [])
    from flexflow_tpu_torch.obs.metrics_registry import \
        DECODE_STEP_BUCKETS
    hist = REGISTRY.histogram("ff_decode_step_seconds",
                              buckets=DECODE_STEP_BUCKETS)
    before = hist.count(bucket="2")
    ids = np.random.default_rng(0).integers(0, 64, (2, 16)).astype(
        np.int32)
    from flexflow_tpu_torch.obs import request_trace
    with request_trace.activate(request_trace.RequestTrace("tr1", "m")):
        ff.generate(ids, 4, 3)
    spans = {e["name"]: e for e in events.events()
             if e["name"].startswith("generate.")}
    assert spans["generate.prefill"]["attrs"] == {"batch": 2, "seq": 16,
                                                  "trace": "tr1"}
    assert spans["generate.decode"]["attrs"]["tokens"] == 3
    assert hist.count(bucket="2") == before + 1
    assert REGISTRY.histogram("ff_prefill_seconds",
                              buckets=DECODE_STEP_BUCKETS).count(
        bucket="2") >= 1
    # a KV attempt that fails falls back and is counted
    fb = REGISTRY.counter("ff_kv_fallback_total")
    n0 = fb.value(model="<unnamed>")

    def broken(*a, **k):
        raise RuntimeError("no cache")
    ff.executor.kv_prefill = broken
    ff.generate(ids, 4, 2)
    assert fb.value(model="<unnamed>") == n0 + 1


# ----------------------------------------------------------------------
# profiler summary, FF_LOG parsing, logger
# ----------------------------------------------------------------------

def test_profiler_summary_p90_max_and_single_step():
    from flexflow_tpu.utils.profiling import Profiler as JaxProfiler
    from flexflow_tpu_torch.utils.profiling import Profiler
    p = Profiler()
    for _ in range(4):
        with p.step():
            time.sleep(0.003)
    s = p.summary()
    assert set(s) == set(JaxProfiler().summary())
    assert s["max_step_s"] >= s["p90_step_s"] >= s["p50_step_s"] > 0
    p1 = Profiler()
    with p1.step():
        time.sleep(0.003)
    s1 = p1.summary()
    assert s1["compile_s"] >= 0.003
    assert s1["mean_step_s"] == 0.0 and s1["max_step_s"] == 0.0
    assert REGISTRY.gauge("ff_profiler_compile_s").value(
        profiler="default") >= 0.003


def test_profile_region_writes_a_chrome_trace(tmp_path):
    from flexflow_tpu_torch.utils import profile_region, sync
    with profile_region("region", str(tmp_path)):
        x = torch.ones(64, 64) @ torch.ones(64, 64)
    sync({"x": [x]})   # no CUDA tensor: nothing to wait for
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("region.")
    doc = json.load(open(tmp_path / files[0]))
    assert any(e.get("name") == "region" for e in doc["traceEvents"])


def test_ff_log_env_parsing_like_jax():
    from flexflow_tpu.utils.logger import parse_ff_log as jax_parse
    from flexflow_tpu_torch.utils.logger import parse_ff_log
    for text in ("dp=2,sim=1,xfers=0", " dp = 2 , bogus, =3, x=y ", ""):
        assert parse_ff_log(text) == jax_parse(text)
    assert parse_ff_log("dp=2,sim=1,xfers=0") == \
        {"dp": 2, "sim": 1, "xfers": 0}


def test_recursive_logger_thread_safety(capsys):
    from flexflow_tpu_torch.utils.logger import (RecursiveLogger,
                                                 set_log_level)
    set_log_level("obs_t", 2)
    log = RecursiveLogger("obs_t")

    def worker():
        for _ in range(20):
            with log.enter("o"):
                log.log("i")

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    lines = capsys.readouterr().err.strip().splitlines()
    assert len(lines) == 4 * 20 * 2
    assert set(lines) == {"[obs_t] o", "[obs_t]   i"}
