"""The port's serving search (``search/serving_plan.py``), the serving half of
its plan verifier (``analysis/plan_verifier.py``) and the plan sessions
(``serving/session.py``) against the JAX package's.

The same small GPT-2 graph (``_torch_graphs.gpt2``: vocab 512, hidden 64,
2 layers, 16 positions) goes through both packages' search on a described
1-device and 8-device machine: per bucket the adopted assignment is the
same and every predicted cost agrees to 1e-9 relative (the search parity
of the training search). A plan file written by either package loads in
the other (``load_strategy``, ``bucket_strategy_doc``, the verifier), and
the verifier's findings on broken plans are the same text.
``optimize_strategy(mode="serving")`` reads the ``serving_*`` config
fields as the JAX package does. A plan session loaded through the
repository's loader compiles each bucket's model from its sub-strategy
(imported on one device too, where the JAX package drops the file) and
serves the plain session's outputs, with the floor guard measuring on
request, skipping on the CPU under "auto", and skipping only a model
with no KV decode path.
"""
import copy
import json
import math
import os
import sys

import numpy as np
import pytest

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.analysis import plan_verifier as jpv
from flexflow_tpu.parallel.machine import DeviceMesh as JMesh
from flexflow_tpu.parallel.machine import MachineSpec as JSpec
from flexflow_tpu.search import serialization as jser
from flexflow_tpu.search import serving_plan as jsp
from flexflow_tpu.search.costmodel import OpCostModel as JCost
from flexflow_tpu_torch.analysis import plan_verifier as tpv
from flexflow_tpu_torch.parallel.machine import DeviceMesh as TMesh
from flexflow_tpu_torch.parallel.machine import MachineSpec as TSpec
from flexflow_tpu_torch.search import serialization as tser
from flexflow_tpu_torch.search import serving_plan as tsp
from flexflow_tpu_torch.search.costmodel import OpCostModel as TCost

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_graphs as graphs  # noqa: E402

REL = 1e-9
SEQ = 16
BUCKETS = (1, 4, 8)


def _meshes(n):
    return JMesh(JSpec(num_devices=n)), TMesh(TSpec(num_devices=n))


def _close(a, b, path=""):
    """Documents equal, floats to REL relative."""
    if isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=REL, abs_tol=1e-300), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("n", [1, 8])
def test_per_bucket_search_matches_jax(n, tmp_path):
    jff, tff = graphs.gpt2(batch=8, seq=SEQ)
    jm, tm = _meshes(n)
    jcm = JCost(jm.spec, cache_dir=str(tmp_path))
    tcm = TCost(tm.spec, cache_dir=str(tmp_path))
    for bucket in BUCKETS:
        ja, jc, jev = jsp.search_serving_assignment(
            jff.layers, jm, jcm, bucket, SEQ, budget=40, seed=0)
        ta, tc, tev = tsp.search_serving_assignment(
            tff.layers, tm, tcm, bucket, SEQ, budget=40, seed=0)
        assert ta == ja, bucket
        for f in ("total", "prefill", "decode_step", "decode_compute",
                  "decode_comm"):
            assert math.isclose(getattr(tc, f), getattr(jc, f),
                                rel_tol=REL), (bucket, f)
        assert (tc.kv_bytes, tc.peak_memory) == (jc.kv_bytes,
                                                 jc.peak_memory)
        assert tev.kv_plan(ta) == jev.kv_plan(ja)
        base_j = jev.evaluate(jsp.serving_baseline_assignment(
            jff.layers, jm, jev))
        base_t = tev.evaluate(tsp.serving_baseline_assignment(
            tff.layers, tm, tev))
        assert math.isclose(base_t.total, base_j.total, rel_tol=REL)
        assert tc.total <= base_t.total * (1 + REL)


def _plan(sp, ff, mesh, cm, path):
    """optimize_serving_strategy on an uncompiled graph pointed at a
    described mesh (what compile would set), exporting to ``path``."""
    ff.dmesh = mesh
    ff.graph_inputs = list(ff.input_tensors)
    ff._search_cost_model = cm
    ff.config.export_strategy_file = str(path)
    return sp.optimize_serving_strategy(ff, buckets=BUCKETS, budget=40)


@pytest.fixture(scope="module")
def plan_files(tmp_path_factory):
    from flexflow_tpu.obs import audit as jaudit
    tmp = tmp_path_factory.mktemp("plans")
    jff, tff = graphs.gpt2(batch=8, seq=SEQ)
    jm, tm = _meshes(8)
    # a traced run writes serving audits: never into the JAX package's
    # shared .ffcache/
    saved, jaudit._DEFAULT_DIR = jaudit._DEFAULT_DIR, str(tmp)
    try:
        jplan = _plan(jsp, jff, jm, JCost(jm.spec, cache_dir=str(tmp)),
                      tmp / "jax.json")
    finally:
        jaudit._DEFAULT_DIR = saved
    tplan = _plan(tsp, tff, tm, TCost(tm.spec, cache_dir=str(tmp)),
                  tmp / "port.json")
    return {"jax": (jff, jm, jplan, tmp / "jax.json"),
            "port": (tff, tm, tplan, tmp / "port.json")}


def test_plan_files_match_and_load_both_ways(plan_files):
    jff, jm, jplan, jpath = plan_files["jax"]
    tff, tm, tplan, tpath = plan_files["port"]
    jdoc, tdoc = json.load(open(jpath)), json.load(open(tpath))
    _close(tdoc, jdoc)
    assert sorted(tdoc["serving"]["buckets"]) == ["1", "4", "8"]
    assert tplan.largest.bucket == 8
    for path, doc in ((jpath, jdoc), (tpath, tdoc)):
        # either file in either package: the strategy with its serving
        # block, each bucket's standalone document, the verifier
        st_t = tser.load_strategy(str(path), tff.layers, tm)
        st_j = jser.load_strategy(str(path), jff.layers, jm)
        assert st_t.serving == st_j.serving == doc["serving"]
        assert set(st_t.ops) == set(st_j.ops)
        for b in BUCKETS:
            assert tsp.bucket_strategy_doc(doc, b) == \
                jsp.bucket_strategy_doc(doc, b)
        assert tpv.verify_serving_plan(doc["serving"], tff.layers,
                                       tm).ok()
        assert jpv.verify_serving_plan(doc["serving"], jff.layers,
                                       jm).ok()
    with pytest.raises(KeyError):
        tsp.bucket_strategy_doc(tdoc, 2)
    with pytest.raises(ValueError):
        tsp.bucket_strategy_doc({"mesh_axes": {}}, 1)


def _broken(block, how):
    b = copy.deepcopy(block)
    kv = next(iter(b["buckets"]["8"]["kv"].values()))
    if how == "shard":
        kv["shard_degree"] = 3
    elif how == "bytes":
        kv["bytes"] = int(kv["bytes"]) + 1
    elif how == "seq":
        kv["seq_shard_degree"] = 2
    elif how == "no-seq":
        b["max_seq"] = 0
    return b


@pytest.mark.parametrize("how", ["shard", "bytes", "seq", "no-seq",
                                 "envelope"])
def test_verifier_findings_match(plan_files, how):
    jff, jm, jplan, _ = plan_files["jax"]
    tff, tm, tplan, _ = plan_files["port"]
    block = tplan.to_block()
    hbm = 1024 if how == "envelope" else None
    if how != "envelope":
        block = _broken(block, how)
    msgs = {}
    for name, pv, ff, mesh in (("jax", jpv, jff, jm),
                               ("port", tpv, tff, tm)):
        with pytest.raises(pv.PlanVerificationError) as ei:
            pv.verify_serving_plan(block, ff.layers, mesh, hbm_bytes=hbm,
                                   context="test")
        msgs[name] = [f.format() for f in ei.value.findings]
    assert msgs["port"] == msgs["jax"] and msgs["port"]


def _compiled(pkg, **cfg_kw):
    cfg = pkg.FFConfig()
    cfg.batch_size = 4
    cfg.only_data_parallel = True
    cfg.use_bf16_compute = False
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    kw = {"device": "cpu"} if pkg is fft else {}
    ff = pkg.FFModel(cfg, **kw)
    m = pkg.models
    g = m.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=4, max_position=SEQ, dropout=0.0)
    out = m.build_gpt2(ff, 4, SEQ, g)
    ff.compile(pkg.SGDOptimizer(0.0), "identity", [], output_tensor=out)
    return ff


def test_optimize_strategy_serving_mode_reads_config(tmp_path,
                                                     monkeypatch):
    import flexflow_tpu.models  # noqa: F401
    from flexflow_tpu.obs import audit as jaudit
    import flexflow_tpu_torch.models  # noqa: F401
    from flexflow_tpu.search.optimizer import optimize_strategy as jopt
    from flexflow_tpu_torch.search.optimizer import optimize_strategy as topt
    got = {}
    for name, pkg, opt, cost in (("jax", ffj, jopt, JCost),
                                 ("port", fft, topt, TCost)):
        monkeypatch.setenv("FF_CACHE_DIR", str(tmp_path))
        monkeypatch.setattr(jaudit, "_DEFAULT_DIR", str(tmp_path))
        ff = _compiled(pkg, serving_buckets="2,1", serving_max_seq=8,
                       serving_decode_tokens=4, search_budget=10)
        # a cost model of its own: nothing measured, no shared cache
        ff._search_cost_model = cost(ff.dmesh.spec,
                                     cache_dir=str(tmp_path / name))
        st, info = opt(ff, mode="serving")
        plan = ff._serving_plan
        assert info is None and st is plan.largest.strategy
        got[name] = (sorted(plan.buckets), plan.max_seq,
                     plan.decode_tokens,
                     {b: p.kv for b, p in plan.buckets.items()})
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ([1, 2], 8, 4)


@pytest.fixture(scope="module")
def port_plan(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_plan")
    ff = _compiled(fft, serving_buckets="1,4",
                   export_strategy_file=str(tmp / "plan.json"))
    ff.config.search_budget = 10
    ff._search_cost_model = TCost(ff.dmesh.spec, cache_dir=str(tmp))
    from flexflow_tpu_torch.search.optimizer import optimize_strategy
    optimize_strategy(ff, mode="serving")
    return ff, str(tmp / "plan.json")


def _gpt_loader_config(**kw):
    cfg = fft.FFConfig()
    cfg.batch_size = 4
    cfg.device = "cpu"
    cfg.use_bf16_compute = False
    for k, v in kw.items():
        setattr(cfg, k, v)
    g = fft.models.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                             num_heads=4, max_position=SEQ, dropout=0.0)
    return cfg, (lambda ff: fft.models.build_gpt2(ff, 4, SEQ, g))


@pytest.mark.parametrize("guard", ["auto", "true"])
def test_plan_session_serves_the_plain_outputs(port_plan, guard):
    from flexflow_tpu_torch.serving import (InferenceSession,
                                            ModelRepository)
    from flexflow_tpu_torch.serving.session import ServingPlanSession
    ff, path = port_plan
    cfg, graph = _gpt_loader_config(serving_floor_guard=guard)
    built = []

    def weights(f2):              # the plain session's weights
        built.append(f2)
        f2.params = ff.params

    # the repository's own loader: one model per bucket, each compiled
    # from its bucket's sub-strategy of the plan file
    ps = ModelRepository()._load_with_builder(
        "gpt", graph, (1, 4), cfg, None, 1, post_compile=weights,
        serving_strategy_file=path)
    assert isinstance(ps, ServingPlanSession) and ps.buckets == [1, 4]
    searched, base = built[:2], built[2:]
    for b, f2 in zip((1, 4), searched):
        # the import reached the model on this one device
        assert list(f2.strategy.serving["buckets"]) == [str(b)]
    if guard == "auto":           # the CPU: no guard, no baseline build
        assert ps.floor_guard == {} and not base
        assert [ps.session_for(b).ff for b in (1, 4)] == searched
    else:
        assert sorted(ps.floor_guard) == [1, 4] and len(base) == 1
        assert getattr(base[0].strategy, "serving", None) is None
        for b, f2 in zip((1, 4), searched):
            rec = ps.floor_guard[b]
            assert rec["adopted"] in ("searched", "baseline")
            assert rec["searched_s"] > 0 and rec["baseline_s"] > 0
            want = f2 if rec["adopted"] == "searched" else base[0]
            assert ps.session_for(b).ff is want
        assert set(ps.measured_profile()) == {"1", "4"}
    plain = InferenceSession(ff, (1, 4), decode_segment=4)
    rng = np.random.default_rng(5)
    for rows in (1, 3):
        ids = np.zeros((rows, SEQ), np.int32)
        ids[:, :4] = rng.integers(1, 64, (rows, 4))
        np.testing.assert_array_equal(
            ps.generate(ids, 4, 6, eos_token_id=9),
            plain.generate(ids, 4, 6, eos_token_id=9))
        batch = {"input_ids": ids, "position_ids": np.tile(
            np.arange(SEQ, dtype=np.int32), (rows, 1))}
        np.testing.assert_array_equal(ps.infer(batch), plain.infer(batch))
    assert ps.clone().session_for(3).ff is ps.session_for(3).ff


def test_import_strategy_file_is_honored_on_one_device(port_plan, tmp_path):
    # one device and no search budget: the JAX package compiles plain
    # data parallelism and drops the file; the port imports it
    _, path = port_plan
    sub = tmp_path / "bucket4.json"
    sub.write_text(json.dumps(tsp.bucket_strategy_doc(
        json.load(open(path)), 4)))
    ff = _compiled(fft, only_data_parallel=False,
                   import_strategy_file=str(sub))
    assert ff.dmesh.num_devices == 1 and ff.config.search_budget <= 0
    assert list(ff.strategy.serving["buckets"]) == ["4"]
    assert set(ff.strategy.ops) == set(json.load(open(sub))["ops"])


def test_floor_guard_skips_only_a_model_without_a_decode_path(port_plan):
    from flexflow_tpu_torch.serving import InferenceSession
    from flexflow_tpu_torch.serving.session import (
        build_serving_plan_session)
    _, path = port_plan

    def mlp(sf, buckets=(1, 4)):
        cfg = fft.FFConfig()
        cfg.batch_size, cfg.device = 4, "cpu"
        cfg.only_data_parallel = True
        f = fft.FFModel(cfg)
        out = f.dense(f.create_tensor((4, 8), name="x"), 2)
        f.compile(fft.SGDOptimizer(0.0), "identity", [], output_tensor=out)
        return InferenceSession(f, buckets)

    ps = build_serving_plan_session(path, mlp, floor_guard="true")
    assert list(ps.floor_guard) == ["skipped"]
    assert "NoDecodePath" in ps.floor_guard["skipped"]

    def broken(sf, buckets=(1, 4)):
        if sf is None:            # the baseline's build hits the device
            raise RuntimeError("CUDA error: an illegal memory access")
        return mlp(sf, buckets)

    with pytest.raises(RuntimeError, match="illegal memory access"):
        build_serving_plan_session(path, broken, floor_guard="true")


def test_min_decode_latency_reads_decode_measured(port_plan):
    from flexflow_tpu_torch.serving.session import _min_decode_latency
    ff, _ = port_plan
    ff._decode_measured = {2: {"prefill_s": 1.0, "decode_step_s": 1.0,
                               "n": 5}}
    t = _min_decode_latency(ff, 2, reps=2)
    rec = ff._decode_measured[2]
    # the warm-up and both timed calls join the earlier record
    assert 0 < t < 1.0
    assert rec["n"] == 5 + 1 + 2 and rec["decode_step_s"] <= t


def test_repository_adopts_plan_and_hot_swaps(port_plan):
    from flexflow_tpu_torch.serving import (BatchScheduler,
                                            InferenceSession,
                                            ModelRepository)
    from flexflow_tpu_torch.serving.session import ServingPlanSession
    _, path = port_plan
    m = fft.models
    g = m.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=4, max_position=SEQ, dropout=0.0)
    cfg = fft.FFConfig()
    cfg.batch_size = 4
    cfg.device = "cpu"
    cfg.serving_floor_guard = "false"
    repo = ModelRepository()
    sess = repo._load_with_builder(
        "gpt", lambda ff: m.build_gpt2(ff, 4, SEQ, g), (1, 4), cfg, None,
        2, serving_strategy_file=path)
    assert isinstance(sess, ServingPlanSession)
    assert len(repo.get_instances("gpt")) == 2
    assert sess.ff.device.type == "cpu"
    sched = BatchScheduler(repo.get_instances("gpt"), max_batch=4)
    try:
        new = InferenceSession(sess.ff, (4,))
        repo.hot_swap("gpt", new, scheduler=sched, deadline_s=5.0)
        assert repo.get("gpt") is new and sched.sessions == [new]
    finally:
        sched.close()
    with pytest.raises(KeyError):
        repo.hot_swap("nope", new)
