"""The port's strategy search (``search/unity.py``, ``search/mcmc.py``,
``search/optimizer.py``, ``search/serialization.py``) against the JAX
package's.

On described 8-device machines (``machine_configs/slow-fabric-8.json``
and a plain single-slice spec), Unity and MCMC (seed 0) adopt the same
predicted cost (1e-9 relative) and export the same strategy JSON, apart
from the names of the layers the search inserts (``op_<type>_<id>``,
numbered per process) and the cost field. The JAX package's final
ranker is its task-graph simulator unless ``FF_FINAL_RANKER=additive``;
the port ranks with the additive evaluator (the simulator is not
ported), so the JAX runs here set that variable. Strategy files cross
packages both ways, the shipped ``strategies/*.json`` load in the port,
and a one-device ``compile(search_budget=4)`` trains to the JAX
package's searched compile's loss history (f32, 1e-5).
"""
import json
import math
import os
import re
import sys

import jax
import numpy as np
import pytest

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.obs import audit as jaudit
from flexflow_tpu.obs import events as jevents
from flexflow_tpu.parallel.machine import DeviceMesh as JMesh
from flexflow_tpu.parallel.machine import MachineSpec as JSpec
from flexflow_tpu.parallel.topology import load_machine_file as jload_file
from flexflow_tpu.search import mcmc as jmcmc
from flexflow_tpu.search import serialization as jser
from flexflow_tpu.search import unity as junity
from flexflow_tpu.search.costmodel import OpCostModel as JCost
from flexflow_tpu_torch.interop import load_reference_params
from flexflow_tpu_torch.obs import audit as taudit
from flexflow_tpu_torch.obs import events as tevents
from flexflow_tpu_torch.parallel.machine import DeviceMesh as TMesh
from flexflow_tpu_torch.parallel.machine import MachineSpec as TSpec
from flexflow_tpu_torch.parallel.topology import \
    load_machine_file as tload_file
from flexflow_tpu_torch.search import mcmc as tmcmc
from flexflow_tpu_torch.search import serialization as tser
from flexflow_tpu_torch.search import unity as tunity
from flexflow_tpu_torch.search.costmodel import OpCostModel as TCost

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_graphs as graphs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOW = os.path.join(ROOT, "machine_configs", "slow-fabric-8.json")
REL = 1e-9


def _machines(kind):
    """(JAX mesh, port mesh) of one described 8-device machine."""
    if kind == "slow-fabric-8":
        js, ts = jload_file(SLOW), tload_file(SLOW)
        shape = tuple(js.ici_shape)
    else:
        js, ts = JSpec(num_devices=8), TSpec(num_devices=8)
        shape = None
    return JMesh(js, mesh_shape=shape), TMesh(ts, mesh_shape=shape)


_GENERATED = re.compile(r"\bop_[a-z_]+?_\d+(?:__\d+)?\b")


def _names_canon(doc):
    """The strategy document with the search-inserted layers' generated
    names replaced by their order of creation (their numbers): each
    package counts layers per process, so the numbers, and how names
    sort as strings, depend on the tests that ran before."""
    text = json.dumps(doc, sort_keys=True)
    names = sorted(set(_GENERATED.findall(text)),
                   key=lambda n: [int(x) for x in re.findall(r"\d+", n)])
    canon = {n: f"gen{i}" for i, n in enumerate(names)}
    return json.loads(_GENERATED.sub(lambda m: canon[m.group(0)], text))


def _docs_equal(jdoc, tdoc, cost_key):
    jc, tc = jdoc["meta"].pop(cost_key), tdoc["meta"].pop(cost_key)
    assert math.isclose(jc, tc, rel_tol=REL)
    assert _names_canon(tdoc) == _names_canon(jdoc)


def _inputs(ff):
    return ff.graph_inputs + getattr(ff, "const_inputs", []) \
        if ff.graph_inputs else ff.input_tensors


@pytest.mark.parametrize("graph", ["bert", "mlp"])
@pytest.mark.parametrize("machine", ["slow-fabric-8", "single-slice-8"])
def test_unity_adopts_the_same_strategy(graph, machine, tmp_path,
                                        monkeypatch):
    monkeypatch.setenv("FF_FINAL_RANKER", "additive")
    jff, tff = {"bert": graphs.bert, "mlp": graphs.mlp}[graph]()
    jm, tm = _machines(machine)
    res = {}
    for tag, ff, mesh, unity, cost, ser in (
            ("jax", jff, jm, junity, JCost, jser),
            ("port", tff, tm, tunity, TCost, tser)):
        inputs = _inputs(ff)
        out = [ff.layers[-1].outputs[0]]
        info, st, gc, g = unity.unity_search(
            ff.layers, inputs, out, mesh, cost(mesh.spec,
                                               cache_dir=str(tmp_path)),
            budget=4, alpha=1.05, base_optimize_threshold=12)
        path = tmp_path / f"{tag}.json"
        ser.save_strategy(str(path), st, None, {"best_cost": gc.total},
                          program=ser.program_to_json(
                              info.layers, inputs, info.output_tensors[0]))
        res[tag] = (gc, json.loads(path.read_text()), info)
    jgc, jdoc, jinfo = res["jax"]
    tgc, tdoc, tinfo = res["port"]
    for f in ("total", "compute", "xfer", "sync"):
        assert math.isclose(getattr(tgc, f), getattr(jgc, f),
                            rel_tol=REL, abs_tol=1e-30), f
    assert tgc.peak_memory == jgc.peak_memory
    assert math.isclose(tinfo.dp_predicted_total, jinfo.dp_predicted_total,
                        rel_tol=REL)
    _docs_equal(jdoc, tdoc, "best_cost")


@pytest.mark.parametrize("graph", ["bert", "dlrm"])
@pytest.mark.parametrize("machine", ["slow-fabric-8", "single-slice-8"])
def test_mcmc_adopts_the_same_strategy(graph, machine, tmp_path):
    jff, tff = {"bert": graphs.bert, "dlrm": graphs.dlrm}[graph]()
    jm, tm = _machines(machine)
    res = {}
    for tag, ff, mesh, mc, cost, ser in (
            ("jax", jff, jm, jmcmc, JCost, jser),
            ("port", tff, tm, tmcmc, TCost, tser)):
        best, best_cost, sim = mc.mcmc_search(
            ff.layers, mesh, cost(mesh.spec, cache_dir=str(tmp_path)),
            budget=120, alpha=0.05, seed=0)
        st = mc.assignment_to_strategy(ff.layers, _inputs(ff), best, mesh,
                                       sim)
        dp = mc.data_parallel_assignment(ff.layers, mesh, sim.options)
        path = tmp_path / f"{tag}.json"
        ser.save_strategy(str(path), st, best,
                          {"best_cost": best_cost,
                           "dp_cost": sim.evaluate(dp).total})
        res[tag] = (best, best_cost, json.loads(path.read_text()))
    assert res["port"][0] == res["jax"][0]
    assert math.isclose(res["port"][1], res["jax"][1], rel_tol=REL)
    jdoc, tdoc = res["jax"][2], res["port"][2]
    assert math.isclose(jdoc["meta"].pop("dp_cost"),
                        tdoc["meta"].pop("dp_cost"), rel_tol=REL)
    _docs_equal(jdoc, tdoc, "best_cost")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_strategy_files_cross_packages(writer, tmp_path):
    jff, tff = graphs.bert()
    jm, tm = _machines("single-slice-8")
    src = (jff, jm, jmcmc, jser) if writer == "jax" else \
        (tff, tm, tmcmc, tser)
    ff, mesh, mc, ser = src
    best, cost_, sim = mc.mcmc_search(
        ff.layers, mesh, (JCost if writer == "jax" else TCost)(
            mesh.spec, cache_dir=str(tmp_path)), budget=60, seed=1)
    st = mc.assignment_to_strategy(ff.layers, _inputs(ff), best, mesh, sim)
    st.kernel_impls = {ff.layers[5].name: "flash"}
    path = str(tmp_path / "s.json")
    ser.save_strategy(path, st, best, {"best_cost": cost_})
    legacy = str(tmp_path / "s.txt")
    ser.save_legacy_strategies(legacy, st, ff.layers)
    for ser2, ff2, mesh2 in ((jser, jff, jm), (tser, tff, tm)):
        back = ser2.load_strategy(path, ff2.layers, mesh2)
        assert {k: [tuple(s) if s is not None else None
                    for s in v.outputs] for k, v in back.ops.items()} == \
            {k: [tuple(s) if s is not None else None for s in v.outputs]
             for k, v in st.ops.items()}
        assert {k: {w: tuple(s) for w, s in v.weights.items()}
                for k, v in back.ops.items()} == \
            {k: {w: tuple(s) for w, s in v.weights.items()}
             for k, v in st.ops.items()}
        assert dict(back.kernel_impls) == dict(st.kernel_impls)
        assert {k: tuple(v) for k, v in back.inputs.items()} == \
            {k: tuple(v) for k, v in st.inputs.items()}
        text = ser2.load_legacy_strategies(legacy, ff2.layers, mesh2)
        assert {k: tuple(v.outputs[0]) for k, v in text.ops.items()} == \
            {k: tuple(v.outputs[0]) for k, v in
             jser.load_legacy_strategies(legacy, jff.layers, jm).ops.items()}
    # the port writes what the JAX package writes, byte for byte
    j2, t2 = str(tmp_path / "j2.json"), str(tmp_path / "t2.json")
    jser.save_strategy(j2, jser.load_strategy(path, jff.layers, jm), best,
                       {"best_cost": cost_})
    tser.save_strategy(t2, tser.load_strategy(path, tff.layers, tm), best,
                       {"best_cost": cost_})
    assert open(j2).read() == open(t2).read()


@pytest.mark.parametrize("name", sorted(
    os.listdir(os.path.join(ROOT, "strategies"))))
def test_shipped_strategies_load_in_the_port(name, tmp_path):
    path = os.path.join(ROOT, "strategies", name)
    doc = json.load(open(path))
    axes = doc["mesh_axes"]
    n = math.prod(axes.values())
    spec = TSpec(num_devices=n, num_slices=axes.get("dcn", 1),
                 num_hosts=axes.get("dcn", 1))
    mesh = TMesh(spec)
    assert mesh.axis_sizes == axes and mesh.described
    st = tser.load_strategy(path, [], mesh)
    assert st.validate() == []
    assert set(st.ops) == set(doc["ops"])
    out = str(tmp_path / "again.json")
    tser.save_strategy(out, st, doc.get("assignment"), doc.get("meta"),
                       program=doc.get("program"))
    again = json.load(open(out))
    want = json.loads(json.dumps(doc))
    for b in want.get("banks", ()):
        # banks load as BankSpecs and are written in the JAX package's
        # schema, which names the padded flag
        b.setdefault("padded", False)
    assert again == want
    jst = jser.load_strategy(path, [], JMesh(JSpec(
        num_devices=n, num_slices=axes.get("dcn", 1),
        num_hosts=axes.get("dcn", 1))))
    assert set(jst.ops) == set(st.ops)
    jout = str(tmp_path / "jax.json")
    jser.save_strategy(jout, jst, doc.get("assignment"), doc.get("meta"),
                       program=doc.get("program"))
    assert again == json.load(open(jout))


def _one_device(pkg, tmp, monkeypatch, algo="unity", trace=False):
    jff, tff = graphs.bert(batch=4, seq=16, dropout=0.0,
                           use_bf16_compute=False, search_algo=algo,
                           trace="true" if trace else "auto")
    ff = jff if pkg == "jax" else tff
    p = ffj if pkg == "jax" else fft
    kw = {"machine_spec": JSpec(num_devices=1, generation="cpu-sim")} \
        if pkg == "jax" else {}
    monkeypatch.setattr(jaudit if pkg == "jax" else taudit,
                        "_DEFAULT_DIR", str(tmp / pkg))
    ff.compile(p.AdamOptimizer(alpha=1e-3, epsilon=1e-4),
               "sparse_categorical_crossentropy", ["accuracy"],
               search_budget=4, **kw)
    return ff


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(4):
        out.append({"input_ids": rng.integers(0, 1024, (4, 16))
                    .astype(np.int32),
                    "position_ids": np.tile(np.arange(16, dtype=np.int32),
                                            (4, 1)),
                    "label": rng.integers(0, 2, (4, 1)).astype(np.int32)})
    return out


def _losses(ff):
    step = ff.executor.make_train_step()
    return [float(np.asarray(ff._run_train_step(step, b)["loss"]))
            for b in _batches()]


@pytest.mark.parametrize("algo", ["unity", "mcmc"])
def test_one_device_searched_compile_trains_like_jax(algo, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("FF_FINAL_RANKER", "additive")
    monkeypatch.setenv("FF_CACHE_DIR", str(tmp_path / "cache"))
    try:
        j = _one_device("jax", tmp_path, monkeypatch, algo, trace=True)
        t = _one_device("port", tmp_path, monkeypatch, algo, trace=True)
    finally:
        jevents.disable()
        tevents.disable()
    assert [l.name for l in t.executor.program.layers] == \
        [l.name for l in j.executor.program.layers]
    assert t.dmesh.axis_sizes == j.dmesh.axis_sizes
    assert t.strategy.ops.keys() == j.strategy.ops.keys()
    if algo == "unity":
        for k in ("searched_cost_s", "dp_cost_s"):
            assert math.isclose(t._search_predicted[k],
                                j._search_predicted[k], rel_tol=REL)
        assert t._adopted_pcg.num_nodes() == j._adopted_pcg.num_nodes()
    # the audit records, one per package, in each package's own dir
    ja = json.load(open(j._strategy_audit_path))
    ta = json.load(open(t._strategy_audit_path))
    assert str(tmp_path / "port") in t._strategy_audit_path
    for side in ("adopted", "dp_baseline"):
        assert [e["name"] for e in ta[side]["per_op"]] == \
            [e["name"] for e in ja[side]["per_op"]]
        assert math.isclose(ta[side]["total_s"], ja[side]["total_s"],
                            rel_tol=REL)
    assert (ta["search_algo"], ta["ranker"]) == \
        (ja["search_algo"], ja["ranker"])
    load_reference_params(t, jax.device_get(j.params),
                          [(l.name, l.op_type) for l in j.layers])
    np.testing.assert_allclose(_losses(t), _losses(j), atol=1e-5, rtol=0)


def test_described_multi_device_strategy_is_searched_then_refused(
        tmp_path, monkeypatch):
    monkeypatch.setenv("FF_CACHE_DIR", str(tmp_path))
    _, tff = graphs.mlp()
    tff.config.export_strategy_file = str(tmp_path / "x.json")
    with pytest.raises(NotImplementedError, match="item 4"):
        tff.compile(fft.SGDOptimizer(0.01),
                    "sparse_categorical_crossentropy", [],
                    machine_spec=TSpec(num_devices=8), search_budget=2)
    doc = json.load(open(tmp_path / "x.json"))
    assert doc["mesh_axes"] == {"x0": 2, "x1": 2, "x2": 2}
    # a machine file describes the machine; execution is clamped to one
    _, t1 = graphs.mlp(machine_model_file=SLOW, search_budget=2)
    t1.compile(fft.SGDOptimizer(0.01), "sparse_categorical_crossentropy",
               [])
    assert t1.dmesh.num_devices == 1 and not t1.dmesh.described
    assert t1.dmesh.spec.ici_bandwidth == 0.5e9


@pytest.mark.parametrize("field,value", [
    ("enable_pipeline_search", True), ("machine_model_version", 1),
    ("banked_placement", "on")])
def test_unported_search_options_are_refused(field, value, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("FF_CACHE_DIR", str(tmp_path))
    _, tff = graphs.mlp(search_budget=2)
    setattr(tff.config, field, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tff.compile(fft.SGDOptimizer(0.01),
                    "sparse_categorical_crossentropy", [])


@pytest.mark.parametrize("field,value", [
    ("quantized_collectives", "auto"), ("overlap", "on")])
def test_quantized_and_overlap_search_options_are_wired(field, value,
                                                         tmp_path,
                                                         monkeypatch):
    """The quantized-collectives policy and overlap-aware scoring reach
    the search's cost model, as the JAX package wires them; the compile
    runs (one device: nothing to quantize, the overlap schedule's
    per-bucket update)."""
    monkeypatch.setenv("FF_CACHE_DIR", str(tmp_path))
    _, tff = graphs.mlp(search_budget=2)
    setattr(tff.config, field, value)
    tff.compile(fft.SGDOptimizer(0.01), "sparse_categorical_crossentropy",
                [])
    cm = tff._search_cost_model
    if field == "overlap":
        assert cm.overlap_mode and tff.executor._overlap_schedule
    else:
        assert cm.quantization == {"mode": "auto", "wire": "int8"}
        assert tff.strategy.qsync is None    # one device: no plan


def test_serving_search_and_multi_tier_placement_are_refused(tmp_path):
    from flexflow_tpu.search.optimizer import \
        optimize_strategy as joptimize_strategy
    from flexflow_tpu_torch.search.optimizer import optimize_strategy
    # the serving search is ported: on a model that has not been
    # compiled (no mesh to plan for) it refuses, as the JAX package does
    jff, tff = graphs.mlp()
    for ff, opt in ((jff, joptimize_strategy), (tff, optimize_strategy)):
        with pytest.raises(ValueError, match="compile"):
            opt(ff, mode="serving")
    ini = tmp_path / "two.ini"
    ini.write_text("generation = v5e\nici_shape = 2x2\nnum_slices = 2\n"
                   "num_hosts = 2\n")
    _, t2 = graphs.mlp(search_budget=2)
    t2.dmesh = TMesh(tload_file(str(ini)))
    t2.config.import_strategy_file = ""
    with pytest.raises(NotImplementedError, match="hier_placement"):
        optimize_strategy(t2)


def test_import_round_trips_an_exported_search(tmp_path, monkeypatch):
    monkeypatch.setenv("FF_CACHE_DIR", str(tmp_path))
    _, a = graphs.bert(batch=4, seq=16, search_budget=4,
                       export_strategy_file=str(tmp_path / "s.json"),
                       kernel_impls="attention:flash")
    a.compile(fft.SGDOptimizer(0.01), "sparse_categorical_crossentropy", [])
    doc = json.load(open(tmp_path / "s.json"))
    assert doc["program"] and doc["kernel_impls"]
    _, b = graphs.bert(batch=4, seq=16, search_budget=4,
                       import_strategy_file=str(tmp_path / "s.json"))
    b.compile(fft.SGDOptimizer(0.01), "sparse_categorical_crossentropy", [])
    assert b.executor._kernel_impls == a.executor._kernel_impls
    assert [l.name for l in b.executor.program.layers] == \
        [l.name for l in a.executor.program.layers]
