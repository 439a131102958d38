"""Package-level guarantees of the PyTorch/CUDA port (flexflow_tpu_torch):
no JAX and nothing of flexflow_tpu anywhere in it, in chip_smoke.py or in
the port's tools/torch_*.py scripts; the enums, config flags, kernel-tier
rules and serving exports of the JAX package; entry points that run on
the card unless asked for the CPU; and a chip_smoke.py that fails where
there is no card."""
import ast
import dataclasses
import enum
import glob
import os
import subprocess
import sys
import warnings

import pytest
import torch

import flexflow_tpu.ffconst as jax_const
import flexflow_tpu_torch.ffconst as torch_const
from flexflow_tpu import FFConfig as JaxConfig
from flexflow_tpu.kernels import registry as jax_kreg
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.kernels import registry as kreg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "flexflow_tpu_torch")


def _port_sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    # every port tool, those added later too
    yield from sorted(glob.glob(os.path.join(ROOT, "tools", "torch_*.py")))


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flexflow_tpu")


def test_import_leaves_jax_and_flexflow_tpu_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import flexflow_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flexflow_tpu')]\n"
        "mods = [m for m in sys.modules\n"
        "        if m.startswith('flexflow_tpu_torch')]\n"
        "want = ['flexflow_tpu_torch.frontends.keras.models',\n"
        "        'flexflow_tpu_torch.search.serialization',\n"
        "        'flexflow_tpu_torch.obs.events',\n"
        "        'flexflow_tpu_torch.obs.flight',\n"
        "        'flexflow_tpu_torch.resilience.supervisor',\n"
        "        'flexflow_tpu_torch.runtime.checkpoint',\n"
        "        'flexflow_tpu_torch.utils.profiling',\n"
        "        'flexflow_tpu_torch.parallel.topology',\n"
        "        'flexflow_tpu_torch.pcg.graph',\n"
        "        'flexflow_tpu_torch.search.unity',\n"
        "        'flexflow_tpu_torch.search.calibration',\n"
        "        'flexflow_tpu_torch.runtime.recompile']\n"
        "print(len(mods), int(all(w in mods for w in want)), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 20
    # the frontends, search, obs, resilience and utils too
    assert r.stdout.split()[1] == "1"


def test_frontends_import_without_transformers_or_onnx():
    """The frontends and the Keras layer set import on a machine with
    neither ``transformers`` nor ``onnx`` (the card's machine), and the
    ONNX frontend reads wire bytes there."""
    code = (
        "import sys\n"
        "sys.modules['transformers'] = None\n"
        "sys.modules['onnx'] = None\n"
        "import numpy as np\n"
        "import flexflow_tpu_torch.frontends as fe\n"
        "from flexflow_tpu_torch.frontends import keras, onnx_wire as w\n"
        "from flexflow_tpu_torch.frontends.onnx_frontend import ONNXModel\n"
        "data = w.make_model([w.make_node('Relu', ['x'], ['y'])],\n"
        "    [w.make_value_info('x', 1, (2, 3))],\n"
        "    [w.make_value_info('y', 1, (2, 3))])\n"
        "m = ONNXModel(data)\n"
        "assert m.model.graph.node[0].op_type == 'Relu'\n"
        "assert fe.PyTorchModel and keras.Model and keras.Sequential\n"
        "print('ok', 'transformers' in sys.modules and\n"
        "      sys.modules['transformers'] is None)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.split() == ["ok", "True"]


def test_no_source_imports_jax_or_flexflow_tpu():
    seen = 0
    scanned = set()
    for path in _port_sources():
        scanned.add(os.path.relpath(os.path.dirname(path), PKG))
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            for n in names:
                assert not _forbidden(n), f"{path}: imports {n}"
        seen += 1
    assert seen >= 20
    assert {"frontends", os.path.join("frontends", "keras"),
            "search", "obs", "resilience", "utils", "parallel",
            "pcg", "serving", os.path.join("serving", "fleet"),
            "analysis"} <= scanned


@pytest.mark.parametrize("mod", ["serving", "serving.fleet"])
def test_serving_exports_equal_reference(mod):
    import importlib
    ref = importlib.import_module(f"flexflow_tpu.{mod}")
    port = importlib.import_module(f"flexflow_tpu_torch.{mod}")
    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name
        assert type(getattr(port, name)) is type(getattr(ref, name)), name


def test_enum_values_equal_reference():
    checked = 0
    for name, obj in vars(jax_const).items():
        if isinstance(obj, type) and issubclass(obj, enum.Enum) \
                and obj.__module__ == jax_const.__name__:
            port = getattr(torch_const, name)
            assert {m.name: m.value for m in obj} == \
                {m.name: m.value for m in port}, name
            checked += 1
    assert checked >= 10
    for name in ("ELEMENTWISE_UNARY_OPS", "ELEMENTWISE_BINARY_OPS",
                 "REDUCE_OPS", "PARALLEL_OPS"):
        assert {int(x) for x in getattr(jax_const, name)} == \
            {int(x) for x in getattr(torch_const, name)}
    assert torch_const.MAX_TENSOR_DIM == jax_const.MAX_TENSOR_DIM


def test_config_fields_and_flags_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(FFConfig)}
    for f in dataclasses.fields(JaxConfig):
        assert f.name in ours, f.name
        assert ours[f.name] == f.default, f.name
    argv = ["-b", "8", "--only-data-parallel", "--f32-compute",
            "--bf16-activations", "--kernel-impl", "attention:flash",
            "--kernel-impl", "opt_update:fused", "--seed", "7", "-e", "3",
            "--lr", "0.5", "--mesh-shape", "2x4", "--tp", "2",
            "--serving-buckets", "1,8", "--zero-policy", "AUTO",
            "--no-quantized-collectives", "--remat", "--bogus-flag"]
    a, b = FFConfig.parse_args(argv), JaxConfig.parse_args(argv)
    for f in dataclasses.fields(JaxConfig):
        assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert a.kernel_impls == "attention:flash,opt_update:fused"
    assert FFConfig.parse_args(["--device", "cpu"]).device == "cpu"


def test_kernel_registry_matches_reference():
    params = {"num_heads": 4, "embed_dim": 64, "causal": True}
    for q_len, kv_len, window, deg in [(16, 16, 0, 0), (16, 32, 0, 0),
                                       (16, 16, 4, 0), (16, 16, 0, 2),
                                       (15, 15, 0, 2)]:
        p = dict(params, sliding_window=window)
        cj = jax_kreg.attention_ctx(p, q_len, kv_len, seq_degree=deg)
        ct = kreg.attention_ctx(p, q_len, kv_len, seq_degree=deg)
        assert cj == ct
        for impl in ("xla", "flash", "ring"):
            assert (jax_kreg.get_impl("attention", impl).available(cj)
                    is None) == (kreg.get_impl("attention", impl)
                                 .available(ct) is None), (impl, cj)
    # the fused update keys on the card where the reference keys on tpu
    fused = kreg.get_impl("opt_update", "fused")
    assert fused.available({"backend": "cuda", "optimizer": "adam"}) is None
    assert fused.available({"backend": "tpu", "optimizer": "adam"})
    assert fused.available({"backend": "cuda", "optimizer": "sgd"})
    with pytest.raises(ValueError, match="unknown impl"):
        kreg.parse_forced("attention:warp")
    cfg = FFConfig()
    cfg.use_flash_attention = "true"
    with pytest.warns(DeprecationWarning):
        assert kreg.resolve_forced(cfg) == {"attention": "flash"}


def test_model_needs_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FFModel(FFConfig())
    assert FFModel(FFConfig(), device="cpu").device.type == "cpu"
    cfg = FFConfig()
    cfg.device = "cpu"
    assert FFModel(cfg).device.type == "cpu"


def test_keras_compile_needs_the_card_unless_asked_for_cpu(monkeypatch):
    """Keras ``Model.compile`` builds its FFModel from the config: on
    ``config.device``, raising where there is no card rather than
    carrying on on the CPU."""
    from flexflow_tpu_torch.frontends import keras
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def model():
        return keras.Sequential([keras.Input((4,), name="x"),
                                 keras.Dense(2), keras.Softmax()])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model().compile("sgd", "sparse_categorical_crossentropy",
                        config=FFConfig(), batch_size=2)
    cfg = FFConfig()
    cfg.device = "cpu"
    m = model().compile("sgd", "sparse_categorical_crossentropy",
                        config=cfg, batch_size=2)
    assert m.ffmodel.device.type == "cpu"


def test_forced_impl_is_checked_at_compile():
    cfg = FFConfig()
    cfg.kernel_impls = "attention:ring"
    ff = FFModel(cfg, device="cpu")
    x = ff.create_tensor((2, 8, 16))
    ff.multihead_attention(x, x, x, 16, 2)
    with pytest.raises(ValueError, match="attention:ring is not available"):
        ff.compile()
    cfg = FFConfig()
    cfg.kernel_impls = "attention:flash"
    ff = FFModel(cfg, device="cpu")
    x = ff.create_tensor((2, 8, 16))
    ff.multihead_attention(x, x, x, 16, 2, name="mha")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ff.compile()
    assert ff.executor._kernel_impls == {"mha": "flash"}


def test_chip_smoke_fails_without_a_card():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_zoo_data_fits_each_published_graph():
    """chip_smoke.py's zoo phase: each model's seeded data has the shapes
    and dtypes of its graph inputs at the published widths (graphs built
    on the CPU, no weight materialised), its flash layers are the
    graph's attention layers, and its leaves fit one fused Adam launch,
    as the phase's launch checks assume."""
    import importlib.util
    import numpy as np
    from flexflow_tpu_torch import OperatorType
    spec_ = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(smoke)
    assert "zoo" in smoke.PHASES
    specs = smoke.zoo_specs()
    assert [s.tag for s in specs] == [
        "transformer", "nmt", "nmt_f32", "resnet50", "resnext50",
        "inception_v3", "alexnet", "dlrm", "xdl"]
    # NMT once more with use_bf16_compute = False (the f32 wide kernels)
    assert [s.tag for s in specs if s.f32] == ["nmt_f32"]
    np_dtypes = {torch.float32: np.float32, torch.int32: np.int32}
    for s in specs:
        ff = FFModel(FFConfig(), device="cpu")
        out = s.build(ff, s.batch)
        xs, y = s.data(2, 0)
        assert [(x.shape[1:], x.dtype) for x in xs] == [
            (t.shape[1:], np.dtype(np_dtypes[t.torch_dtype]))
            for t in ff.input_tensors], s.tag
        if s.loss.startswith("sparse"):   # one class id per output row
            assert np.prod(y.shape[1:]) == np.prod(out.shape[1:-1]), s.tag
            assert y.dtype == np.int32 and y.max() < out.shape[-1], s.tag
        else:
            assert y.shape[1:] == out.shape[1:], s.tag
        mha = [l for l in ff.layers
               if l.op_type == OperatorType.OP_MULTIHEAD_ATTENTION]
        assert len(mha) == s.flash, s.tag
        assert sum(len(l.weights) for l in ff.layers) <= 384, s.tag


def test_chip_smoke_frontends_graphs_build_on_the_cpu():
    """chip_smoke.py's frontends phase, its graphs built on the CPU at
    full width (no weight materialised): the torch.nn BERT-base imports
    through fx with 12 attention layers and one folded position
    constant, the Keras model lowers to 12 attention layers with a
    2-class head, and the ONNX AlexNet's bytes import to the layers of
    ``build_alexnet`` (its ReLUs as layers of their own) with every
    initializer stashed at the shape of its weight."""
    import importlib.util
    from flexflow_tpu_torch import DataType, OperatorType
    from flexflow_tpu_torch.frontends import PyTorchModel, keras
    from flexflow_tpu_torch.frontends.onnx_frontend import ONNXModel
    from flexflow_tpu_torch.models import build_alexnet
    spec_ = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(smoke)
    assert "frontends" in smoke.PHASES
    mha = OperatorType.OP_MULTIHEAD_ATTENTION

    torch.manual_seed(0)
    ff = FFModel(FFConfig(), device="cpu")
    x = ff.create_tensor((smoke.FE_ROWS, smoke.FE_SEQ), DataType.DT_INT32,
                         name="input_ids")
    (out,) = PyTorchModel(smoke.FxBert(smoke.FE_SEQ, 0.1)).torch_to_ff(
        ff, [x])
    assert out.shape == (smoke.FE_ROWS, 2)
    assert sum(l.op_type == mha for l in ff.layers) == smoke.LAYERS
    consts = [t for t in ff.input_tensors if t.get_tensor() is not None]
    assert [c.shape for c in consts] == [(smoke.FE_SEQ,)]

    km = smoke.keras_bert(keras, smoke.FE_KERAS_SEQ)
    kff = FFModel(FFConfig(), device="cpu")
    env = {id(i): kff.create_tensor((smoke.FE_ROWS,) + i.shape, i.dtype,
                                    name=i.name) for i in km.inputs}
    for layer in km._topo_layers():
        env[id(layer)] = layer.to_ff(kff, [env[id(k.layer)]
                                           for k in layer.inbound])
    assert sum(l.op_type == mha for l in kff.layers) == smoke.LAYERS
    assert kff.layers[-1].outputs[0].shape == (smoke.FE_ROWS, 2)

    data, ini = smoke.alexnet_onnx(5)
    off = FFModel(FFConfig(), device="cpu")
    xt = off.create_tensor((smoke.ONNX_BATCH, 3, 229, 229), name="input")
    (o,) = ONNXModel(data).apply(off, {"input": xt})
    ref = FFModel(FFConfig(), device="cpu")
    assert o.shape == build_alexnet(ref, smoke.ONNX_BATCH, 1000, 229).shape
    assert [l.op_type for l in off.layers
            if l.op_type != OperatorType.OP_RELU] == \
        [l.op_type for l in ref.layers]
    stashed = {l: {n: a.shape for n, a in ws.items()}
               for l, ws in off._pending_onnx_weights.items()}
    assert len(stashed) == 8 == len(ini) // 2
    for lname, ws in stashed.items():
        layer = next(l for l in off.layers if l.name == lname)
        assert ws == {w.name: w.shape for w in layer.weights}, lname


def _load_smoke():
    import importlib.util
    spec_ = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_resilience_graph_and_plan_on_the_cpu(tmp_path,
                                                        monkeypatch):
    """chip_smoke.py's resilience phase on the CPU: (a) its BERT-base
    graph (8 x 128, built, no weight materialised) has the parameter
    leaves that tests/data/bert_base_checkpoint_leaves.json lists for the
    JAX package, which the phase holds the card's manifest against; (b)
    its fault plan, run by the Supervisor with the phase's epochs,
    batches, checkpoint cadence and retention over a 2-layer BERT
    (hidden 64, dropout 0.1, Adam, the fused update's plain version),
    executes exactly RES_EXECUTED steps (replays included) with the
    restarts, rollback and skipped checkpoint the phase asserts, and
    ends bit-identical to the clean run."""
    import json
    import numpy as np
    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch.models import BertConfig, build_bert
    from flexflow_tpu_torch.obs import events, flight
    from flexflow_tpu_torch.resilience import Supervisor, faults, status
    monkeypatch.setattr(flight, "_DEFAULT_DIR", str(tmp_path / "ffcache"))
    smoke = _load_smoke()
    assert "resilience" in smoke.PHASES
    ff = FFModel(FFConfig(), device="cpu")
    bcfg = BertConfig.base()
    bcfg.max_position = 128
    build_bert(ff, 8, 128, bcfg)
    with open(smoke.RES_LEAVES) as f:
        want = json.load(f)["leaves"]
    got = {f"['params']['{l.name}']['{w.name}']": {
        "shape": list(w.shape), "dtype": "float32"}
        for l in ff.layers for w in l.weights}
    assert got == {k: v for k, v in want.items()
                   if k.startswith("['params']")}
    assert {k.replace("['opt_state']['m']", "['params']")
            for k in want if k.startswith("['opt_state']['m']")} == \
        set(got)
    assert len(want) == 3 * len(got)

    plan = faults.FaultPlan.parse(smoke.RES_PLAN)
    assert sorted(f.kind for f in plan.faults) == \
        ["corrupt_ckpt", "crash", "nan"]

    def model():
        cfg = FFConfig()
        cfg.batch_size = 8
        cfg.kernel_impls = "attention:flash"
        m = FFModel(cfg, device="cpu")
        b = BertConfig.tiny()
        b.max_position = 16
        out = build_bert(m, 8, 16, b)
        m.compile(AdamOptimizer(1e-4), "sparse_categorical_crossentropy",
                  ["accuracy"], output_tensor=out)
        m.executor._kernel_impls["opt_update"] = "fused"
        return m

    rng = np.random.default_rng(7)
    n = smoke.RES_BATCHES * 8
    x = [rng.integers(0, 1024, (n, 16)).astype(np.int32),
         np.tile(np.arange(16, dtype=np.int32), (n, 1))]
    y = rng.integers(0, 2, (n, 1)).astype(np.int32)
    runs = {}
    was_enabled = events.enabled()
    # the phase counts executed steps (replays included) by the step
    # wrapper's trace counter, so tracing is on here as it is there
    events.enable()
    try:
        for name, p in (("clean", ""), ("faulty", smoke.RES_PLAN)):
            faults.install(p)
            status.reset()
            events.clear()
            m = model()
            sup = Supervisor(m, str(tmp_path / name),
                             checkpoint_every=smoke.RES_EVERY,
                             max_to_keep=smoke.RES_KEEP,
                             backoff_base_s=0.0)
            hist = sup.run(x, y, epochs=smoke.RES_EPOCHS)
            runs[name] = (events.counters()["executor.train_steps"], sup,
                          hist, smoke.host_state(m), status.snapshot())
    finally:
        faults.clear()
        status.reset()
        events.clear()
        if not was_enabled:
            events.disable()
    steps, sup, hist, state, snap = runs["faulty"]
    assert runs["clean"][0] == smoke.RES_EPOCHS * smoke.RES_BATCHES
    assert steps == smoke.RES_EXECUTED
    assert (sup.restarts, sup.nan_rollbacks) == (2, 1)
    assert snap["corrupt_checkpoints_skipped"] == 1
    assert snap["faults_injected"] == 3
    nleaves, bad = smoke.identical(runs["clean"][3], state)
    assert nleaves > 0 and bad == []
    assert hist[-1]["loss"] == runs["clean"][2][-1]["loss"]


def test_chip_smoke_search_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's search phase rehearsed on the CPU at a tiny size
    (2-layer BERT, hidden 64): the searched compile with calibration
    (rows preset in the phase's cache, so nothing is measured) and the
    floor guard forced on, its plan-exact launch counts (the plain
    versions' calls stand in for launches; the fused Adam's predicate
    is widened to the CPU), the dropout-0 comparison with data
    parallelism, remat's bit-identity and doubled forwards, and the
    recompile trigger against the same change by hand."""
    import torch
    from flexflow_tpu_torch.kernels import registry as kreg
    from flexflow_tpu_torch.models import BertConfig
    from flexflow_tpu_torch.search.calibration import CalibrationTable
    smoke = _load_smoke()
    assert "search" in smoke.PHASES
    tab = CalibrationTable(str(tmp_path))
    for kind, v in (("host_dispatch", 5e-6), ("host_membw", 2e10)):
        tab.put("cpu", kind, "-", 0, 0, v)
    for impl, t in (("xla", 9e-4), ("flash", 1e-4)):
        for sc in (1 << 16, 1 << 20):
            tab.put("cpu", f"op_attention@{impl}", "float32", sc, 0, t)
    monkeypatch.setenv("FF_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(smoke, "SEARCH_DEVICE", "cpu")
    monkeypatch.setattr(smoke, "SEARCH_SEQ", 16)
    monkeypatch.setattr(smoke, "RECOMPILE_SEQ", 16)

    def tiny():
        b = BertConfig.tiny()
        b.max_position = 16
        return b

    monkeypatch.setattr(smoke, "search_bert_config", tiny)
    build = smoke.search_model
    monkeypatch.setattr(smoke, "search_model", lambda seq, dropout, **kw:
                        build(seq, dropout, search_floor_guard="true",
                              use_bf16_compute=False, **kw))
    fused = kreg.REGISTRY["opt_update"]["fused"]
    monkeypatch.setitem(kreg.REGISTRY["opt_update"], "fused",
                        kreg.KernelImpl("opt_update", "fused",
                                        lambda ctx: None, fused.calib_kind))
    fns = smoke.counters()

    class Plain:
        """A wrapper's plain-call count, read as its launches."""

        def __init__(self, fn):
            self.fn, self.base = fn, fn.plain_calls

        @property
        def launches(self):
            return self.fn.plain_calls - self.base

    monkeypatch.setattr(smoke, "zero_counts", lambda: {
        n: Plain(f) for n, f in fns.items()})
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(smoke, "free_cuda", lambda: None)
    s = smoke.searched_bert("cpu")
    assert s["plan"] == [("attention", "flash"), ("opt_update", "fused")]
    assert s["launches"] == {"flash_attention_fwd": 6,
                             "flash_attention_bwd_dq": 6,
                             "flash_attention_bwd_dkv": 6,
                             "adam_update": 3}
    assert s["guard"]["n_steps"] >= 3
    r = smoke.remat_check("cpu")
    assert r["blocks"]["launches"]["flash_attention_fwd"] == 12
    assert r["none"]["hist"] == r["blocks"]["hist"]
    c = smoke.recompile_check()
    assert c["recompiles"] == 1 and c["launches"]["adam_update"] == 6
