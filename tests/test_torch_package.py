"""Package-level guarantees of the PyTorch/CUDA port (flexflow_tpu_torch):
no JAX and nothing of flexflow_tpu anywhere in it, in chip_smoke.py or in
the port's tools/torch_*.py scripts; the enums, config flags and kernel-tier rules
of the JAX package; entry points that run on the card unless asked for the
CPU; and a chip_smoke.py that fails where there is no card."""
import ast
import dataclasses
import enum
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
    yield os.path.join(ROOT, "tools", "torch_profile_bert.py")
    yield os.path.join(ROOT, "tools", "torch_mixtral_train_ab.py")
    yield os.path.join(ROOT, "tools", "torch_profile_dkv_phases.py")


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
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('flexflow_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 20


def test_no_source_imports_jax_or_flexflow_tpu():
    seen = 0
    for path in _port_sources():
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
        "transformer", "nmt", "resnet50", "resnext50", "inception_v3",
        "alexnet", "dlrm", "xdl"]
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
