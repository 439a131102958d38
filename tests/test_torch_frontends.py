"""The port's frontends against the JAX package's: torch.fx (plain modules
and HF transformers models built from local configs), Keras and ONNX (from
wire bytes), and ``fit``'s epoch-callback hook.

Each test builds the same graph through both packages' frontends, copies
the weights with each package's ``copy_weights`` (checked equal to the
reference's), then carries the reference's parameters and op state into
the port with ``interop`` (the FF attention layer keeps its own
initialisation in both packages, since neither copies
``nn.MultiheadAttention`` weights), and compares outputs in f32 to 1e-5.
Where the JAX package's frontend test compares with torch, the port's
output is compared with torch too, at that test's tolerance.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.frontends import keras as jax_keras
from flexflow_tpu.frontends import onnx_wire as jax_wire
from flexflow_tpu.frontends.onnx_frontend import ONNXModel as JaxONNXModel
from flexflow_tpu.frontends.torch_fx import PyTorchModel as JaxPyTorchModel
from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.frontends import keras
from flexflow_tpu_torch.frontends import onnx_wire as wire
from flexflow_tpu_torch.frontends.onnx_frontend import ONNXModel
from flexflow_tpu_torch.frontends.torch_fx import PyTorchModel
from flexflow_tpu_torch.interop import (load_reference_params,
                                        load_reference_state)
from flexflow_tpu_torch.kernels import flash_attention
from flexflow_tpu_torch.kernels.opt_update import fused_adam_update
from flexflow_tpu_torch.search.serialization import _param_to_json

ATOL = 1e-5
PKGS = {"jax": (ffj, JaxPyTorchModel), "port": (fft, PyTorchModel)}


def _cfg(pkg, bs, impl=None, bf16=False):
    c = pkg.FFConfig()
    c.batch_size = bs
    c.only_data_parallel = True
    c.use_bf16_compute = bf16
    if impl:
        c.kernel_impls = f"attention:{impl}"
    if pkg is fft:
        c.device = "cpu"
    return c


def _layer_names(ff):
    return [(l.name, l.op_type) for l in ff.layers]


def _host(tree):
    return {ln: {wn: np.asarray(w) for wn, w in ws.items()}
            for ln, ws in jax.device_get(tree).items()}


def _carry(jff, tff, copied=True):
    """Check that the port's ``copy_weights`` wrote what the reference's
    did (every leaf but the attention layers', which neither copies), then
    carry the reference's params and op state into the port."""
    names = _layer_names(jff)
    assert [int(t) for _, t in names] == [int(l.op_type) for l in tff.layers]
    jp = _host(jff.params)
    if copied:
        for (jn, op), tl in zip(names, tff.layers):
            if int(op) == int(OperatorType.OP_MULTIHEAD_ATTENTION):
                continue
            for wn, w in tff.params.get(tl.name, {}).items():
                np.testing.assert_array_equal(w.numpy(), jp[jn][wn],
                                              err_msg=f"{tl.name}/{wn}")
    load_reference_params(tff, jp, names)
    if jff.state:
        load_reference_state(tff, _host(jff.state), names)


def _fx_pair(module, specs, bs, impl=None, hf=False, loss="identity",
             bf16=False):
    """``module`` imported through both packages' ``PyTorchModel``:
    ``specs`` lists (name, shape, dtype) of the graph inputs. Returns
    {"jax": ff, "port": ff} with the port carrying the reference's
    params."""
    out = {}
    for key, (pkg, pm_cls) in PKGS.items():
        ff = pkg.FFModel(_cfg(pkg, bs, impl, bf16))
        xs = [ff.create_tensor(shape, dtype, name=n)
              for n, shape, dtype in specs]
        pm = pm_cls(module, is_hf_model=hf, batch_size=bs)
        outs = pm.torch_to_ff(ff, xs)
        ff.compile(pkg.SGDOptimizer(0.01), loss, [], output_tensor=outs[0])
        pm.copy_weights(ff)
        out[key] = ff
    _carry(out["jax"], out["port"])
    return out


def _forwards(pair, batch):
    jff, tff = pair["jax"], pair["port"]
    want = np.asarray(jff.executor.make_forward()(jff.params, jff.state,
                                                  batch))
    got = tff.executor.make_forward()(tff.params, tff.state, batch)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return got.numpy(), want


def _torch_ref(module, *xs):
    with torch.no_grad():
        return module(*[torch.from_numpy(x) for x in xs]).numpy()


class SmallNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(16, 32)
        self.fc2 = nn.Linear(32, 4)

    def forward(self, x):
        x = torch.relu(self.fc1(x))
        return torch.softmax(self.fc2(x), dim=-1)


class SmallCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.pool = nn.MaxPool2d(2)
        self.flat = nn.Flatten()
        self.fc = nn.Linear(8 * 8 * 8, 10)

    def forward(self, x):
        x = torch.relu(self.conv(x))
        x = self.pool(x)
        return self.fc(self.flat(x))


class MHANet(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = nn.MultiheadAttention(16, 4, batch_first=True)
        self.fc = nn.Linear(16, 2)

    def forward(self, x):
        a, _ = self.attn(x, x, x)
        return self.fc(a[:, -1])


class SeqNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.seq = nn.Sequential(nn.Linear(8, 16), nn.ReLU(),
                                 nn.Linear(16, 2))

    def forward(self, x):
        return self.seq(x)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ----------------------------------------------------------------------
# the 15 tests of tests/test_frontends.py, each held against JAX
# ----------------------------------------------------------------------
def test_torch_fx_mlp_alignment():
    torch.manual_seed(0)
    net = SmallNet()
    pair = _fx_pair(net, [("x", (8, 16), "float")], 8,
                    loss="sparse_categorical_crossentropy")
    xs = _normal((8, 16), 0)
    got, want = _forwards(pair, {"x": xs})
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, _torch_ref(net, xs), rtol=2e-2,
                               atol=2e-3)


def test_torch_fx_cnn_alignment():
    torch.manual_seed(0)
    net = SmallCNN()
    pair = _fx_pair(net, [("x", (4, 3, 16, 16), "float")], 4,
                    loss="sparse_categorical_crossentropy")
    xs = _normal((4, 3, 16, 16), 0)
    got, want = _forwards(pair, {"x": xs})
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, _torch_ref(net, xs), rtol=5e-2,
                               atol=5e-3)


def _keras_seq(k, dims, hidden=None, acti=None):
    layers = [k.Input((dims[0],), name="x")]
    if hidden:
        layers.append(k.Dense(hidden, activation=acti))
    layers += [k.Dense(dims[1]), k.Softmax()]
    return k.Sequential(layers)


def _keras_pair(build, optimizer, metrics, bs):
    """The same Keras graph compiled in both packages (f32), the port
    carrying the reference's weights."""
    out = {}
    for key, (pkg, _), k in (("jax", PKGS["jax"], jax_keras),
                             ("port", PKGS["port"], keras)):
        model = build(k)
        model.compile(optimizer, "sparse_categorical_crossentropy",
                      metrics, config=_cfg(pkg, bs), batch_size=bs)
        out[key] = model
    _carry(out["jax"].ffmodel, out["port"].ffmodel, copied=False)
    return out


def _assert_histories(got, want, keys=("loss", "accuracy")):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in keys:
            if k in w:
                np.testing.assert_allclose(g[k], w[k], atol=ATOL, rtol=0,
                                           err_msg=k)


def test_keras_sequential_trains():
    from flexflow_tpu.frontends.keras.callbacks import \
        VerifyMetrics as JaxVerifyMetrics
    from flexflow_tpu_torch.frontends.keras.callbacks import VerifyMetrics
    pair = _keras_pair(lambda k: _keras_seq(k, (20, 4), 64, "relu"), "sgd",
                       ["accuracy"], 64)
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 20)) * 3
    ys = rng.integers(0, 4, 512).astype(np.int32)
    xs = (centers[ys] + rng.normal(size=(512, 20))).astype(np.float32)
    hists, reps = {}, {}
    for key, cb in (("jax", JaxVerifyMetrics), ("port", VerifyMetrics)):
        m = pair[key]
        m.ffmodel.optimizer.lr = 0.1
        hists[key] = m.fit(xs, ys, epochs=4, verbose=False,
                           callbacks=[cb("accuracy", 0.8)])
        reps[key] = m.evaluate(xs, ys)
    _assert_histories(hists["port"], hists["jax"])
    assert reps["port"]["accuracy"] > 0.8
    np.testing.assert_allclose(reps["port"]["loss"], reps["jax"]["loss"],
                               atol=ATOL)


def _two_input_model(k, merge):
    a = k.Input((8,), name="a")
    b = k.Input((8,), name="b")
    if merge == "dense":
        da = k.Dense(16, activation="relu")(a.tensor)
        db = k.Dense(16, activation="relu")(b.tensor)
        merged = k.Concatenate()([da, db])
    else:
        mx = k.Maximum()([a.tensor, b.tensor])
        mn = k.Minimum()([a.tensor, b.tensor])
        merged = k.Concatenate()([mx, mn])
    out = k.Softmax()(k.Dense(2)(merged))
    return k.Model(inputs=[a, b], outputs=out)


def test_keras_functional_multi_input():
    pair = _keras_pair(lambda k: _two_input_model(k, "dense"), "adam",
                       ["accuracy"], 32)
    rng = np.random.default_rng(0)
    xa = rng.normal(size=(128, 8)).astype(np.float32)
    xb = rng.normal(size=(128, 8)).astype(np.float32)
    ys = (xa.sum(-1) > xb.sum(-1)).astype(np.int32)
    hj = pair["jax"].fit([xa, xb], ys, epochs=3, verbose=False)
    ht = pair["port"].fit([xa, xb], ys, epochs=3, verbose=False)
    _assert_histories(ht, hj)
    assert ht[-1]["loss"] < ht[0]["loss"]
    np.testing.assert_allclose(pair["port"].predict([xa[:32], xb[:32]]),
                               pair["jax"].predict([xa[:32], xb[:32]]),
                               atol=ATOL)


def test_torch_fx_mha_and_negative_index():
    """nn.MultiheadAttention's tuple output + x[:, -1]: the same layers
    as the JAX import, and the same output from the same params."""
    torch.manual_seed(0)
    pair = _fx_pair(MHANet(), [("x", (4, 6, 16), "float")], 4)
    assert [(l.name, int(l.op_type)) for l in pair["port"].layers] == \
        [(n, int(t)) for n, t in _layer_names(pair["jax"])]
    assert tuple(pair["port"].executor.program.output_tensors[0].shape) \
        == (4, 2)
    got, want = _forwards(pair, {"x": _normal((4, 6, 16), 1)})
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_torch_fx_sequential_weight_copy():
    torch.manual_seed(0)
    net = SeqNet()
    pair = _fx_pair(net, [("x", (4, 8), "float")], 4)
    xs = _normal((4, 8), 0)
    got, want = _forwards(pair, {"x": xs})
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, _torch_ref(net, xs), rtol=2e-2,
                               atol=2e-3)


def _small_seq_data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(64, 8)).astype(np.float32),
            rng.integers(0, 4, 64).astype(np.int32))


def test_early_stopping_halts_fit():
    from flexflow_tpu.frontends.keras.callbacks import \
        EarlyStopping as JaxEarlyStopping
    from flexflow_tpu_torch.frontends.keras.callbacks import EarlyStopping
    pair = _keras_pair(lambda k: _keras_seq(k, (8, 4)), "sgd", [], 16)
    xs, ys = _small_seq_data()
    hists = {}
    for key, cb in (("jax", JaxEarlyStopping), ("port", EarlyStopping)):
        pair[key].ffmodel.optimizer.lr = 0.0  # loss plateaus immediately
        hists[key] = pair[key].fit(xs, ys, epochs=10, verbose=False,
                                   callbacks=[cb(patience=2)])
    assert len(hists["port"]) < 10, len(hists["port"])
    # at lr 0 each epoch's loss differs from the last only by f32 summation
    # order over another shuffle, so which epoch "improves" by less than
    # an ulp is noise; the epochs both packages ran agree
    n = min(len(hists["port"]), len(hists["jax"]))
    _assert_histories(hists["port"][:n], hists["jax"][:n])


def test_lr_scheduler_takes_effect():
    from flexflow_tpu.frontends.keras.callbacks import \
        LearningRateScheduler as JaxLRS
    from flexflow_tpu_torch.frontends.keras.callbacks import \
        LearningRateScheduler
    pair = _keras_pair(lambda k: _keras_seq(k, (8, 4)), "sgd", [], 16)
    xs, ys = _small_seq_data()
    ws = {}
    for key, lrs in (("jax", JaxLRS), ("port", LearningRateScheduler)):
        m = pair[key]
        ff = m.ffmodel
        name = ff.layers[0].name
        ff.optimizer.lr = 0.5
        w = [np.array(ff.get_weights(name))]
        # lr -> 0 after the first epoch: the weights must stop changing
        m.fit(xs, ys, epochs=1, verbose=False)
        w.append(np.array(ff.get_weights(name)))
        m.fit(xs, ys, epochs=2, verbose=False,
              callbacks=[lrs(lambda e: 0.0)])
        w.append(np.array(ff.get_weights(name)))
        m.fit(xs, ys, epochs=1, verbose=False)  # lr now 0 via scheduler
        w.append(np.array(ff.get_weights(name)))
        assert not np.allclose(w[0], w[1])
        assert np.allclose(w[2], w[3])
        assert ff.optimizer.lr == 0.0
        ws[key] = w
    for got, want in zip(ws["port"], ws["jax"]):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _hf_ids(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


def _hf_check(m, specs, feeds, bs=2):
    pair = _fx_pair(m, specs, bs, hf=True)
    got, want = _forwards(pair, feeds)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    with torch.no_grad():
        ref = m(**{k: torch.from_numpy(v.astype(np.int64))
                   for k, v in feeds.items()}).last_hidden_state.numpy()
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=5e-3)
    return pair


def test_torch_fx_huggingface_bert():
    """A real HF BertModel through fx in both packages: the folded
    mask / position-id constants and the SDPA lowering."""
    pytest.importorskip("transformers")
    from transformers import BertConfig as HFBertConfig, BertModel
    tcfg = HFBertConfig(vocab_size=128, hidden_size=32,
                        num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=64, max_position_embeddings=64)
    torch.manual_seed(0)
    m = BertModel(tcfg)
    pair = _hf_check(m, [("input_ids", (2, 16), "int32")],
                     {"input_ids": _hf_ids(128, (2, 16), 0)})
    assert pair["port"].const_inputs


def test_torch_fx_huggingface_gpt2():
    """A real HF GPT2Model (Conv1D modules, causal masking, NewGELU)."""
    pytest.importorskip("transformers")
    from transformers import GPT2Config as HFGPT2Config, GPT2Model
    tcfg = HFGPT2Config(vocab_size=96, n_embd=32, n_layer=2, n_head=4,
                        n_positions=32, resid_pdrop=0.0, embd_pdrop=0.0,
                        attn_pdrop=0.0)
    torch.manual_seed(0)
    _hf_check(GPT2Model(tcfg), [("input_ids", (2, 16), "int32")],
              {"input_ids": _hf_ids(96, (2, 16), 1)})


class T5LayerNorm(nn.Module):  # HF-identical semantics
    def __init__(self, d, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.variance_epsilon = eps

    def forward(self, x):
        var = x.pow(2).mean(-1, keepdim=True)
        return self.weight * x * torch.rsqrt(var + self.variance_epsilon)


class RMSBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm = T5LayerNorm(16)
        self.fc = nn.Linear(16, 16)

    def forward(self, x):
        return self.fc(self.norm(x))


def test_torch_fx_t5_rmsnorm_fusion():
    """T5LayerNorm modules fuse to OP_RMSNORM, as in the JAX import."""
    torch.manual_seed(0)
    m = RMSBlock().eval()
    with torch.no_grad():
        m.norm.weight.mul_(1.5)
    pair = _fx_pair(m, [("x", (4, 16), "float")], 4)
    assert any(l.op_type == OperatorType.OP_RMSNORM
               for l in pair["port"].layers)
    x = _normal((4, 16), 2)
    got, want = _forwards(pair, {"x": x})
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, _torch_ref(m, x), atol=2e-3, rtol=2e-3)


def test_torch_fx_batchnorm_running_stats():
    """BatchNorm2d import carries eps + running stats (eval-mode numerics
    of a torch model with non-trivial running stats)."""
    m = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1),
                      nn.BatchNorm2d(4, eps=1e-3), nn.ReLU()).eval()
    torch.manual_seed(0)
    with torch.no_grad():
        m[1].running_mean.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
        m[1].running_var.copy_(torch.tensor([1.5, 0.5, 2.0, 1.0]))
        m[1].weight.copy_(torch.tensor([1.1, 0.9, 1.2, 1.0]))
        m[1].bias.copy_(torch.tensor([0.0, 0.1, -0.1, 0.2]))
    pair = _fx_pair(m, [("x", (2, 3, 8, 8), "float")], 2)
    bn = next(l.name for l in pair["port"].layers
              if l.op_type == OperatorType.OP_BATCHNORM)
    np.testing.assert_array_equal(pair["port"].state[bn]["var"].numpy(),
                                  [1.5, 0.5, 2.0, 1.0])
    x = _normal((2, 3, 8, 8), 3)
    got, want = _forwards(pair, {"x": x})
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, _torch_ref(m, x), atol=2e-3, rtol=2e-3)


def _file_net():
    torch.manual_seed(0)
    return nn.Sequential(nn.Linear(12, 24), nn.ReLU(),
                         nn.Linear(24, 5)).eval()


def test_torch_fx_file_roundtrip(tmp_path):
    """torch_to_file -> file_to_ff in the port: the rebuilt graph matches
    the direct import's forward and the JAX import's."""
    m = _file_net()
    path = str(tmp_path / "graph.json")
    ff1 = fft.FFModel(_cfg(fft, 4))
    x1 = ff1.create_tensor((4, 12), name="x")
    pm = PyTorchModel(m)
    outs1 = pm.torch_to_file(ff1, [x1], path)
    ff1.compile(fft.SGDOptimizer(0.01), "identity", [],
                output_tensor=outs1[0])
    pm.copy_weights(ff1)
    ff2 = fft.FFModel(_cfg(fft, 4))
    x2 = ff2.create_tensor((4, 12), name="x")
    outs2 = PyTorchModel.file_to_ff(path, ff2, [x2])
    assert [l.op_type for l in ff2.layers] == [l.op_type for l in ff1.layers]
    ff2.compile(fft.SGDOptimizer(0.01), "identity", [],
                output_tensor=outs2[0])
    for lname, lp in ff1.params.items():
        for wname, w in lp.items():
            ff2.set_weights(lname, wname, w.numpy())
    x = _normal((4, 12), 4)
    y1 = ff1.executor.make_forward()(ff1.params, ff1.state, {"x": x})
    y2 = ff2.executor.make_forward()(ff2.params, ff2.state, {"x": x})
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-6)
    pair = _fx_pair(m, [("x", (4, 12), "float")], 4)
    got, want = _forwards(pair, {"x": x})
    np.testing.assert_allclose(y2.numpy(), want, atol=ATOL, rtol=ATOL)


def test_keras_maximum_minimum():
    pair = _keras_pair(lambda k: _two_input_model(k, "maxmin"), "sgd", [],
                       16)
    rng = np.random.default_rng(0)
    xa = rng.normal(size=(32, 8)).astype(np.float32)
    xb = rng.normal(size=(32, 8)).astype(np.float32)
    ys = rng.integers(0, 2, 32).astype(np.int32)
    hj = pair["jax"].fit([xa, xb], ys, epochs=2, verbose=False)
    ht = pair["port"].fit([xa, xb], ys, epochs=2, verbose=False)
    assert np.isfinite(ht[-1]["loss"])
    _assert_histories(ht, hj)


@pytest.mark.slow
def test_torch_fx_huggingface_mt5():
    """A real HF MT5Model (encoder-decoder: T5LayerNorm fusion, relative
    position bias, cross attention) through both packages."""
    pytest.importorskip("transformers")
    from transformers import MT5Config, MT5Model
    tcfg = MT5Config(vocab_size=96, d_model=32, d_kv=8, d_ff=64,
                     num_layers=2, num_heads=4, dropout_rate=0.0)
    torch.manual_seed(0)
    m = MT5Model(tcfg).eval()
    pair = _hf_check(m, [("input_ids", (2, 16), "int32"),
                         ("decoder_input_ids", (2, 8), "int32")],
                     {"input_ids": _hf_ids(96, (2, 16), 0),
                      "decoder_input_ids": _hf_ids(96, (2, 8), 1)})
    assert any(l.op_type == OperatorType.OP_RMSNORM
               for l in pair["port"].layers)


# ----------------------------------------------------------------------
# beyond the reference's tests
# ----------------------------------------------------------------------
def _layer_key(layer):
    return (layer.name, int(layer.op_type),
            {k: _param_to_json(v) for k, v in layer.params.items()})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_file_loads_in_the_other_package(tmp_path, writer):
    """A graph file written by one package's ``torch_to_file`` (an MHA
    encoder with a folded position constant) rebuilds through the other's
    ``file_to_ff``: the same op list, and the same outputs from the same
    params."""
    torch.manual_seed(0)
    m = _TinyEncoder(layers=1)
    path = str(tmp_path / "graph.json")
    reader = "port" if writer == "jax" else "jax"
    made = {}
    pkg, pm_cls = PKGS[writer]
    ff = pkg.FFModel(_cfg(pkg, 2))
    x = ff.create_tensor((2, 8), "int32", name="input_ids")
    outs = pm_cls(m).torch_to_file(ff, [x], path)
    ff.compile(pkg.SGDOptimizer(0.01), "identity", [], output_tensor=outs[0])
    made[writer] = ff
    with open(path) as f:
        assert json.load(f)["format"] == "flexflow-tpu-graph-v1"
    assert os.path.exists(path + ".npz")
    pkg, pm_cls = PKGS[reader]
    ff = pkg.FFModel(_cfg(pkg, 2))
    x = ff.create_tensor((2, 8), "int32", name="input_ids")
    outs = pm_cls.file_to_ff(path, ff, [x])
    ff.compile(pkg.SGDOptimizer(0.01), "identity", [], output_tensor=outs[0])
    made[reader] = ff
    jff, tff = made["jax"], made["port"]
    assert [_layer_key(l) for l in tff.layers] == \
        [_layer_key(l) for l in jff.layers]
    load_reference_params(tff, _host(jff.params), _layer_names(jff))
    got, want = _forwards(made, {"input_ids": _hf_ids(50, (2, 8), 5)})
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_early_stopping_history_length_matches_jax():
    """EarlyStopping through the Keras adapter and ``FFModel.fit``'s hook
    stops after the same epoch in both packages, where the stop does not
    hang on f32 noise: at lr 0 no epoch improves by min_delta 1e-3."""
    from flexflow_tpu.frontends.keras.callbacks import \
        EarlyStopping as JaxEarlyStopping
    from flexflow_tpu_torch.frontends.keras.callbacks import EarlyStopping
    pair = _keras_pair(lambda k: _keras_seq(k, (8, 4)), "sgd", [], 16)
    xs, ys = _small_seq_data()
    hists, cbs = {}, {}
    for key, cb in (("jax", JaxEarlyStopping), ("port", EarlyStopping)):
        pair[key].ffmodel.optimizer.lr = 0.0
        cbs[key] = cb(patience=2, min_delta=1e-3)
        hists[key] = pair[key].fit(xs, ys, epochs=10, verbose=False,
                                   callbacks=[cbs[key]])
    assert len(hists["port"]) == len(hists["jax"]) == 3
    assert cbs["port"].stopped_epoch == cbs["jax"].stopped_epoch == 2
    _assert_histories(hists["port"], hists["jax"])


def test_fit_callbacks_get_each_epoch_and_can_stop():
    """The port's ``FFModel.fit`` hook: ``on_epoch_end(epoch, report,
    model)`` after each epoch's report, and a stop when a callback sets
    ``stop_requested``, epoch for epoch as in the JAX package."""
    class Recorder:
        def __init__(self, stop_at=None):
            self.seen, self.stop_at = [], stop_at
            self.stop_requested = False

        def on_epoch_end(self, epoch, rep, ff):
            self.seen.append((epoch, rep["loss"], ff))
            self.stop_requested = epoch == self.stop_at

    xs, ys = _small_seq_data()
    pair = _keras_pair(lambda k: _keras_seq(k, (8, 4)), "sgd", [], 16)
    hist, recs = {}, {}
    for key in ("jax", "port"):
        ff = pair[key].ffmodel
        recs[key] = [Recorder(), Recorder(stop_at=2)]
        hist[key] = ff.fit(xs, ys, epochs=6, verbose=False,
                           callbacks=recs[key])
        assert len(hist[key]) == 3
        for r in recs[key]:
            assert [e for e, _, _ in r.seen] == [0, 1, 2]
            assert all(m is ff for _, _, m in r.seen)
            assert [v for _, v, _ in r.seen] == \
                [h["loss"] for h in hist[key]]
    _assert_histories(hist["port"], hist["jax"])


def test_lr_scheduler_reaches_the_fused_adam_kernel():
    """A scheduled Adam rate lands in the fused kernel's alpha_t: a Keras
    model on the fused plan (the kernel's plain version on the CPU) with
    the rate scheduled to 0.02 after epoch 0 trains as an unfused twin
    whose alpha is set to 0.02 by hand after the same epoch. (The JAX
    package's scheduler writes ``opt.lr`` first, which its AdamOptimizer
    exposes read-only, so it has no Adam run to compare with.)"""
    from flexflow_tpu_torch.frontends.keras.callbacks import \
        LearningRateScheduler
    xs, ys = _small_seq_data()
    models = []
    for fused in (True, False):
        m = _keras_seq(keras, (8, 4))
        m.compile("adam", "sparse_categorical_crossentropy", [],
                  config=_cfg(fft, 16), batch_size=16)
        if fused:
            m.ffmodel.executor._kernel_impls["opt_update"] = "fused"
        models.append(m)
    load_reference_params(models[1].ffmodel,
                          {ln: {wn: w.numpy() for wn, w in ws.items()}
                           for ln, ws in models[0].ffmodel.params.items()},
                          _layer_names(models[0].ffmodel))
    calls = fused_adam_update.plain_calls
    alphas = []

    def schedule(e):
        alphas.append(models[0].ffmodel.optimizer.alpha_t(
            1, torch.device("cpu")).item())
        return 0.02 * e

    h_fused = models[0].fit(xs, ys, epochs=3, verbose=False,
                            callbacks=[LearningRateScheduler(schedule)])
    assert fused_adam_update.plain_calls - calls == 3 * 4
    assert models[0].ffmodel.optimizer.alpha == pytest.approx(0.06)

    class SetAlpha:   # the twin's rate, set by hand after each epoch
        def on_epoch_end(self, epoch, rep, ff):
            ff.optimizer.alpha = 0.02 * (epoch + 1)

    h_twin = models[1].ffmodel.fit(xs, ys, epochs=3, verbose=False,
                                   callbacks=[SetAlpha()])
    _assert_histories(h_fused, h_twin, keys=("loss",))
    # alpha_t (here at step 1: alpha * sqrt(1 - beta2) / (1 - beta1), in
    # f32) follows the schedule: alpha 1e-3, then 0.02, 0.04
    np.testing.assert_allclose(
        alphas, np.array([1e-3, 0.02, 0.04]) * np.sqrt(1e-3) / 0.1,
        rtol=2e-5)
    for a, b in zip(models[0].ffmodel.layers, models[1].ffmodel.layers):
        for wn, w in models[0].ffmodel.params.get(a.name, {}).items():
            np.testing.assert_allclose(
                w.numpy(), models[1].ffmodel.params[b.name][wn].numpy(),
                atol=ATOL)


def _onnx_mlp(w, rng):
    return w.make_model(
        [w.make_node("Gemm", ["x", "w1", "b1"], ["h"], name="fc1",
                     transB=1),
         w.make_node("Relu", ["h"], ["r"], name="relu1"),
         w.make_node("MatMul", ["r", "w2"], ["y0"], name="fc2"),
         w.make_node("Softmax", ["y0"], ["y"], name="sm", axis=-1)],
        [w.make_value_info("x", 1, (4, 8))],
        [w.make_value_info("y", 1, (4, 3))],
        [w.make_tensor("w1", rng.normal(size=(16, 8)).astype(np.float32)),
         w.make_tensor("b1", rng.normal(size=16).astype(np.float32)),
         w.make_tensor("w2", rng.normal(size=(16, 3)).astype(np.float32))])


def _onnx_cnn(w, rng):
    return w.make_model(
        [w.make_node("Conv", ["x", "cw", "cb"], ["c"], name="conv",
                     kernel_shape=[3, 3], strides=[1, 1],
                     pads=[1, 1, 1, 1]),
         w.make_node("BatchNormalization", ["c"], ["n"], name="bn"),
         w.make_node("Relu", ["n"], ["r"], name="relu"),
         w.make_node("MaxPool", ["r"], ["p"], name="pool",
                     kernel_shape=[2, 2], strides=[2, 2]),
         w.make_node("Flatten", ["p"], ["f"], name="flat"),
         w.make_node("Gemm", ["f", "gw", "gb"], ["y"], name="fc",
                     transB=1)],
        [w.make_value_info("x", 1, (2, 3, 8, 8))],
        [w.make_value_info("y", 1, (2, 5))],
        [w.make_tensor("cw", rng.normal(size=(4, 3, 3, 3))
                       .astype(np.float32)),
         w.make_tensor("cb", rng.normal(size=4).astype(np.float32)),
         w.make_tensor("gw", rng.normal(size=(5, 64)).astype(np.float32)),
         w.make_tensor("gb", rng.normal(size=5).astype(np.float32))])


@pytest.mark.parametrize("which", ["mlp", "cnn"])
def test_onnx_apply_matches_jax(which):
    """ONNXModel.apply from wire bytes (each package's own encoder, the
    bytes checked equal) in both packages: the same layers, initializers
    copied alike, the same outputs from the same params."""
    make = {"mlp": _onnx_mlp, "cnn": _onnx_cnn}[which]
    data = make(wire, np.random.default_rng(0))
    assert data == make(jax_wire, np.random.default_rng(0))
    shape = (4, 8) if which == "mlp" else (2, 3, 8, 8)
    made = {}
    for key, om_cls in (("jax", JaxONNXModel), ("port", ONNXModel)):
        pkg = PKGS[key][0]
        ff = pkg.FFModel(_cfg(pkg, shape[0]))
        x = ff.create_tensor(shape, name="x")
        om = om_cls(data)
        outs = om.apply(ff, {"x": x})
        ff.compile(pkg.SGDOptimizer(0.01), "identity", [],
                   output_tensor=outs[0])
        om.copy_weights(ff)
        made[key] = ff
    _carry(made["jax"], made["port"])
    x = _normal(shape, 6)
    got, want = _forwards(made, {"x": x})
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    if which == "mlp":   # the initializers reached the right weights
        m = ONNXModel(data)
        ini = m.initializers
        h = np.maximum(x @ ini["w1"].T + ini["b1"], 0) @ ini["w2"]
        e = np.exp(h - h.max(-1, keepdims=True))
        np.testing.assert_allclose(got, e / e.sum(-1, keepdims=True),
                                   atol=1e-5)


class _TinyBlock(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.attn = nn.MultiheadAttention(d, heads, batch_first=True)
        self.ln1 = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, 2 * d)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(2 * d, d)
        self.ln2 = nn.LayerNorm(d)

    def forward(self, x):
        a, _ = self.attn(x, x, x)
        x = self.ln1(x + a)
        return self.ln2(x + self.fc2(self.act(self.fc1(x))))


class _TinyEncoder(nn.Module):
    """The chip check's BERT-shaped encoder at hidden 32, 4 heads."""

    def __init__(self, layers=2, d=32, heads=4, vocab=50, seq=8):
        super().__init__()
        self.seq = seq
        self.tok = nn.Embedding(vocab, d)
        self.pos = nn.Embedding(seq, d)
        self.blocks = nn.ModuleList(_TinyBlock(d, heads)
                                    for _ in range(layers))
        self.head = nn.Linear(d, 2)

    def forward(self, ids):
        x = self.tok(ids) + self.pos(torch.arange(self.seq))
        for b in self.blocks:
            x = b(x)
        return torch.softmax(self.head(x[:, 0]), dim=-1)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_fx_attention_encoder_matches_jax(impl):
    """A 2-layer nn.MultiheadAttention encoder (hidden 32, 4 heads) with a
    folded position constant, imported through fx under each attention
    impl (the flash kernel's plain version on the CPU): forward and
    three SGD steps against the JAX import."""
    torch.manual_seed(0)
    pair = _fx_pair(_TinyEncoder(), [("input_ids", (2, 8), "int32")], 2,
                    impl=impl, loss="sparse_categorical_crossentropy")
    tff = pair["port"]
    assert len(tff.const_inputs) == 1
    pos = tff.const_inputs[0]
    np.testing.assert_array_equal(pos.get_tensor(), np.arange(8))
    staged = tff.executor.program._staged[pos.guid][2]
    ids = _hf_ids(50, (2, 8), 7)
    calls = flash_attention.plain_calls
    got, want = _forwards(pair, {"input_ids": ids})
    assert flash_attention.plain_calls - calls == (2 if impl == "flash"
                                                   else 0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    y = np.random.default_rng(8).integers(0, 2, (6, 1)).astype(np.int32)
    x = _hf_ids(50, (6, 8), 9)
    hj = pair["jax"].fit([x], y, epochs=3, verbose=False)
    ht = tff.fit([x], y, epochs=3, verbose=False)
    _assert_histories(ht, hj, keys=("loss",))
    # the constant went to the device once, at compile
    assert tff.executor.program._staged[pos.guid][2] is staged


def test_copied_weights_are_contiguous_copies():
    """``copy_weights`` hands ``set_weights`` transposed views of the torch
    module's weights: each leaf becomes a contiguous copy (the fused
    Adam kernel takes contiguous leaves only, and the optimizers update
    leaves in place, which must not write through to the module)."""
    torch.manual_seed(0)
    net = SeqNet()
    ff = fft.FFModel(_cfg(fft, 4))
    x = ff.create_tensor((4, 8), name="x")
    pm = PyTorchModel(net)
    outs = pm.torch_to_ff(ff, [x])
    ff.compile(fft.AdamOptimizer(0.1), "identity", [],
               output_tensor=outs[0])
    pm.copy_weights(ff)
    before = net.seq[0].weight.detach().clone()
    kernel = ff.params["seq_0"]["kernel"]
    assert kernel.is_contiguous()
    np.testing.assert_array_equal(kernel.numpy(), before.numpy().T)
    ff.executor._kernel_impls["opt_update"] = "fused"
    ff.fit([_normal((4, 8), 1)], _normal((4, 2), 2), epochs=1,
           verbose=False)
    assert not np.allclose(ff.params["seq_0"]["kernel"].numpy(),
                           before.numpy().T)
    assert torch.equal(net.seq[0].weight.detach(), before)
