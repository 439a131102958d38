"""The port's LSTM, NMT and Transformer against the JAX package: the LSTM
op (1 and 2 layers) on the same inputs and weights, outputs and
``jax.grad`` against ``torch.autograd.grad``, and against a numpy
transcription of the recurrence; then tiny ``build_nmt`` and
``build_transformer`` models built through ``FFModel`` in both, the
reference's weights carried into the port by ``interop``, under the
plain attention and under ``attention:flash`` (the JAX Pallas kernel in
interpret mode, the port's kernel through its plain version on the CPU):
outputs and SGD loss histories.

f32 throughout (``use_bf16_compute=False``): the two packages differ
only in the order of their f32 sums, and everything holds to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu import models as jm
from flexflow_tpu.ops import get_op_def as jax_op
from flexflow_tpu.ops.registry import EmitCtx as JaxCtx
from flexflow_tpu_torch import models as tm
from flexflow_tpu_torch.interop import load_reference_params
from flexflow_tpu_torch.kernels import flash_attention
from flexflow_tpu_torch.ops import get_op_def as torch_op
from flexflow_tpu_torch.ops.registry import EmitCtx as TorchCtx

TOL = dict(atol=1e-5, rtol=1e-5)
OT = ffj.OperatorType


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _lstm_weights(params, d, seed=0):
    specs = jax_op(OT.OP_LSTM).weights(params, [(1, 1, d)],
                                       [ffj.DataType.DT_FLOAT])
    assert [(s.name, s.shape) for s in specs] == \
        [(s.name, s.shape) for s in torch_op(int(OT.OP_LSTM)).weights(
            params, [(1, 1, d)], [fft.DataType.DT_FLOAT])]
    rng = np.random.default_rng(seed)
    return {s.name: (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
            for s in specs}


def _cfgs():
    cj, ct = ffj.FFConfig(), fft.FFConfig()
    for c in (cj, ct):
        c.use_bf16_compute = False
    return cj, ct


def _sig(v):
    return 1.0 / (1.0 + np.exp(-v))


def _numpy_lstm(x, w, layers, h):
    """The recurrence of ``tests/test_models.py``'s numpy LSTM: gate order
    i, f, g, o, +1 forget bias, zero initial state, layer by layer."""
    y = x.astype(np.float64)
    for l in range(layers):
        wl, bl = w[f"w{l}"], w[f"b{l}"]
        d = y.shape[-1]
        hs = np.zeros((x.shape[0], h))
        cs = np.zeros((x.shape[0], h))
        out = []
        for t in range(x.shape[1]):
            z = y[:, t] @ wl[:d] + hs @ wl[d:] + bl
            i, f, g, o = np.split(z, 4, axis=-1)
            cs = _sig(f + 1.0) * cs + _sig(i) * np.tanh(g)
            hs = _sig(o) * np.tanh(cs)
            out.append(hs)
        y = np.stack(out, axis=1)
    return y


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_matches_jax_and_the_numpy_recurrence(layers):
    params = {"hidden_size": 6, "num_layers": layers}
    x = _x(3, 7, 5)
    w = _lstm_weights(params, 5)
    cj, ct = _cfgs()
    op_j, op_t = jax_op(OT.OP_LSTM), torch_op(int(OT.OP_LSTM))
    (out_j,) = op_j.emit(params, [jnp.asarray(x)],
                         {k: jnp.asarray(v) for k, v in w.items()},
                         JaxCtx(True, config=cj), "rnn")
    cot = _x(*out_j.shape, seed=2)

    def loss_j(xj, wj):
        (o,) = op_j.emit(params, [xj], wj, JaxCtx(True, config=cj), "rnn")
        return jnp.sum(o * cot)

    gx, gw = jax.grad(loss_j, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()})
    xt = torch.tensor(x, requires_grad=True)
    wt = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    (out_t,) = op_t.emit(params, [xt], wt, TorchCtx(True, config=ct), "rnn")
    assert tuple(out_t.shape) == (3, 7, 6)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(out_t.detach().numpy(),
                               _numpy_lstm(x, w, layers, 6), **TOL)
    gt = torch.autograd.grad((out_t * torch.from_numpy(cot)).sum(),
                             [xt] + list(wt.values()))
    for g, want in zip(gt, [gx] + [gw[k] for k in wt]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL)


def test_lstm_bf16_rounds_only_the_products_operands():
    """bf16 compute: the recurrent products take bf16 operands (h cast
    each step) and f32 results in both; h and c stay f32."""
    params = {"hidden_size": 8, "num_layers": 2}
    x = _x(2, 5, 8)
    w = _lstm_weights(params, 8)
    cj, ct = ffj.FFConfig(), fft.FFConfig()
    (want,) = jax_op(OT.OP_LSTM).emit(
        params, [jnp.asarray(x)], {k: jnp.asarray(v) for k, v in w.items()},
        JaxCtx(False, config=cj), "rnn")
    (got,) = torch_op(int(OT.OP_LSTM)).emit(
        params, [torch.tensor(x)], {k: torch.tensor(v) for k, v in w.items()},
        TorchCtx(False, config=ct), "rnn")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    f32 = _numpy_lstm(x, w, 2, 8)
    assert np.abs(got.numpy() - f32).max() > 1e-4   # bf16 operands bite


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
def _pair(impl, build, batch, args_of, loss):
    """The same model in both packages (f32, SGD 0.05) under
    ``attention:impl``, the JAX weights carried into the port;
    ``args_of(zoo)`` gives the builder's arguments after the batch."""
    models = []
    for pkg, zoo, extra in ((ffj, jm, {}), (fft, tm, {"device": "cpu"})):
        cfg = pkg.FFConfig()
        cfg.batch_size = batch
        cfg.only_data_parallel = True
        cfg.use_bf16_compute = False
        cfg.kernel_impls = f"attention:{impl}"
        ff = pkg.FFModel(cfg, **extra)
        out = getattr(zoo, build)(ff, batch, *args_of(zoo))
        ff.compile(pkg.SGDOptimizer(0.05), loss, [], output_tensor=out)
        models.append(ff)
    jff, ff = models
    load_reference_params(ff, jax.device_get(jff.params),
                          [(l.name, l.op_type) for l in jff.layers])
    return jff, ff


def _sgd_history(jff, ff, batches):
    hist = []
    for m in (jff, ff):
        step = m.executor.make_train_step()
        hist.append([float(np.asarray(m._run_train_step(step, b)["loss"]))
                     for b in batches])
    return hist


NMT_B, NMT_SRC, NMT_TGT = 4, 7, 5


def _nmt_args(zoo):
    return NMT_SRC, NMT_TGT, zoo.NMTConfig(
        src_vocab=96, tgt_vocab=96, embed_dim=32, hidden_size=32,
        num_layers=2, num_heads=1)


def _nmt_batch(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 96, (NMT_B, NMT_SRC)).astype(np.int32)
    tgt = rng.integers(1, 96, (NMT_B, NMT_TGT)).astype(np.int32)
    dec_in = np.concatenate([np.zeros((NMT_B, 1), np.int32), tgt[:, :-1]],
                            axis=1)
    return {"src_ids": src, "tgt_ids": dec_in, "label": tgt}


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_nmt_logits_and_sgd_history_match_jax(impl):
    jff, ff = _pair(impl, "build_nmt", NMT_B, _nmt_args,
                    "sparse_categorical_crossentropy")
    b0 = _nmt_batch(0)
    inputs = {k: v for k, v in b0.items() if k != "label"}
    want = np.asarray(jff.executor.make_forward()(jff.params, jff.state,
                                                  inputs))
    calls = flash_attention.plain_calls
    got = ff.executor.make_forward()(ff.params, ff.state, inputs)
    assert flash_attention.plain_calls - calls == (impl == "flash")
    assert tuple(got.shape) == (NMT_B, NMT_TGT, 96)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    hist = _sgd_history(jff, ff, [_nmt_batch(1 + i) for i in range(3)])
    np.testing.assert_allclose(hist[1], hist[0], atol=1e-5, rtol=0)


def test_nmt_config_defaults_are_the_jax_packages():
    assert tm.NMTConfig() == tm.NMTConfig(32000, 32000, 512, 512, 2, 1)
    import dataclasses
    assert dataclasses.asdict(tm.NMTConfig()) == \
        dataclasses.asdict(jm.NMTConfig())
    assert dataclasses.asdict(tm.TransformerConfig()) == \
        dataclasses.asdict(jm.TransformerConfig())


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_transformer_forward_and_mse_history_match_jax(impl):
    jff, ff = _pair(impl, "build_transformer", 4, lambda zoo: (
        zoo.TransformerConfig(hidden_size=32, embedding_size=32,
                              num_heads=4, num_layers=2,
                              sequence_length=16),), "mean_squared_error")
    mha = [l for l in ff.layers
           if l.op_type == fft.OperatorType.OP_MULTIHEAD_ATTENTION]
    # kdim = hidden / heads, split over the heads again: 2 wide each
    assert len(mha) == 2 and ff.params[mha[0].name]["wq"].shape == (32, 4, 2)
    x = _x(4, 16, 32)
    want = np.asarray(jff.executor.make_forward()(jff.params, jff.state,
                                                  {"input": x}))
    calls = flash_attention.plain_calls
    got = ff.executor.make_forward()(ff.params, ff.state, {"input": x})
    assert flash_attention.plain_calls - calls == 2 * (impl == "flash")
    assert tuple(got.shape) == (4, 16, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    batches = [{"input": _x(4, 16, 32, seed=3 + i),
                "label": _x(4, 16, 1, seed=9 + i)} for i in range(3)]
    hist = _sgd_history(jff, ff, batches)
    np.testing.assert_allclose(hist[1], hist[0], atol=1e-5, rtol=0)
