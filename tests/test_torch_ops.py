"""Each operator of the port's serving slice against the JAX package's
``OpDef.emit`` on the same numpy inputs and weights.

f32 compute (``use_bf16_compute=False``) holds to atol = rtol = 2e-5: the
two differ only in the order of their f32 sums. The bf16-compute Linear
case checks the port's ``matmul`` keeps an f32 result from bf16 operands
as JAX's ``preferred_element_type`` does (on the CPU both widen exact bf16
products into f32 sums), at 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.ops import get_op_def as jax_op
from flexflow_tpu.ops.registry import EmitCtx as JaxCtx
from flexflow_tpu_torch.ops import get_op_def as torch_op
from flexflow_tpu_torch.ops.registry import EmitCtx as TorchCtx
from flexflow_tpu_torch.ops.registry import mm_f32

TOL = dict(atol=2e-5, rtol=2e-5)
OT = ffj.OperatorType


def _ctxs(bf16=False, impl=None):
    cj, ct = ffj.FFConfig(), fft.FFConfig()
    for c in (cj, ct):
        c.use_bf16_compute = bf16
    j, t = JaxCtx(False, config=cj), TorchCtx(False, config=ct)
    if impl is not None:
        j.kernel_impls = t.kernel_impls = {"attention": impl}
    return j, t


def _run(op_type, params, inputs, in_dtypes=None, bf16=False, impl=None,
         seed=0):
    """Emit one op in both packages; weights drawn from the JAX specs."""
    op_j, op_t = jax_op(op_type), torch_op(int(op_type))
    shapes = [x.shape for x in inputs]
    dts = in_dtypes or [ffj.DataType.DT_FLOAT] * len(inputs)
    specs_j = op_j.weights(params, shapes, dts)
    specs_t = op_t.weights(params, shapes, [fft.DataType(int(d))
                                            for d in dts])
    assert [(s.name, s.shape) for s in specs_j] == \
        [(s.name, s.shape) for s in specs_t]
    rng = np.random.default_rng(seed)
    w = {s.name: (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
         for s in specs_j}
    cj, ct = _ctxs(bf16, impl)
    out_j = op_j.emit(params, [jnp.asarray(x) for x in inputs],
                      {k: jnp.asarray(v) for k, v in w.items()}, cj, "op")
    out_t = op_t.emit(params, [torch.from_numpy(x) for x in inputs],
                      {k: torch.from_numpy(v) for k, v in w.items()}, ct,
                      "op")
    assert len(out_j) == len(out_t) == 1
    want, got = np.asarray(out_j[0]), out_t[0]
    assert tuple(got.shape) == want.shape
    return got.numpy(), want


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("acti", ["NONE", "GELU", "TANH", "RELU"])
def test_linear(acti):
    params = {"out_dim": 8, "use_bias": True,
              "activation": ffj.ActiMode[f"AC_MODE_{acti}"]}
    got, want = _run(OT.OP_LINEAR, params, [_x(2, 5, 16)])
    np.testing.assert_allclose(got, want, **TOL)


def test_linear_bf16_compute_keeps_f32_result():
    params = {"out_dim": 8, "use_bias": False,
              "activation": ffj.ActiMode.AC_MODE_NONE}
    got, want = _run(OT.OP_LINEAR, params, [_x(2, 5, 16)], bf16=True)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    a = torch.from_numpy(_x(3, 16)).to(torch.bfloat16)
    b = torch.from_numpy(_x(16, 4, seed=2)).to(torch.bfloat16)
    assert mm_f32(a, b).dtype == torch.float32


@pytest.mark.parametrize("aggr", ["NONE", "SUM", "AVG"])
def test_embedding(aggr):
    params = {"num_entries": 20, "out_dim": 8,
              "aggr": ffj.AggrMode[f"AGGR_MODE_{aggr}"],
              "dtype": ffj.DataType.DT_FLOAT}
    ids = np.random.default_rng(3).integers(0, 20, (2, 5)).astype(np.int32)
    got, want = _run(OT.OP_EMBEDDING, params, [ids],
                     in_dtypes=[ffj.DataType.DT_INT32])
    np.testing.assert_allclose(got, want, **TOL)


def test_layer_norm():
    params = {"axes": [-1], "elementwise_affine": True, "eps": 1e-5}
    got, want = _run(OT.OP_LAYERNORM, params, [3.0 * _x(2, 5, 16) + 1.0])
    np.testing.assert_allclose(got, want, **TOL)


def test_softmax():
    got, want = _run(OT.OP_SOFTMAX, {"axis": -1}, [4.0 * _x(2, 5, 7)])
    np.testing.assert_allclose(got, want, **TOL)


def test_dropout_is_identity_in_inference():
    x = _x(2, 5, 16)
    got, want = _run(OT.OP_DROPOUT, {"rate": 0.1, "seed": 0}, [x])
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(want, x)


@pytest.mark.parametrize("shape_b", [(2, 5, 16), (16,)])
def test_add(shape_b):
    got, want = _run(OT.OP_EW_ADD, {}, [_x(2, 5, 16), _x(*shape_b, seed=2)])
    np.testing.assert_allclose(got, want, **TOL)


def test_reshape():
    got, want = _run(OT.OP_RESHAPE, {"shape": [2, 16]}, [_x(2, 1, 16)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("starts,ends,axes", [([0], [1], [1]),
                                              ([-2], [5], [1]),
                                              ([1, 2], [2, 10], [0, 2])])
def test_slice(starts, ends, axes):
    params = {"starts": starts, "ends": ends, "axes": axes}
    got, want = _run(OT.OP_SLICE, params, [_x(2, 5, 16)])
    np.testing.assert_array_equal(got, want)
    assert torch_op(int(OT.OP_SLICE)).infer(params, [(2, 5, 16)],
                                            [fft.DataType.DT_FLOAT]) == \
        jax_op(OT.OP_SLICE).infer(params, [(2, 5, 16)],
                                  [ffj.DataType.DT_FLOAT])


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("causal,kv_heads", [(False, 0), (True, 0),
                                             (False, 2)])
def test_multihead_attention(impl, causal, kv_heads):
    params = {"embed_dim": 32, "num_heads": 4, "kdim": 0, "vdim": 0,
              "dropout": 0.1, "bias": True, "add_bias_kv": False,
              "add_zero_attn": False, "causal": causal}
    if kv_heads:
        params["num_kv_heads"] = kv_heads
    x = _x(2, 16, 32)
    got, want = _run(OT.OP_MULTIHEAD_ATTENTION, params, [x, x, x],
                     impl=impl)
    np.testing.assert_allclose(got, want, **TOL)


def test_multihead_attention_cross_lengths():
    params = {"embed_dim": 32, "num_heads": 4, "kdim": 0, "vdim": 0,
              "dropout": 0.0, "bias": True, "add_bias_kv": False,
              "add_zero_attn": False, "causal": False}
    q, kv = _x(2, 8, 32), _x(2, 24, 32, seed=4)
    for impl in ("xla", "flash"):
        got, want = _run(OT.OP_MULTIHEAD_ATTENTION, params, [q, kv, kv],
                         impl=impl)
        np.testing.assert_allclose(got, want, **TOL)


def test_flash_auto_mode_keys_on_the_card():
    """"auto" takes the flash kernel on cuda from FLASH_AUTO_MIN_SEQ on,
    where the JAX package keys on the TPU; "true"/"false" force it."""
    mha = torch_op(int(OT.OP_MULTIHEAD_ATTENTION))
    n = mha.FLASH_AUTO_MIN_SEQ
    assert n == jax_op(OT.OP_MULTIHEAD_ATTENTION).FLASH_AUTO_MIN_SEQ
    _, ctx = _ctxs()
    assert mha._flash_enabled(ctx, n, "auto", device_type="cuda")
    assert not mha._flash_enabled(ctx, n - 1, "auto", device_type="cuda")
    assert not mha._flash_enabled(ctx, n, "auto", device_type="cpu")
    assert mha._flash_enabled(ctx, 1, "true", device_type="cpu")
    assert not mha._flash_enabled(ctx, n, "false", device_type="cuda")


def test_dropout_training_draws_from_the_layer_generator():
    """In training, dropout keeps each element with probability 1 - rate
    and scales survivors by 1 / (1 - rate); the bits come from the
    layer's generator (they differ from JAX's threefry by design)."""
    x = torch.ones(64, 256)
    op = torch_op(int(OT.OP_DROPOUT))

    def run(seed):
        ctx = TorchCtx(True, rngs={"d": torch.Generator().manual_seed(seed)})
        return op.emit({"rate": 0.25}, [x], {}, ctx, "d")[0]

    y = run(0)
    torch.testing.assert_close(torch.unique(y),
                               torch.tensor([0.0, 1.0 / 0.75]))
    assert abs((y == 0).float().mean().item() - 0.25) < 0.02
    torch.testing.assert_close(y, run(0), atol=0.0, rtol=0.0)
    with pytest.raises(RuntimeError, match="needs an rng"):
        op.emit({"rate": 0.25}, [x], {}, TorchCtx(True), "d")
