"""The port's flash attention (flexflow_tpu_torch/kernels/
flash_attention.py), forward and backward, against the JAX package's
Pallas kernels.

On the CPU the port's wrapper and its autograd Function run the plain
versions; the JAX kernels run in interpret mode, as tests/test_kernels.py
runs them, and their gradients come from ``jax.grad`` through the JAX
custom VJP. The same numpy inputs, made from a seed, go to both. f32
forward cases hold to atol = rtol = 2e-5, the tolerance of
tests/test_kernels.py (the two differ only in the order of their f32 sums
and in online vs one-pass softmax); f32 gradients, sums of up to 128
products of O(1) terms, hold to atol = rtol = 1e-4; bf16 gradients are
written in bf16 after ds and p_eff were rounded to bf16, so they hold to
one bf16 ulp of the largest gradient (2**-8 of it, relative) plus the
same absolute slack. The dropout keep mask is a pure integer hash and
must agree bit for bit.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import dropout_keep_mask as jax_keep_mask
from flexflow_tpu.kernels import flash_attention as jax_flash
from flexflow_tpu.ops.nn_ops import MultiHeadAttentionOp as JaxMHA
from flexflow_tpu_torch.kernels import dropout_keep_mask, flash_attention
from flexflow_tpu_torch.kernels import flash_attention_plain, mha_reference
from flexflow_tpu_torch.ops.nn_ops import MultiHeadAttentionOp as TorchMHA

jax_fa = importlib.import_module("flexflow_tpu.kernels.flash_attention")

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(b, h, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32))


def _port(q, k, v, **kw):
    return flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)


def _jax(q, k, v, **kw):
    return np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                interpret=True, **kw))


def _jax_lse(q, k, v, causal=False, dropout_rate=0.0, seed=0):
    """The lse of the JAX forward kernel, padded exactly as the JAX
    ``flash_attention`` wrapper pads before calling ``_fwd_call``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    block_q = min(512, -(-sq // 8) * 8)
    block_k = min(512, -(-sk // 128) * 128)

    def pad(x, s_mult):
        s, dd = x.shape[2], x.shape[3]
        return jnp.pad(jnp.asarray(x), ((0, 0), (0, 0),
                                        (0, -s % s_mult), (0, -dd % 64)))

    qp, kp, vp = pad(q, block_q), pad(k, block_k), pad(v, block_k)
    flat = [x.reshape(b * h, x.shape[2], x.shape[3]) for x in (qp, kp, vp)]
    _, lse = jax_fa._fwd_call(*flat, jnp.full((1, 1), seed, jnp.int32), sk,
                              1.0 / np.sqrt(d), causal, block_q, block_k,
                              dropout_rate, True)
    return np.asarray(lse).reshape(b, h, -1)[:, :, :sq]


@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (1, 2, 128, 128, 64, False),
    (1, 2, 128, 128, 64, True),
    (1, 2, 200, 200, 48, False),     # ragged seq, head dim padded to 64
    (1, 2, 200, 200, 48, True),
    (2, 2, 96, 200, 64, False),      # cross-attention, sq != sk
])
def test_flash_forward_matches_jax(b, h, sq, sk, d, causal):
    q, k, v = _qkv(b, h, sq, sk, d)
    out = _port(q, k, v, causal=causal)
    assert out.dtype == torch.float32 and out.shape == (b, h, sq, d)
    np.testing.assert_allclose(out.numpy(), _jax(q, k, v, causal=causal),
                               **TOL)


def test_flash_forward_gqa_after_expand_kv():
    """GQA: 4 query heads over 2 kv heads, expanded by each package's own
    ``_expand_kv`` in the (B, L, heads, d) layout before the kernel."""
    rng = np.random.default_rng(3)
    qh = rng.standard_normal((2, 64, 4, 32)).astype(np.float32)
    kh = rng.standard_normal((2, 64, 2, 32)).astype(np.float32)
    vh = rng.standard_normal((2, 64, 2, 32)).astype(np.float32)
    kj = JaxMHA._expand_kv(jnp.asarray(kh), 4)
    vj = JaxMHA._expand_kv(jnp.asarray(vh), 4)
    kt = TorchMHA._expand_kv(torch.from_numpy(kh), 4)
    vt = TorchMHA._expand_kv(torch.from_numpy(vh), 4)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    want = np.asarray(jax_flash(jnp.swapaxes(jnp.asarray(qh), 1, 2),
                                jnp.swapaxes(kj, 1, 2),
                                jnp.swapaxes(vj, 1, 2), interpret=True))
    got = flash_attention(torch.from_numpy(qh).transpose(1, 2).contiguous(),
                          kt.transpose(1, 2).contiguous(),
                          vt.transpose(1, 2).contiguous())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("sq,d,causal", [(200, 48, False), (128, 64, True)])
def test_flash_lse_matches_jax_fwd_call(sq, d, causal):
    q, k, v = _qkv(1, 2, sq, sq, d, seed=5)
    _, lse = _port(q, k, v, causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (1, 2, sq)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, causal), **TOL)


@pytest.mark.parametrize("b,h,sq,sk,rate,seed", [
    (2, 3, 17, 33, 0.1, 0),
    (1, 2, 64, 64, 0.5, 12345),
    (2, 2, 40, 50, 0.3, 2 ** 31 - 1),    # int32 wrap of seed * constant
    (1, 1, 30, 30, 0.9, 2 ** 31 - 5),
    (1, 4, 16, 128, 0.25, -7),
    (1, 1, 8, 8, 0.0, 3),                # threshold 0: keeps everything
])
def test_dropout_keep_mask_bit_identical(b, h, sq, sk, rate, seed):
    want = np.asarray(jax_keep_mask(b, h, sq, sk, rate, seed))
    got = dropout_keep_mask(b, h, sq, sk, rate, seed).numpy()
    assert got.dtype == np.bool_ and got.shape == (b, h, sq, sk)
    np.testing.assert_array_equal(got, want)
    if 0.0 < rate:
        assert abs(1.0 - got.mean() - rate) < 0.15


def _jax_dropout_golden(q, k, v, causal, rate, seed):
    """The JAX package's explicit-mask golden of its in-kernel dropout:
    ``where(keep, softmax(s) / (1 - rate), 0) @ v`` with its own
    ``dropout_keep_mask`` (the Pallas kernel itself does not lower its
    dropout under a causal ``pl.when`` in interpret mode)."""
    b, h, sq, d = q.shape
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(d)
    if causal:
        s = jnp.where(np.tril(np.ones((sq, sq), bool)), s, jax_fa.NEG_INF)
    p = jax.nn.softmax(s, axis=-1)
    keep = jax_keep_mask(b, h, sq, k.shape[2], rate, seed)
    p = jnp.where(keep, p / (1.0 - rate), 0.0)
    return np.asarray(jnp.einsum("bhqk,bhkd->bhqd", p, v))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_dropout_matches_jax(causal):
    q, k, v = _qkv(1, 2, 128, 128, 64, seed=7)
    kw = dict(causal=causal, dropout_rate=0.2, dropout_seed=1234)
    got = _port(q, k, v, **kw).numpy()
    np.testing.assert_allclose(
        got, _jax_dropout_golden(q, k, v, causal, 0.2, 1234), **TOL)
    if not causal:
        np.testing.assert_allclose(got, _jax(q, k, v, **kw), **TOL)
    # dropout scales only the numerator: lse is the undropped one
    _, lse = _port(q, k, v, return_lse=True, **kw)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, causal),
                               **TOL)


def test_plain_version_matches_mha_reference_and_counts_calls():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 2, 64, 64, 32, seed=9))
    before = flash_attention.plain_calls, flash_attention.launches
    o = flash_attention(q, k, v, causal=True)
    assert flash_attention.plain_calls == before[0] + 1
    assert flash_attention.launches == before[1]   # no kernel on the CPU
    torch.testing.assert_close(o, mha_reference(q, k, v, causal=True),
                               **TOL)
    o2, _ = flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(o, o2, atol=0.0, rtol=0.0)


def test_flash_bf16_rounds_p_like_jax():
    """bf16 inputs: p is cast to bf16 before the P.V product and o is
    written in bf16, in both packages (one bf16 ulp apart at most)."""
    q, k, v = _qkv(1, 2, 64, 64, 64, seed=11)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = flash_attention(qb, kb, vb)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_flash(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (q, k, v)),
                                interpret=True)).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1.6e-2)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 32, 48, 16))
    with pytest.raises(NotImplementedError, match="causal"):
        flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(*(t.transpose(2, 3).contiguous().transpose(2, 3)
                          for t in (q, k, v)))
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="matching q"):
        flash_attention(q, k[:, :1], v)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
bwd_mod = importlib.import_module("flexflow_tpu_torch.kernels.flash_attention")


def _port_grads(q, k, v, do, dtype=torch.float32, **kw):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o = flash_attention(*ts, **kw)
    o.backward(torch.from_numpy(do).to(dtype))
    return [t.grad.float().numpy() for t in ts]


def _jax_grads(q, k, v, do, dtype=jnp.float32, **kw):
    def f(q_, k_, v_):
        o = jax_flash(q_, k_, v_, interpret=True, **kw)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do))
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    return [np.asarray(g).astype(np.float32)
            for g in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _do(b, h, sq, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, h, sq, d)).astype(np.float32)


@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (1, 2, 128, 128, 64, False),
    (1, 2, 128, 128, 64, True),
    (1, 2, 100, 100, 48, False),     # ragged seq, head dim padded to 64
    (1, 2, 100, 100, 48, True),
    (2, 2, 64, 100, 64, False),      # cross-attention, sq != sk
])
def test_flash_backward_matches_jax(b, h, sq, sk, d, causal):
    q, k, v = _qkv(b, h, sq, sk, d, seed=21)
    do = _do(b, h, sq, d)
    got = _port_grads(q, k, v, do, causal=causal)
    want = _jax_grads(q, k, v, do, causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD_TOL)


def test_flash_backward_bf16_matches_jax():
    q, k, v = _qkv(1, 2, 64, 64, 64, seed=23)
    do = _do(1, 2, 64, 64)
    got = _port_grads(q, k, v, do, torch.bfloat16)
    want = _jax_grads(q, k, v, do, jnp.bfloat16)
    for name, g, w in zip("qkv", got, want):
        ulp = np.abs(w).max() * 2.0 ** -8
        np.testing.assert_allclose(g, w, atol=ulp + 1e-4, rtol=0,
                                   err_msg=f"d{name}")


def test_flash_backward_dropout_matches_jax():
    """Non-causal dropout: the JAX kernels and the port's plain backward
    rebuild one keep mask from the same (seed, bh, q, k) tuple."""
    q, k, v = _qkv(1, 2, 128, 128, 64, seed=25)
    do = _do(1, 2, 128, 64)
    kw = dict(dropout_rate=0.2, dropout_seed=1234)
    got = _port_grads(q, k, v, do, **kw)
    want = _jax_grads(q, k, v, do, **kw)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD_TOL)


def test_flash_backward_causal_dropout_matches_jax_golden():
    """Causal dropout against ``jax.grad`` of the explicit-mask golden:
    the JAX kernel does not lower causal dropout in interpret mode."""
    q, k, v = _qkv(1, 2, 128, 128, 64, seed=27)
    do = _do(1, 2, 128, 64)
    rate, seed = 0.2, 99
    got = _port_grads(q, k, v, do, causal=True, dropout_rate=rate,
                      dropout_seed=seed)

    def golden(q_, k_, v_):
        s = jnp.einsum("bhqd,bhkd->bhqk", q_, k_) / np.sqrt(64)
        s = jnp.where(np.tril(np.ones((128, 128), bool)), s, jax_fa.NEG_INF)
        p = jax.nn.softmax(s, axis=-1)
        keep = jax_keep_mask(1, 2, 128, 128, rate, seed)
        p = jnp.where(keep, p / (1.0 - rate), 0.0)
        return jnp.sum(jnp.einsum("bhqk,bhkd->bhqd", p, v_)
                       * jnp.asarray(do))

    want = jax.grad(golden, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"d{name}",
                                   **GRAD_TOL)


# The shapes at the edges of the bf16 kernels' tiling (64-key tiles in a
# ring of two stages, CTAs of 64 or 128 query rows, 32-query tiles in the
# d = 128 dk/dv kernel), which chip_smoke.py holds the kernels to on the
# card: one short K tile, fewer tiles than ring stages, s not a multiple
# of 64 or 128 with and without causal, sq != sk both ways, d = 128 with
# dropout; then the dq kernel's own (64-row CTAs over 64-key tiles): many
# query CTAs over one short K tile, few rows over many K tiles, causal
# diagonals at one and one and a half tiles, d = 128 with dropout at a
# ragged causal s. Here the plain versions that the card compares the
# kernels with are held against the JAX kernels.
TILING_CASES = [  # (sq, sk, d, causal, dropout rate)
    (40, 40, 64, False, 0.0),
    (40, 40, 64, True, 0.1),
    (64, 64, 64, True, 0.0),
    (100, 100, 64, False, 0.1),
    (200, 200, 64, True, 0.1),
    (320, 320, 64, False, 0.0),
    (320, 320, 64, True, 0.1),
    (96, 200, 64, False, 0.0),
    (320, 512, 64, False, 0.1),
    (512, 200, 64, False, 0.0),
    (320, 320, 128, False, 0.1),
    (200, 200, 128, False, 0.1),
    (512, 40, 64, False, 0.0),
    (40, 512, 64, False, 0.1),
    (128, 128, 64, True, 0.0),
    (192, 192, 64, True, 0.1),
    (100, 100, 128, True, 0.1),
]


def _jax_dropout_golden_grads(q, k, v, do, rate, seed):
    """``jax.grad`` of the causal explicit-mask golden (the JAX kernel
    does not lower causal dropout in interpret mode)."""
    b, h, sq, d = q.shape

    def golden(q_, k_, v_):
        s = jnp.einsum("bhqd,bhkd->bhqk", q_, k_) / np.sqrt(d)
        s = jnp.where(np.tril(np.ones((sq, sq), bool)), s, jax_fa.NEG_INF)
        p = jax.nn.softmax(s, axis=-1)
        keep = jax_keep_mask(b, h, sq, sq, rate, seed)
        p = jnp.where(keep, p / (1.0 - rate), 0.0)
        return jnp.sum(jnp.einsum("bhqk,bhkd->bhqd", p, v_)
                       * jnp.asarray(do))

    return [np.asarray(g) for g in jax.grad(golden, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))]


@pytest.mark.parametrize("sq,sk,d,causal,rate", TILING_CASES)
def test_flash_forward_tiling_edges_match_jax(sq, sk, d, causal, rate):
    q, k, v = _qkv(1, 2, sq, sk, d, seed=31)
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=77 if rate else None)
    o, lse = _port(q, k, v, return_lse=True, **kw)
    want = (_jax_dropout_golden(q, k, v, True, rate, 77) if causal and rate
            else _jax(q, k, v, **kw))
    np.testing.assert_allclose(o.numpy(), want, **TOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, causal), **TOL)


@pytest.mark.parametrize("sq,sk,d,causal,rate", TILING_CASES)
def test_flash_backward_tiling_edges_match_jax(sq, sk, d, causal, rate):
    q, k, v = _qkv(1, 2, sq, sk, d, seed=33)
    do = _do(1, 2, sq, d, seed=3)
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=55 if rate else None)
    got = _port_grads(q, k, v, do, **kw)
    want = (_jax_dropout_golden_grads(q, k, v, do, rate, 55)
            if causal and rate else _jax_grads(q, k, v, do, **kw))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD_TOL)


def test_backward_plain_is_the_functions_backward_and_counts_calls():
    """``flash_attention_bwd_plain`` (the JAX ``_flash_bwd_rule`` in
    plain PyTorch) gives exactly what the autograd Function's backward
    gives on the CPU, where each backward wrapper runs its plain version
    once per backward and launches nothing."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 2, 64, 64, 64, seed=29))
    do = torch.from_numpy(_do(2, 2, 64, 64))
    kw = dict(causal=True, dropout_rate=0.1, dropout_seed=7)
    o, lse = bwd_mod.flash_attention_plain(q, k, v, sm_scale=0.125,
                                           dropout_seed=7, causal=True,
                                           dropout_rate=0.1)
    want = bwd_mod.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             sm_scale=0.125, **kw)
    dq_fn, dkv_fn = bwd_mod.flash_attention_bwd_dq, \
        bwd_mod.flash_attention_bwd_dkv
    before = (dq_fn.plain_calls, dkv_fn.plain_calls, dq_fn.launches,
              dkv_fn.launches)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*ts, **kw).backward(do)
    assert (dq_fn.plain_calls, dkv_fn.plain_calls) == \
        (before[0] + 1, before[1] + 1)
    assert (dq_fn.launches, dkv_fn.launches) == before[2:]
    for t, w in zip(ts, want):
        torch.testing.assert_close(t.grad, w, atol=0.0, rtol=0.0)


def test_backward_wrappers_reject_what_the_kernels_do_not_take():
    """The kernels' input check refuses what they do not take; a CPU
    tensor goes to the plain version instead."""
    q = torch.zeros(1, 1, 8, 64)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="cuda tensors"):
        bwd_mod._kernel_inputs(q, q)
    out = bwd_mod.flash_attention_bwd_dq(q, q, q, q, lse, lse)
    assert out.shape == q.shape and out.dtype == q.dtype
    dk, dv = bwd_mod.flash_attention_bwd_dkv(q, q, q, q, lse, lse)
    assert dk.shape == dv.shape == q.shape
