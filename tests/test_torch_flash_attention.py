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


# Head dims above 128: the reference pads d to a multiple of 64, so 192,
# 256, 320 and 512 run as they are, and 160 at 192. On the card they take the wide
# kernels; here the plain versions those kernels are held to on the card
# are held against the JAX kernels, to 1e-5 in f32 (sums of O(1) terms
# and up to 512-deep contractions, in another order and an online vs
# one-pass softmax). The last case is NMT's attention: NMTConfig
# (flexflow_tpu/models/nlp.py) has hidden 512 in one head, so build_nmt's
# cross-attention runs at d = 512 with sq != sk.
WIDE_TOL = dict(atol=1e-5, rtol=1e-5)
WIDE_CASES = [  # (sq, sk, d, causal)
    (100, 100, 192, False),
    (100, 100, 192, True),
    (72, 72, 256, False),
    (72, 72, 256, True),
    (64, 96, 256, False),
    (80, 80, 160, True),
    (40, 40, 320, True),
    (40, 40, 512, False),
    (24, 40, 512, False),
]


@pytest.mark.parametrize("sq,sk,d,causal", WIDE_CASES)
def test_flash_forward_wide_head_dims_match_jax(sq, sk, d, causal):
    q, k, v = _qkv(1, 2, sq, sk, d, seed=41)
    o, lse = _port(q, k, v, causal=causal, return_lse=True)
    assert o.shape == (1, 2, sq, d)
    np.testing.assert_allclose(o.numpy(), _jax(q, k, v, causal=causal),
                               **WIDE_TOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, causal),
                               **WIDE_TOL)


@pytest.mark.parametrize("sq,sk,d,causal", WIDE_CASES)
def test_flash_backward_wide_head_dims_match_jax(sq, sk, d, causal):
    q, k, v = _qkv(1, 2, sq, sk, d, seed=43)
    do = _do(1, 2, sq, d, seed=5)
    got = _port_grads(q, k, v, do, causal=causal)
    want = _jax_grads(q, k, v, do, causal=causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **WIDE_TOL)


def test_flash_predicate_names_the_head_dim_limit():
    """The kernels have no head-dim limit: d is padded to a multiple of
    64 and any width above 128 runs the wide kernels, so the forced-plan
    check accepts 300 (padded to 320), 320 and 512 on the card as it does
    on the CPU, whose plain version takes any d."""
    from flexflow_tpu_torch.kernels import attention_ctx, get_impl
    flash = get_impl("attention", "flash")
    for d in (64, 128, 160, 256, 300, 320, 512):
        params = {"num_heads": 2, "embed_dim": 2 * d, "causal": True}
        for backend in ("cuda", "cpu"):
            ctx = attention_ctx(params, 16, 16, backend=backend)
            assert flash.available(ctx) is None, (d, backend)
    q, k, v = _qkv(1, 1, 8, 8, 320)
    assert _port(q, k, v).shape == (1, 1, 8, 320)


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


# Wide head dims under dropout: the card holds the wide bf16 dk/dv kernel's
# dropout path (d 192 ... 512) against the port's plain backward, so that
# plain backward is held here against the JAX kernels (non-causal) and
# against jax.grad of the explicit-mask golden (causal, which the JAX
# kernel does not lower under dropout in interpret mode) at d 320 and 512.
WIDE_DROPOUT_CASES = [  # (sq, sk, d, causal)
    (72, 72, 320, False),
    (40, 56, 512, False),
    (48, 48, 320, True),
    (40, 40, 512, True),
]


@pytest.mark.parametrize("sq,sk,d,causal", WIDE_DROPOUT_CASES)
def test_flash_backward_wide_dropout_matches_jax(sq, sk, d, causal):
    q, k, v = _qkv(1, 2, sq, sk, d, seed=45)
    do = _do(1, 2, sq, d, seed=7)
    rate, seed = 0.2, 4321
    got = _port_grads(q, k, v, do, causal=causal, dropout_rate=rate,
                      dropout_seed=seed)
    want = (_jax_dropout_golden_grads(q, k, v, do, rate, seed) if causal
            else _jax_grads(q, k, v, do, dropout_rate=rate,
                            dropout_seed=seed))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **WIDE_TOL)


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


def _wide_wgmma_dims(src: str, launcher: str) -> set:
    """The head dims the C entry of csrc/<src> compiles a wide wgmma
    kernel for, read from its dispatch (``case D: ... <launcher><D>``)."""
    import os
    import re
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "flexflow_tpu_torch", "csrc", src)
    with open(path) as f:
        text = f.read()
    found = re.findall(rf"case (\d+):[^\n]*\b{launcher}<(\d+)>", text)
    assert all(a == b for a, b in found), found
    return {int(a) for a, _ in found}


def test_every_wide_wgmma_head_dim_has_a_card_case():
    """The wide bf16 forward, dq and dk/dv kernels are compiled for the
    same head dims, and each has bf16 cases in chip_smoke.py's kernel phase
    (after the wrapper's padding to a multiple of 64), causal and not, each
    with and without dropout, so the card checks every instantiation
    against its plain version; and so does bf16 above the largest, which
    keeps the wide FMA kernels."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fwd = _wide_wgmma_dims("flash_attention_fwd.cu", "launch_wgmma_wide")
    dq = _wide_wgmma_dims("flash_attention_bwd.cu", "launch_dq_wgmma_wide")
    dkv = _wide_wgmma_dims("flash_attention_bwd.cu", "launch_dkv_wgmma_wide")
    assert fwd == dq == dkv == {192, 256, 320, 384, 448, 512}, \
        (fwd, dq, dkv)
    cased = {-(-c[4] // 64) * 64 for c in smoke.CASES
             if c[5] == torch.bfloat16}
    assert fwd <= cased, sorted(fwd - cased)
    # and each of them causal and not, each with and without dropout,
    # over the bf16 cases of its padded head dim
    for d in sorted(fwd):
        mine = {(c[6], c[7] > 0) for c in smoke.CASES
                if c[5] == torch.bfloat16 and -(-c[4] // 64) * 64 == d}
        assert mine == {(False, False), (False, True), (True, False),
                        (True, True)}, (d, mine)
    above = [c for c in smoke.CASES if c[5] == torch.bfloat16
             and -(-c[4] // 64) * 64 > max(fwd)]
    assert {c[6] for c in above} == {False, True}, above


# Narrow heads: the Transformer's d = 8 (TransformerConfig's 64 over 8
# heads) and 16, 24, 32. The reference pads d to 64 (``_jax_lse`` does
# as its wrapper does); on the card bf16 runs them unpadded through the
# narrow forward, dq and dk/dv kernels (the CPU's plain versions take
# them as they are).
# Causal and not, ragged, sq != sk both ways, dropout 0 and 0.1 (causal
# dropout against the explicit-mask golden, which the JAX kernel does not
# lower).
NARROW_CASES = [  # (sq, sk, d, causal, dropout rate)
    (40, 40, 8, False, 0.0),
    (100, 100, 8, True, 0.0),
    (64, 100, 16, False, 0.1),
    (100, 100, 16, True, 0.1),
    (72, 72, 24, False, 0.1),
    (100, 40, 24, False, 0.0),
    (130, 130, 32, True, 0.0),
    (48, 48, 32, True, 0.1),
]


@pytest.mark.parametrize("sq,sk,d,causal,rate", NARROW_CASES)
def test_flash_forward_narrow_head_dims_match_jax(sq, sk, d, causal, rate):
    q, k, v = _qkv(1, 2, sq, sk, d, seed=51)
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=61 if rate else None)
    o, lse = _port(q, k, v, return_lse=True, **kw)
    assert o.shape == (1, 2, sq, d)
    want = (_jax_dropout_golden(q, k, v, True, rate, 61) if causal and rate
            else _jax(q, k, v, **kw))
    np.testing.assert_allclose(o.numpy(), want, **TOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, causal), **TOL)


@pytest.mark.parametrize("sq,sk,d,causal,rate", NARROW_CASES)
def test_flash_backward_narrow_head_dims_match_jax(sq, sk, d, causal, rate):
    q, k, v = _qkv(1, 2, sq, sk, d, seed=53)
    do = _do(1, 2, sq, d, seed=9)
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=63 if rate else None)
    calls = (bwd_mod.flash_attention_bwd_dq.plain_calls,
             bwd_mod.flash_attention_bwd_dkv.plain_calls)
    got = _port_grads(q, k, v, do, **kw)
    # one dq and one dk/dv call
    assert (bwd_mod.flash_attention_bwd_dq.plain_calls,
            bwd_mod.flash_attention_bwd_dkv.plain_calls) == \
        (calls[0] + 1, calls[1] + 1)
    want = (_jax_dropout_golden_grads(q, k, v, do, rate, 63)
            if causal and rate else _jax_grads(q, k, v, do, **kw))
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape == (1, 2, sq if name == "q" else sk, d)
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD_TOL)


def test_forward_head_dim_on_the_card():
    """What the wrapper hands the forward kernel on the card: bf16 up to
    d = 32 rounded up to a multiple of 8 (the narrow kernel; TMA takes
    rows of a multiple of 16 bytes), everything else padded to a multiple
    of 64 (f32 at 64 too: its tensor-core kernels take 64 and 128)."""
    bf, f32 = torch.bfloat16, torch.float32
    got = {d: bwd_mod._fwd_head_dim(d, bf) for d in (4, 8, 12, 16, 24, 32,
                                                     33, 48, 64, 100)}
    assert got == {4: 8, 8: 8, 12: 16, 16: 16, 24: 24, 32: 32, 33: 64,
                   48: 64, 64: 64, 100: 128}
    assert [bwd_mod._fwd_head_dim(d, f32) for d in (8, 32, 64)] == \
        [64, 64, 64]
    assert [d for d in range(1, 65) if bwd_mod._narrow(d, bf)] == \
        [8, 16, 24, 32]
    assert not any(bwd_mod._narrow(d, f32) for d in (8, 16, 32))


def test_every_narrow_head_dim_has_a_card_case():
    """The narrow bf16 forward is compiled for DP = 16 (d 8, 16) and 32
    (d 24, 32), and the bf16 forward at d = 128 has its own instantiation
    of the d <= 128 kernel: chip_smoke.py's kernel phase holds each
    against its plain version, causal and not, each with and without
    dropout, and the narrow one at the Transformer's b*h = 512."""
    import importlib.util
    import os
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "flexflow_tpu_torch", "csrc",
                           "flash_attention_fwd.cu")) as f:
        text = f.read()
    narrow = re.findall(r"head_dim <= (\d+)\)\s*FF_LAUNCH_NARROW\((\d+)\)",
                        text)
    assert narrow == [("16", "16"), ("32", "32")], narrow
    assert re.search(r"head_dim == 128\) FF_LAUNCH\(\(launch_wgmma<128, ",
                     text)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    bf = [c for c in smoke.CASES if c[5] == torch.bfloat16]
    every = {(False, False), (False, True), (True, False), (True, True)}
    for dp in (16, 32):
        mine = {(c[6], c[7] > 0) for c in bf
                if bwd_mod._narrow(c[4], c[5])
                and -(-c[4] // 16) * 16 == dp}
        assert mine == every, (dp, mine)
    assert {(c[6], c[7] > 0) for c in bf if c[4] == 128} == every
    assert any(c[0] * c[1] == 512 and c[4] == 8 for c in bf)
    # the ragged edges: sq != sk both ways at a narrow d
    assert any(c[2] < c[3] and c[4] <= 32 for c in bf)
    assert any(c[2] > c[3] and c[4] <= 32 for c in bf)


def test_backward_head_dim_on_the_card(monkeypatch):
    """What the backward kernels receive on the card: the autograd
    Function hands dq and dk/dv the forward's tensors as they are, so
    their head dim is _fwd_head_dim's (bf16 up to 32 rounded up to a
    multiple of 8, everything else to a multiple of 64), which the
    kernels take; nothing is padded or sliced in the backward."""
    bf, f32 = torch.bfloat16, torch.float32
    for dt in (bf, f32):
        for d in range(1, 600):
            dk = bwd_mod._fwd_head_dim(d, dt)
            assert bwd_mod._kernel_takes(dk, dt), (d, dt)
            assert bwd_mod._kernel_takes(d, dt) == (dk == d), (d, dt)
    assert [bwd_mod._fwd_head_dim(d, bf) for d in (4, 8, 12, 24, 32, 33)] \
        == [8, 8, 16, 24, 32, 64]
    assert [bwd_mod._fwd_head_dim(d, f32) for d in (8, 32, 48, 64)] == \
        [64, 64, 64, 64]

    from torch.utils._python_dispatch import TorchDispatchMode

    class Pads(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.__name__.startswith(("constant_pad_nd", "slice")):
                Pads.n += 1
            return func(*args, **(kwargs or {}))

    seen = []
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        real = getattr(bwd_mod, name)

        def spy(q, k, v, do, *a, _real=real, _name=name, **kw):
            seen.append((_name, q.shape[-1], k.shape[-1], do.shape[-1]))
            return _real(q, k, v, do, *a, **kw)
        # the wrapper counts its calls on the module's name, now the spy
        spy.plain_calls, spy.launches = 0, 0
        monkeypatch.setattr(bwd_mod, name, spy)
    for d, dt in ((8, bf), (12, bf), (24, bf), (8, f32), (48, bf)):
        dk = bwd_mod._fwd_head_dim(d, dt)
        q, k, v = (torch.from_numpy(x).to(dt).requires_grad_()
                   for x in _qkv(1, 2, 40, 40, dk, seed=d))
        o, _ = bwd_mod._FlashAttention.apply(q, k, v, False, d ** -0.5,
                                             0.0, 0)
        seen.clear()
        Pads.n = 0
        with Pads():
            grads = torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
        assert Pads.n == 0, (d, dt)
        assert seen == [("flash_attention_bwd_dq", dk, dk, dk),
                        ("flash_attention_bwd_dkv", dk, dk, dk)], seen
        assert all(g.shape == t.shape for g, t in zip(grads, (q, k, v)))


def test_every_narrow_backward_head_dim_has_a_card_case():
    """The narrow bf16 dq and dk/dv kernels are compiled for DP = 16 (d 8,
    16) and 32 (d 24, 32), each entry launching the narrow kernel of its
    side, and chip_smoke.py's kernel phase holds them against their plain
    versions on unpadded tensors: both DPs causal and not, each with and
    without dropout, the Transformer's b*h = 512 at d = 8, sq != sk both
    ways at both DPs."""
    import importlib.util
    import os
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "flexflow_tpu_torch", "csrc",
                           "flash_attention_bwd.cu")) as f:
        text = f.read()
    narrow = re.findall(r"head_dim <= (\d+)\)\s*FF_LAUNCH_NARROW\((\d+)\)",
                        text)
    assert narrow == [("16", "16"), ("32", "32")], narrow
    macro = re.search(r"#define FF_LAUNCH_NARROW\(DP\)(.*?)\n\s*if",
                      text, re.S).group(1)
    assert "dkv ? launch_dkv_narrow<DP>(" in macro \
        and ": launch_dq_narrow<DP>(" in macro, macro
    for side in ("dq", "dkv"):
        assert re.search(rf"launch_{side}_narrow_t<DP, true>", text)
        assert re.search(rf"auto kernel = flash_bwd_{side}_wgmma_narrow_"
                         rf"kernel<DP, DROPOUT>;", text)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    bf = [c for c in smoke.CASES if c[5] == torch.bfloat16
          and bwd_mod._narrow(bwd_mod._fwd_head_dim(c[4], c[5]), c[5])]
    every = {(False, False), (False, True), (True, False), (True, True)}
    for dp in (16, 32):
        mine = [c for c in bf if -(-c[4] // 16) * 16 == dp]
        assert {(c[6], c[7] > 0) for c in mine} == every, dp
        assert any(c[2] < c[3] for c in mine), dp
        assert any(c[2] > c[3] for c in mine), dp
    assert any(c[0] * c[1] == 512 and c[4] == 8 and c[2] == 512
               for c in bf)
    # the kernel phase hands every case the kernels' head dim, unpadded
    # past it
    assert all(smoke.kernel_head_dim(c[4], c[5])
               == bwd_mod._fwd_head_dim(c[4], c[5]) for c in smoke.CASES)


# The f32 forward on the card (flash_fwd_wgmma_tf32_kernel at d = 64 and
# 128, flash_fwd_wgmma_wide_tf32_kernel at 192 ... 512) runs every
# product on the tensor cores in three TF32 passes of split operands: x =
# hi + lo, hi = x with its low 13 mantissa bits cleared, lo = x - hi
# cleared the same way (tf32_split in csrc/hopper_common.cuh), and a . b
# ~ a_lo . b_hi + a_hi . b_lo + a_hi . b_hi. This emulation repeats that
# arithmetic on the CPU (the split by bit masks, f32 products of the
# TF32 parts, the kernels' key tiles of 32 at d = 128 and 64 at every
# other d, the wide kernel's two partial score tiles over the halves of
# d summed, the online softmax in base 2) and holds it against the JAX
# package's f32 forward to chip_smoke.py's f32 tolerance, 2e-5 absolute
# on o and lse;
# one TF32 pass misses that tolerance, which is why the kernel takes
# three. It emulates the split, not the tensor cores' own summation
# order within a k-step, which only the card shows. Nothing on the port's
# path calls it.
TF32_TOL = 2e-5     # chip_smoke.py's TOL[torch.float32], o and lse


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) & -8192).view(torch.float32)  # 0xFFFFE000


def _tf32_split(x: torch.Tensor):
    hi = _tf32_trunc(x)
    return hi, _tf32_trunc(x - hi)


def _tf32_mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernel's TF32 passes compute it: the two small terms
    first, then hi . hi (passes = 1: hi . hi alone)."""
    (ah, al), (bh, bl) = _tf32_split(a), _tf32_split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _tf32_flash(q, k, v, causal=False, passes=3):
    """(o, lse) of the card's f32 forward, emulated in f32 on the CPU."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bn = 32 if d == 128 else 64
    halves = 2 if d > 128 else 1   # the wide kernel's warpgroups split d
    log2e = 1.4426950408889634
    scale_log2 = np.float32(log2e / np.sqrt(d))
    m = torch.full((b, h, sq, 1), -1e30 * log2e)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    rows = torch.arange(sq)[:, None]
    for n0 in range(0, sk, bn):
        kt, vt = k[:, :, n0:n0 + bn], v[:, :, n0:n0 + bn]
        s = sum(_tf32_mm(qh, kh.transpose(2, 3), passes)
                for qh, kh in zip(q.chunk(halves, -1), kt.chunk(halves, -1)))
        s = s * scale_log2
        if causal:
            keys = torch.arange(n0, n0 + kt.shape[2])[None, :]
            s = torch.where(keys <= rows, s, torch.tensor(-1e30 * log2e))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _tf32_mm(p, vt, passes)
        m = m_new
    o = acc / l
    lse = (m * np.float32(np.log(2.0)) + torch.log(l)).squeeze(-1)
    return o, lse


TF32_CASES = [(s, d, causal) for s in (128, 512) for d in (64, 128)
              for causal in (False, True)]


@pytest.mark.parametrize("s,d,causal", TF32_CASES)
def test_tf32_three_pass_emulation_matches_jax_f32(s, d, causal):
    q, k, v = _qkv(1, 2, s, s, d, seed=17)
    o, lse = _tf32_flash(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    do = np.abs(o.numpy() - _jax(q, k, v, causal=causal)).max()
    dl = np.abs(lse.numpy() - _jax_lse(q, k, v, causal)).max()
    assert do <= TF32_TOL and dl <= TF32_TOL, (do, dl)


# the wide kernel's head dims: d 192, 256 and 512, causal and not, a
# ragged s past three key tiles, and sq != sk once
TF32_WIDE_CASES = [(200, 200, d, causal) for d in (192, 256, 512)
                   for causal in (False, True)] + [(96, 200, 256, False)]


@pytest.mark.parametrize("sq,sk,d,causal", TF32_WIDE_CASES)
def test_tf32_three_pass_emulation_matches_jax_f32_wide(sq, sk, d, causal):
    q, k, v = _qkv(1, 2, sq, sk, d, seed=19)
    o, lse = _tf32_flash(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    do = np.abs(o.numpy() - _jax(q, k, v, causal=causal)).max()
    dl = np.abs(lse.numpy() - _jax_lse(q, k, v, causal)).max()
    assert do <= TF32_TOL and dl <= TF32_TOL, (do, dl)


@pytest.mark.parametrize("s,d", [(128, 64), (512, 64), (512, 128),
                                 (200, 512)])
def test_one_tf32_pass_misses_the_f32_tolerance(s, d):
    """One TF32 pass (hi . hi) keeps ~3 decimal digits of each operand:
    its o misses 2e-5 by orders of magnitude, so the kernel needs the two
    correction passes."""
    q, k, v = _qkv(1, 2, s, s, d, seed=17)
    o, _ = _tf32_flash(*(torch.from_numpy(x) for x in (q, k, v)),
                       passes=1)
    assert np.abs(o.numpy() - _jax(q, k, v)).max() > 10 * TF32_TOL


def test_tf32_split_is_exact_in_its_parts():
    """hi and lo are TF32 values (low 13 bits clear), hi + lo is x up to
    lo's own truncation (2**-20 of x at most), and lo is 0 for a value
    that TF32 holds exactly."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        4096).astype(np.float32))
    hi, lo = _tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 8191).any()
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -20).all()
    assert not _tf32_split(hi)[1].any()


def test_every_f32_tensor_core_forward_has_a_card_case():
    """The f32 forward at d = 64 and 128 runs flash_fwd_wgmma_tf32_kernel,
    whose two warpgroups split the key tiles (64 keys at d = 64, 32 at
    d = 128): chip_smoke.py's kernel phase holds each d against its plain
    version with the keys within one tile (the second warpgroup idles)
    and past it, each causal and not, with and without dropout, and the
    search's calibration rows (b1 h8 d64 causal, s 128 and 512) and the
    f32 d = 128 kernels at sq != sk both ways; its timing phases list the
    calibration rows for the A/B against a parent tree."""
    import importlib.util
    import os
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "flexflow_tpu_torch", "csrc",
                           "flash_attention_fwd.cu")) as f:
        text = f.read()
    assert re.search(r"dtype == 0 && head_dim == 64\) FF_LAUNCH\(\("
                     r"launch_tf32<64>\)\)", text)
    assert re.search(r"dtype == 0 && head_dim == 128\) FF_LAUNCH\(\("
                     r"launch_tf32<128>\)\)", text)
    assert "flash_fwd_kernel<" not in text   # the FMA forward is gone
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    f32 = [c for c in smoke.CASES if c[5] == torch.float32
           and bwd_mod._fwd_head_dim(c[4], c[5]) <= 128]
    every = {(False, False), (False, True), (True, False), (True, True)}
    for d, bn in ((64, 64), (128, 32)):
        for past_one_tile in (False, True):
            mine = {(c[6], c[7] > 0) for c in f32
                    if bwd_mod._fwd_head_dim(c[4], c[5]) == d
                    and (c[3] > bn) == past_one_tile}
            assert mine == every, (d, past_one_tile, mine)
    for s in (128, 512):
        assert (1, 8, s, s, 64, torch.float32, True, 0.0) in smoke.CASES
        assert ("fwd", 1, 8, s, 64, True, torch.float32) \
            in smoke.AB_SHAPES
    d128 = [c for c in f32 if c[4] == 128]
    assert any(c[2] < c[3] for c in d128) and any(c[2] > c[3] for c in d128)


def test_every_f32_wide_forward_head_dim_has_a_card_case():
    """f32 at d = 192 ... 512 dispatches to the split-precision TF32 wide
    kernel (launch_tf32_wide<D>, D compiled in, the head dims the bf16
    wide kernel is compiled for), and the wide FMA forward
    (flash_fwd_wide_kernel<float>) is reached only above 512. chip_smoke.py's
    kernel phase holds each of those d in f32 against its plain version
    causal and not, with and without dropout, with the keys within one key
    tile and past it, at sq != sk both ways at d 256 and 512, at NMT's
    self- and cross-attention shapes, and above 512; its timing phases
    list the new kernel's rows, and the A/B keeps its f32 d 192 row."""
    import importlib.util
    import os
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "flexflow_tpu_torch", "csrc",
                           "flash_attention_fwd.cu")) as f:
        text = f.read()
    entry = text[text.index('extern "C" int ff_flash_attention_fwd'):]
    f32 = re.search(r"if \(dtype == 0\) switch \(head_dim\) \{(.*?)\}",
                    entry, re.S)
    assert f32, "no f32 switch in the C entry"
    found = re.findall(r"case (\d+): FF_LAUNCH\(\(launch_tf32_wide<(\d+)>",
                       f32.group(1))
    assert all(a == b for a, b in found), found
    wide = {int(a) for a, _ in found}
    assert wide == _wide_wgmma_dims("flash_attention_fwd.cu",
                                    "launch_wgmma_wide") \
        == {192, 256, 320, 384, 448, 512}, wide
    # the FMA forward: one guarded block after both switches, above 512
    fma = re.search(r"if \(head_dim > (\d+) && head_dim % ff_flash::TILE "
                    r"== 0\) \{\s*if \(dtype == 0\) FF_LAUNCH_WIDE\(float\);",
                    entry)
    assert fma and int(fma.group(1)) == max(wide), fma
    assert entry.index("launch_tf32_wide<512>") < fma.start()
    assert all(m.start() > fma.start() for m in
               re.finditer(r"FF_LAUNCH_WIDE\((float|__nv_bfloat16)\)", entry))
    bn = int(re.search(r"struct Tf32WideTiles \{.*?int BN = (\d+);", text,
                       re.S).group(1))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cases = [c for c in smoke.CASES if c[5] == torch.float32]
    every = {(False, False), (False, True), (True, False), (True, True)}
    for d in sorted(wide):
        mine = [c for c in cases if bwd_mod._fwd_head_dim(c[4], c[5]) == d]
        assert {(c[6], c[7] > 0) for c in mine} == every, d
        assert any(c[3] <= bn for c in mine), (d, "within one key tile")
        assert any(c[3] > bn for c in mine), (d, "past one key tile")
    for d in (256, 512):
        mine = [c for c in cases if c[4] == d]
        assert any(c[2] < c[3] for c in mine), d
        assert any(c[2] > c[3] for c in mine), d
    assert (64, 1, 128, 128, 512, torch.float32, False, 0.0) in smoke.CASES
    assert (16, 1, 100, 37, 512, torch.float32, False, 0.0) in smoke.CASES
    above = [c for c in cases if c[4] > max(wide)]
    assert {c[6] for c in above} == {False, True}, above
    rows = {s[1:8] for s in smoke.KT_SHAPES}
    for d in (192, 256, 320, 512):
        assert ("fwd", 4, 8, 512, d, False, torch.float32) in rows, d
    assert ("fwd", 4, 8, 512, 256, True, torch.float32) in rows
    assert ("fwd", 64, 1, 128, 512, False, torch.float32) in rows
    assert ("fwd", 4, 8, 512, 192, False, torch.float32) in smoke.AB_SHAPES


# The f32 dq and dk/dv on the card (flash_bwd_dq_wgmma_tf32_kernel and
# flash_bwd_dkv_wgmma_tf32_kernel at d = 64 and 128,
# flash_bwd_dq_wgmma_wide_tf32_kernel and flash_bwd_dkv_wgmma_wide_tf32_kernel
# at d = 192 ... 512) run all five products in three TF32 passes of split
# operands: S = Q . K^T and dP = dO . V^T as partial tiles summed in f32
# (at d <= 128 one per 32-column chunk, in chunk order, as a warpgroup
# owning all of d sums them; above, one per half of d, the two
# warpgroups' parts), dQ += dS . K over key tiles, dV += P_eff^T . dO and
# dK += dS^T . Q over query tiles (64 rows), each tile's product summed
# into the gradient in f32. This
# emulation repeats that arithmetic on the CPU, from the emulated
# forward's o and lse and delta = rowsum(do * o) as the autograd Function
# takes it, and holds it against jax.grad through the JAX package's f32
# kernels (interpret mode), relative to the largest gradient, to
# chip_smoke.py's BWD_TOL[torch.float32]; one TF32 pass misses it. As the
# forward's emulation, it repeats the split, not the tensor cores' own
# summation order. Nothing on the port's path calls it.
TF32_BWD_TOL = 1e-5     # chip_smoke.py's BWD_TOL[torch.float32]


def _tf32_scores(a, b, passes):
    """a . b^T as the kernels compute it: at d <= 128 one TF32 product
    per 32-column chunk, the partial tiles summed in chunk order; above,
    the wide kernels' two warpgroups' one product over each half of d,
    summed."""
    parts = a.shape[-1] // 32 if a.shape[-1] <= 128 else 2
    return sum(_tf32_mm(ah, bh.transpose(2, 3), passes)
               for ah, bh in zip(a.chunk(parts, -1), b.chunk(parts, -1)))


def _tf32_flash_bwd(q, k, v, do, lse, delta, causal=False, passes=3):
    """(dq, dk, dv) of the card's f32 backward, emulated in f32 on the
    CPU: dq over key tiles, dk and dv over query tiles, p in base 2 from
    lse, ds = p (dp - delta) sm_scale, no dropout."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bn = 64
    log2e = 1.4426950408889634
    scale = np.float32(1.0 / np.sqrt(d))
    scale_log2 = np.float32(log2e / np.sqrt(d))
    lse2 = (lse * np.float32(log2e))[..., None]
    dlt = delta[..., None]

    def p_ds(rows, keys, qt, dot, kt, vt, lse2_, dlt_):
        p = torch.exp2(_tf32_scores(qt, kt, passes) * scale_log2 - lse2_)
        if causal:
            p = torch.where(keys[None, :] <= rows[:, None], p,
                            torch.zeros(()))
        return p, p * (_tf32_scores(dot, vt, passes) - dlt_) * scale

    dq = torch.zeros_like(q)
    for n0 in range(0, sk, bn):       # dq: a CTA's loop over key tiles
        kt, vt = k[:, :, n0:n0 + bn], v[:, :, n0:n0 + bn]
        _, ds = p_ds(torch.arange(sq), torch.arange(n0, n0 + kt.shape[2]),
                     q, do, kt, vt, lse2, dlt)
        dq += _tf32_mm(ds, kt, passes)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for m0 in range(0, sq, bn):       # dk/dv: a CTA's loop over query tiles
        qt, dot = q[:, :, m0:m0 + bn], do[:, :, m0:m0 + bn]
        p, ds = p_ds(torch.arange(m0, m0 + qt.shape[2]), torch.arange(sk),
                     qt, dot, k, v, lse2[:, :, m0:m0 + bn],
                     dlt[:, :, m0:m0 + bn])
        dv += _tf32_mm(p.transpose(2, 3), dot, passes)
        dk += _tf32_mm(ds.transpose(2, 3), qt, passes)
    return dq, dk, dv


def _tf32_grads(q, k, v, do, causal=False, passes=3):
    """The card's f32 path on the CPU: the emulated forward (three
    passes), delta in f32 as the autograd Function takes it, then the
    emulated backward in ``passes`` passes."""
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = _tf32_flash(q, k, v, causal)
    delta = (do * o).sum(-1)
    return [g.numpy() for g in _tf32_flash_bwd(q, k, v, do, lse, delta,
                                               causal, passes)]


# (b, h, sq, sk, d, causal): d 64, 128, 192, 256 and 512 causal and not
# at a ragged s, sq != sk both ways at d 64 and 128 and once at 256,
# NMT's d 512 self-attention at a small batch
TF32_BWD_CASES = [(1, 2, 200, 200, d, causal)
                  for d in (64, 128, 192, 256, 512)
                  for causal in (False, True)] + [
    (1, 2, 96, 200, 64, False), (1, 2, 200, 96, 64, False),
    (1, 2, 96, 200, 128, False), (1, 2, 200, 96, 128, False),
    (1, 2, 96, 200, 256, False), (2, 1, 128, 128, 512, False)]


@pytest.mark.parametrize("b,h,sq,sk,d,causal", TF32_BWD_CASES)
def test_tf32_three_pass_backward_emulation_matches_jax_f32(b, h, sq, sk, d,
                                                            causal):
    q, k, v = _qkv(b, h, sq, sk, d, seed=23)
    do = _do(b, h, sq, d, seed=24)
    got = _tf32_grads(q, k, v, do, causal)
    want = _jax_grads(q, k, v, do, causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel <= TF32_BWD_TOL, (f"d{name}", rel)


@pytest.mark.parametrize("d", [64, 256, 512])
def test_one_tf32_pass_backward_misses_the_f32_tolerance(d):
    """One TF32 pass for each of the backward's five products keeps ~3
    decimal digits of each operand: the gradients miss 1e-5 of the
    largest by orders of magnitude, so the kernels take three."""
    q, k, v = _qkv(1, 2, 200, 200, d, seed=23)
    do = _do(1, 2, 200, d, seed=24)
    got = _tf32_grads(q, k, v, do, passes=1)
    want = _jax_grads(q, k, v, do)
    worst = max(np.abs(g - w).max() / np.abs(w).max()
                for g, w in zip(got, want))
    assert worst > 10 * TF32_BWD_TOL, worst


def test_every_f32_wide_backward_head_dim_has_a_card_case():
    """f32 dq and dk/dv at d = 192 ... 512 dispatch to the split-precision
    TF32 wide kernels (launch_dq_tf32_wide<D>, launch_dkv_tf32_wide<D>, D
    compiled in, the head dims of the bf16 wide kernels), and the wide FMA
    kernels (launch_dq_wide, launch_dkv_wide) are reached only above 512.
    chip_smoke.py's kernel phase holds each of those d in f32 against the
    plain versions causal and not, with and without dropout, with the key
    block edges (a causal s just past a 64-key block with dropout at d 192
    and 512, a query count below one query tile over many keys, NMT's
    ragged cross-attention both ways), and through the autograd Function
    (FN_F32_CASES: d 300 padded, d 512 causal with dropout, NMT's shape);
    its timing phases list the new kernels' rows."""
    import importlib.util
    import os
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "flexflow_tpu_torch", "csrc",
                           "flash_attention_bwd.cu")) as f:
        text = f.read()
    entry = text[text.index("int dispatch(bool dkv"):]
    wide = set()
    for side, cond in (("dq", "!dkv"), ("dkv", "dkv")):
        block = re.search(rf"if \({re.escape(cond)} && dtype == 0\) switch "
                          r"\(head_dim\) \{(.*?)\}", entry, re.S)
        assert block, side
        found = re.findall(rf"case (\d+): return \(int\)launch_{side}_tf32_"
                           r"wide<(\d+)>\(a\);", block.group(1))
        assert found and all(a == b for a, b in found), found
        dims = {int(a) for a, _ in found}
        assert dims == _wide_wgmma_dims("flash_attention_bwd.cu",
                                        f"launch_{side}_wgmma_wide") \
            == {192, 256, 320, 384, 448, 512}, (side, dims)
        assert re.search(rf"auto kernel = flash_bwd_{side}_wgmma_wide_tf32_"
                         r"kernel<D, DROPOUT>;", text), side
        wide |= dims
    # the FMA kernels: one guarded block after the f32 switches, above 512
    fma = re.search(r"if \(head_dim > (\d+) && head_dim % TILE == 0\) \{\s*"
                    r"if \(dkv && dtype == 0\) return \(int\)launch_dkv_wide"
                    r"<float>", entry)
    assert fma and int(fma.group(1)) == max(wide), fma
    assert entry.index("launch_dkv_tf32_wide<512>") < fma.start()
    assert all(m.start() > fma.start()
               for m in re.finditer(r"launch_(dq|dkv)_wide<", entry))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    f32 = torch.float32
    cases = [c for c in smoke.CASES if c[5] == f32]
    every = {(False, False), (False, True), (True, False), (True, True)}
    for d in sorted(wide):
        mine = [c for c in cases if bwd_mod._fwd_head_dim(c[4], c[5]) == d]
        assert {(c[6], c[7] > 0) for c in mine} == every, d
    for edge in ((2, 4, 260, 260, 192, f32, True, 0.1),
                 (2, 4, 260, 260, 512, f32, True, 0.1),
                 (2, 4, 20, 200, 256, f32, False, 0.0),
                 (16, 1, 37, 100, 512, f32, False, 0.1),
                 (16, 1, 100, 37, 512, f32, False, 0.0)):
        assert edge in smoke.CASES, edge
    fn = smoke.FN_F32_CASES
    assert all(c[5] == f32 for c in fn)
    assert any(bwd_mod._fwd_head_dim(c[4], f32) != c[4] for c in fn)
    assert any(c[4] == 512 and c[6] and c[7] > 0 for c in fn)
    assert (64, 1, 128, 128, 512, f32, False, 0.0) in fn
    rows = {s[1:8] for s in smoke.KT_SHAPES}
    for d in (192, 256, 320, 512):
        assert ("bwd", 4, 8, 512, d, False, f32) in rows, d
    assert ("bwd", 4, 8, 512, 256, True, f32) in rows
    assert ("bwd", 64, 1, 128, 512, False, f32) in rows
    assert ("bwd", 64, 1, 128, 512, False, f32) in smoke.AB_SHAPES


def test_every_f32_backward_head_dim_has_a_card_case():
    """f32 dq and dk/dv at d = 64 and 128 (and every f32 d the wrapper
    pads to them) dispatch to the split-precision TF32 kernels
    (launch_dq_tf32<D>, launch_dkv_tf32<D>: flash_bwd_dq_wgmma_tf32_kernel
    and flash_bwd_dkv_wgmma_tf32_kernel, one layout at every launch), and
    no f32 path up to d = 128 reaches an FMA kernel: the exact FMA kernels
    flash_bwd_dq_kernel and flash_bwd_dkv_kernel are gone, and the wide
    FMA kernels are reached only above 512. chip_smoke.py's kernel phase
    holds both d against the plain versions causal and not, each with and
    without dropout, with the row-block edges (a causal s just past a
    64-row and a 128-row block with dropout at both d, a query count below
    one tile over many keys and the other way round at d 128, b*h above
    1024 at d 64, BERT-base's grid at d 128 with dropout, causal and not),
    and through the autograd Function (FN_F32_CASES: d 64 with dropout, d
    128 causal); its timing phases and the A/B list the calibration
    shape's rows and BERT-base's b8 h12 s512 at d 64 and 128."""
    import importlib.util
    import os
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "flexflow_tpu_torch", "csrc",
                           "flash_attention_bwd.cu")) as f:
        text = f.read()
    entry = text[text.index("int dispatch(bool dkv"):]
    for side, cond in (("dq", "!dkv"), ("dkv", "dkv")):
        block = re.search(rf"if \({re.escape(cond)} && dtype == 0\) switch "
                          r"\(head_dim\) \{(.*?)\}", entry, re.S)
        assert block, side
        found = re.findall(rf"case (\d+): return \(int\)launch_{side}_tf32"
                           r"<(\d+)>\(a\);", block.group(1))
        assert found == [("64", "64"), ("128", "128")], (side, found)
        assert re.search(rf"auto kernel = flash_bwd_{side}_wgmma_tf32_"
                         r"kernel<D, DROPOUT>;", text), side
        assert re.search(rf"launch_{side}_tf32_t<D, true>\(a\)", text), side
    # no FMA kernel at d <= 128: those kernels and launchers are gone,
    # and every f32 launch outside the two switches is the wide FMA one,
    # guarded above 512
    for gone in ("flash_bwd_dq_kernel<", "flash_bwd_dkv_kernel<",
                 "launch_dq<", "launch_dkv<"):
        assert gone not in text, gone
    fma = re.search(r"if \(head_dim > 512 && head_dim % TILE == 0\)", entry)
    assert fma, "the wide FMA kernels' guard"
    tail = entry[entry.index("launch_dkv_tf32_wide<512>"):]
    assert not re.search(r"dtype == 0 && head_dim == (64|128)", tail)
    # the wrapper hands every f32 d up to 128 to those two head dims
    f32 = torch.float32
    assert {bwd_mod._fwd_head_dim(d, f32) for d in range(1, 129)} \
        == {64, 128}
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cases = [c for c in smoke.CASES if c[5] == f32]
    every = {(False, False), (False, True), (True, False), (True, True)}
    for d in (64, 128):
        mine = [c for c in cases if bwd_mod._fwd_head_dim(c[4], f32) == d]
        assert {(c[6], c[7] > 0) for c in mine} == every, d
        for s in (72, 130):   # past a 64-row and a 128-row block
            assert any(c[2] == c[3] == s and c[6] for c in mine), (d, s)
        assert any(c[6] and c[7] > 0 and c[2] % 64 for c in mine), d
    for edge in ((2, 4, 20, 200, 128, f32, False, 0.1),
                 (2, 4, 200, 20, 128, f32, False, 0.0),
                 (8, 12, 200, 200, 128, f32, True, 0.1),
                 (8, 12, 512, 512, 128, f32, False, 0.1)):
        assert edge in smoke.CASES, edge
    big = [c for c in cases if c[4] == 64 and c[0] * c[1] > 1024]
    assert {c[6] for c in big} == {False, True}, big
    fn = smoke.FN_F32_CASES
    assert any(c[4] == 64 and c[7] > 0 for c in fn)
    assert any(c[4] == 128 and c[6] for c in fn)
    rows = {s[1:8] for s in smoke.KT_SHAPES}
    for d in (64, 128):
        assert ("bwd", 1, 8, 512, d, True, f32) in rows, d
        assert ("bwd", 8, 12, 512, d, False, f32) in rows, d
        assert ("bwd", 8, 12, 512, d, False, f32) in smoke.AB_SHAPES, d
