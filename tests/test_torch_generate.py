"""The port's generation slice against the JAX package: a tiny GPT-2 (and a
hand-built sliding-window LM) built through ``FFModel`` in both, the
reference's weights carried into the port by
``interop.load_reference_params``, then the KV prefill caches, the decode
steps' score rows, greedy tokens (scalar and ragged prompts, eos), beam
search and ``InferenceSession.generate`` compared.

Everything runs with f32 compute, so the graphs agree op for op and
differ only in f32 summation order: caches and score rows hold to
max |diff| <= 1e-5, and tokens must be identical. A greedy token is only
as stable as the gap between its row's two largest scores, so every
token comparison also asserts that JAX's top-1/top-2 margin exceeds 1e-4
(ten times the tolerance) wherever argmax chose the token. Each case runs
under ``attention:xla`` and ``attention:flash``: the JAX flash prefill
runs its Pallas kernel in interpret mode, the port its plain version.

Sampling draws differ by design (JAX's threefry ``categorical`` against a
``torch.Generator``), so the sampled tokens are not held against JAX; the
filtered logits are, through a numpy transcription of the JAX filter, and
sampling that can keep only the argmax must equal greedy in both.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.models import GPTConfig as JaxGPTConfig
from flexflow_tpu.models import build_gpt2 as jax_build_gpt2
from flexflow_tpu.serving import InferenceSession as JaxSession
from flexflow_tpu_torch.interop import load_reference_params
from flexflow_tpu_torch.kernels import flash_attention
from flexflow_tpu_torch.model import filter_logits
from flexflow_tpu_torch.models import GPTConfig, build_gpt2
from flexflow_tpu_torch.serving import InferenceSession

BATCH, SEQ, VOCAB, LAYERS = 2, 16, 64, 2
ATOL = 1e-5
MARGIN = 1e-4
WINDOW = 4


def _config(pkg, impl):
    cfg = pkg.FFConfig()
    cfg.batch_size = BATCH
    cfg.only_data_parallel = True
    cfg.use_bf16_compute = False
    cfg.kernel_impls = f"attention:{impl}"
    return cfg


def _gpt2(pkg, cfg_cls, builder, impl, **model_kw):
    ff = pkg.FFModel(_config(pkg, impl), **model_kw)
    g = cfg_cls(vocab_size=VOCAB, hidden_size=32, num_layers=LAYERS,
                num_heads=4, max_position=SEQ, dropout=0.0)
    out = builder(ff, BATCH, SEQ, g)
    ff.compile(pkg.SGDOptimizer(0.01), "sparse_categorical_crossentropy",
               [], output_tensor=out)
    return ff


def _window_lm(pkg, impl="xla", window=WINDOW, **model_kw):
    """Two pre-LN causal attention blocks with a sliding window, built
    through the same builders in both packages."""
    ff = pkg.FFModel(_config(pkg, impl), **model_kw)
    ids = ff.create_tensor((BATCH, SEQ), pkg.DataType.DT_INT32,
                           name="input_ids")
    pos = ff.create_tensor((BATCH, SEQ), pkg.DataType.DT_INT32,
                           name="position_ids")
    t = ff.add(ff.embedding(ids, VOCAB, 32, name="wte"),
               ff.embedding(pos, SEQ, 32, name="wpe"))
    for _ in range(2):
        h = ff.layer_norm(t, [-1])
        t = ff.add(t, ff.multihead_attention(h, h, h, 32, 4, causal=True,
                                             sliding_window=window))
    logits = ff.dense(ff.layer_norm(t, [-1]), VOCAB, use_bias=False)
    ff.compile(pkg.SGDOptimizer(0.01), "sparse_categorical_crossentropy",
               [], output_tensor=ff.softmax(logits))
    return ff


def _carry(ffj_, fft_):
    load_reference_params(fft_, jax.device_get(ffj_.params),
                          [(l.name, l.op_type) for l in ffj_.layers])
    return ffj_, fft_


@pytest.fixture(scope="module", params=["xla", "flash"])
def pair(request):
    """(JAX model, port model with its weights) of the tiny GPT-2; shared
    by the module's tests so JAX compiles each decode program once."""
    impl = request.param
    return _carry(_gpt2(ffj, JaxGPTConfig, jax_build_gpt2, impl),
                  _gpt2(fft, GPTConfig, build_gpt2, impl, device="cpu"))


@pytest.fixture(scope="module")
def window_pair():
    return _carry(_window_lm(ffj), _window_lm(fft, device="cpu"))


def _prompt(seed, plen):
    rng = np.random.default_rng(seed)
    ids = np.zeros((BATCH, SEQ), np.int32)
    ids[:, :int(np.max(plen))] = rng.integers(0, VOCAB,
                                              (BATCH, int(np.max(plen))))
    return ids


def _batch(ids):
    return {"input_ids": ids,
            "position_ids": np.tile(np.arange(ids.shape[1], dtype=np.int32),
                                    (ids.shape[0], 1))}


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_margins(ffj_, out, plen, steps, eos=None):
    """JAX's score rows at every decode step of ``out`` (one re-forward
    over the final ids: the causal mask makes row t the step's row) have
    top-1/top-2 margins above MARGIN wherever argmax picked the token."""
    scores = np.asarray(ffj_.executor.scored_forward(
        ffj_.params, ffj_.state, _batch(np.asarray(out, np.int32))))
    plen = np.broadcast_to(np.asarray(plen), (out.shape[0],))
    for r in range(out.shape[0]):
        for i in range(steps):
            row = np.sort(scores[r, plen[r] - 1 + i])
            assert row[-1] - row[-2] > MARGIN, (r, i, row[-1] - row[-2])
            if eos is not None and out[r, plen[r] + i] == eos:
                break     # later tokens are forced, not chosen


def _assert_cache_equal(ct, cj):
    assert set(ct) == set(cj)
    for name, bufs in cj.items():
        assert set(ct[name]) == set(bufs), name
        for k, want in bufs.items():
            got = _np(ct[name][k])
            assert got.shape == np.asarray(want).shape, (name, k)
            if k == "pos":
                np.testing.assert_array_equal(got, np.asarray(want))
            else:
                np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                           rtol=0)


# ---------------------------------------------------------------------------
# the executor's KV prefill and decode step
# ---------------------------------------------------------------------------
def test_kv_prefill_caches_and_decode_rows_match_jax(pair):
    ffj_, fft_ = pair
    plen = 5
    ids = _prompt(0, 9)          # the decode steps read columns 4..8
    calls = flash_attention.plain_calls
    ct = fft_.executor.kv_prefill(fft_.params, fft_.state, _batch(ids),
                                  prefill_len=plen)
    flash = "flash" in fft_.executor._kernel_impls.values()
    assert flash_attention.plain_calls - calls == (LAYERS if flash else 0)
    _, cj = ffj_.executor.kv_prefill(ffj_.params, ffj_.state, _batch(ids),
                                     prefill_len=jnp.int32(plen))
    _assert_cache_equal(ct, cj)
    assert all(t.shape == (BATCH, SEQ, 4, 8)
               for c in ct.values() for t in c.values())
    want = np.asarray(ffj_.executor.scored_forward(ffj_.params, ffj_.state,
                                                   _batch(ids)))
    np.testing.assert_allclose(
        _np(fft_.executor.scored_forward(fft_.params, fft_.state,
                                         _batch(ids))), want, atol=ATOL,
        rtol=0)
    for i in range(4):
        cur = plen + i
        step = {"input_ids": ids[:, cur - 1:cur],
                "position_ids": np.full((BATCH, 1), cur - 1, np.int32)}
        calls = flash_attention.plain_calls
        row, ct = fft_.executor.kv_decode_step(fft_.params, fft_.state,
                                               step, ct, cur - 1)
        assert flash_attention.plain_calls == calls    # decode: no flash
        rj, cj = ffj_.executor.kv_decode_step(ffj_.params, ffj_.state, step,
                                              cj, jnp.int32(cur - 1))
        assert tuple(row.shape) == (BATCH, VOCAB)
        np.testing.assert_allclose(_np(row), np.asarray(rj), atol=ATOL,
                                   rtol=0)
        # and the re-forward oracle's row at the same position
        np.testing.assert_allclose(_np(row), want[:, cur - 1], atol=ATOL,
                                   rtol=0)
        _assert_cache_equal(ct, cj)


def test_ragged_decode_rows_match_jax(pair):
    """A (B,) decode index writes each row's K/V at its own position and
    masks per row."""
    ffj_, fft_ = pair
    plen = np.array([3, 7], np.int32)
    ids = _prompt(1, 8)
    ct = fft_.executor.kv_prefill(fft_.params, fft_.state, _batch(ids))
    _, cj = ffj_.executor.kv_prefill(ffj_.params, ffj_.state, _batch(ids))
    for i in range(3):
        cur = plen + i
        step = {"input_ids": ids[np.arange(BATCH), cur - 1][:, None],
                "position_ids": (cur - 1)[:, None]}
        row, ct = fft_.executor.kv_decode_step(
            fft_.params, fft_.state, step, ct, torch.as_tensor(cur - 1))
        rj, cj = ffj_.executor.kv_decode_step(ffj_.params, ffj_.state, step,
                                              cj, jnp.asarray(cur - 1))
        np.testing.assert_allclose(_np(row), np.asarray(rj), atol=ATOL,
                                   rtol=0)
        _assert_cache_equal(ct, cj)


# ---------------------------------------------------------------------------
# FFModel.generate: greedy, ragged, eos, the re-forward oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_matches_jax(pair, ragged):
    ffj_, fft_ = pair
    plen = np.array([3, 6], np.int32) if ragged else 4
    ids = _prompt(2, plen)
    steps = 8
    got = _np(fft_.generate(ids, plen, steps, kv_cache=True))
    want = np.asarray(ffj_.generate(ids, plen, steps, kv_cache=True))
    _assert_margins(ffj_, want, plen, steps)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == ids.shape
    # eos latches: the row keeps emitting it once emitted
    eos = int(want[0, np.broadcast_to(plen, (BATCH,))[0] + 1])
    got = _np(fft_.generate(ids, plen, steps, eos_token_id=eos,
                            kv_cache=True))
    want = np.asarray(ffj_.generate(ids, plen, steps, eos_token_id=eos,
                                    kv_cache=True))
    _assert_margins(ffj_, want, plen, steps, eos=eos)
    np.testing.assert_array_equal(got, want)
    start = np.broadcast_to(plen, (BATCH,))[0] + 1
    assert (got[0, start:start + steps - 1] == eos).all()
    assert getattr(fft_, "_kv_fallback_count", 0) == 0


@pytest.mark.parametrize("ragged", [False, True])
def test_kv_decode_equals_reforward(pair, ragged):
    ffj_, fft_ = pair
    plen = np.array([5, 2], np.int32) if ragged else 3
    ids = _prompt(3, plen)
    kv = _np(fft_.generate(ids, plen, 10, kv_cache=True))
    ref = _np(fft_.generate(ids, plen, 10, kv_cache=False))
    _assert_margins(ffj_, ref, plen, 10)
    np.testing.assert_array_equal(kv, ref)


def test_beam_matches_jax(pair):
    ffj_, fft_ = pair
    ids = _prompt(4, 4)
    for beams, eos in ((3, None), (3, 7), (1, None)):
        got = _np(fft_.generate_beam(ids, 4, 8, num_beams=beams,
                                     eos_token_id=eos))
        want = np.asarray(ffj_.generate_beam(ids, 4, 8, num_beams=beams,
                                             eos_token_id=eos))
        np.testing.assert_array_equal(got, want)
    # one beam is greedy
    greedy = _np(fft_.generate(ids, 4, 8, kv_cache=True))
    _assert_margins(ffj_, greedy, 4, 8)
    np.testing.assert_array_equal(got, greedy)
    with pytest.raises(ValueError, match="scalar prompt_len"):
        fft_.generate_beam(ids, np.array([2, 3]), 4)


# ---------------------------------------------------------------------------
# sliding window: the ring-buffer cache and the windowed masks
# ---------------------------------------------------------------------------
def test_window_ring_buffer_cache_matches_jax(window_pair):
    ffj_, fft_ = window_pair
    plen = 7
    ids = _prompt(5, 9)
    # the windowed causal mask of the full forward
    np.testing.assert_allclose(
        _np(fft_.executor.scored_forward(fft_.params, fft_.state,
                                         _batch(ids))),
        np.asarray(ffj_.executor.scored_forward(ffj_.params, ffj_.state,
                                                _batch(ids))),
        atol=ATOL, rtol=0)
    ct = fft_.executor.kv_prefill(fft_.params, fft_.state, _batch(ids),
                                  prefill_len=plen)
    _, cj = ffj_.executor.kv_prefill(ffj_.params, ffj_.state, _batch(ids),
                                     prefill_len=jnp.int32(plen))
    # W slots: position p at slot p % W, seeded with positions 4..6 and 3
    for c in ct.values():
        assert tuple(c["k"].shape) == (BATCH, WINDOW, 4, 8)
        np.testing.assert_array_equal(_np(c["pos"])[0], [4, 5, 6, 3])
    _assert_cache_equal(ct, cj)
    for i in range(2):
        cur = plen + i
        step = {"input_ids": ids[:, cur - 1:cur],
                "position_ids": np.full((BATCH, 1), cur - 1, np.int32)}
        row, ct = fft_.executor.kv_decode_step(fft_.params, fft_.state,
                                               step, ct, cur - 1)
        rj, cj = ffj_.executor.kv_decode_step(ffj_.params, ffj_.state, step,
                                              cj, jnp.int32(cur - 1))
        np.testing.assert_allclose(_np(row), np.asarray(rj), atol=ATOL,
                                   rtol=0)
        _assert_cache_equal(ct, cj)
    # a prompt shorter than the window leaves slots no position reached
    ct = fft_.executor.kv_prefill(fft_.params, fft_.state, _batch(ids),
                                  prefill_len=2)
    np.testing.assert_array_equal(_np(next(iter(ct.values()))["pos"])[1],
                                  [0, 1, -10 ** 9, -10 ** 9])


@pytest.mark.parametrize("ragged", [False, True])
def test_window_greedy_matches_jax(window_pair, ragged):
    """Scalar prompts decode on the ring buffer, ragged ones on the full
    cache with the window mask; both equal JAX and the re-forward."""
    ffj_, fft_ = window_pair
    plen = np.array([3, 9], np.int32) if ragged else 6
    ids = _prompt(6, plen)
    got = _np(fft_.generate(ids, plen, 7, kv_cache=True))
    want = np.asarray(ffj_.generate(ids, plen, 7, kv_cache=True))
    _assert_margins(ffj_, want, plen, 7)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _np(fft_.generate(ids, plen, 7, kv_cache=False)), want)


def test_window_validation_matches_jax():
    for pkg, kw in ((ffj, {}), (fft, {"device": "cpu"})):
        ff = pkg.FFModel(_config(pkg, "xla"), **kw)
        x = ff.create_tensor((BATCH, SEQ, 32))
        with pytest.raises(ValueError, match="requires causal"):
            ff.multihead_attention(x, x, x, 32, 4, sliding_window=4)
        with pytest.raises(ValueError, match="must be positive"):
            ff.multihead_attention(x, x, x, 32, 4, causal=True,
                                   sliding_window=-2)
        # the flash kernel has no window mask: forcing it fails compile
        with pytest.raises(ValueError, match="sliding-window"):
            _window_lm(pkg, impl="flash", **kw)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def _np_filter(row, temperature, top_k, top_p):
    """``flexflow_tpu/model.py`` ``_sample_next``'s filter, in numpy."""
    logits = row / np.float32(temperature)
    use_k = top_k and 0 < top_k < logits.shape[-1]
    if use_k or top_p < 1.0:
        desc = np.sort(logits, axis=-1)[:, ::-1]
        if use_k:
            kth = desc[:, top_k - 1][:, None]
            logits = np.where(logits < kth, -np.inf, logits)
            desc = np.where(np.arange(desc.shape[-1])[None, :] >= top_k,
                            -np.inf, desc)
        if top_p < 1.0:
            e = np.exp(desc - desc[:, :1])
            probs = e / e.sum(axis=-1, keepdims=True)
            cum = np.cumsum(probs, axis=-1)
            excluded = cum - probs > top_p
            kept = np.where(excluded, np.inf, desc)
            thresh = np.min(kept, axis=-1, keepdims=True)
            logits = np.where(logits < thresh, -np.inf, logits)
    return logits.astype(np.float32)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.8, 50, 0.95),
    (0.8, 12, 0.3), (1.0, 1, 1.0), (1.0, VOCAB, 1.0), (0.5, 0, 1e-6)])
def test_filter_logits_matches_numpy_transcription(temperature, top_k,
                                                   top_p):
    rng = np.random.default_rng(7)
    row = (rng.standard_normal((4, VOCAB)) * 2.0).astype(np.float32)
    got = filter_logits(torch.from_numpy(row), temperature, top_k,
                        top_p).numpy()
    want = _np_filter(row, temperature, top_k, top_p)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], rtol=1e-6)
    kept = np.isfinite(got).sum(axis=-1)
    if top_k and top_k < VOCAB:
        assert (kept <= top_k).all()
    assert (kept >= 1).all()


@pytest.mark.parametrize("top_k,top_p", [(1, 1.0), (0, 1e-6)])
def test_sampling_that_keeps_only_the_argmax_is_greedy(pair, top_k, top_p):
    ffj_, fft_ = pair
    ids = _prompt(8, 4)
    greedy = np.asarray(ffj_.generate(ids, 4, 8))
    _assert_margins(ffj_, greedy, 4, 8)
    kw = dict(temperature=0.7, seed=5, top_k=top_k, top_p=top_p)
    np.testing.assert_array_equal(np.asarray(ffj_.generate(ids, 4, 8, **kw)),
                                  greedy)
    for kv in (True, False):
        np.testing.assert_array_equal(
            _np(fft_.generate(ids, 4, 8, kv_cache=kv, **kw)), greedy)


def test_sampling_seeds(pair):
    _, fft_ = pair
    ids = _prompt(9, 3)
    kw = dict(temperature=1.5, top_k=40, top_p=0.95)
    a = _np(fft_.generate(ids, 3, 10, seed=11, **kw))
    np.testing.assert_array_equal(_np(fft_.generate(ids, 3, 10, seed=11,
                                                    **kw)), a)
    # the KV path and the re-forward see the same rows and draws
    np.testing.assert_array_equal(
        _np(fft_.generate(ids, 3, 10, seed=11, kv_cache=False, **kw)), a)
    b = _np(fft_.generate(ids, 3, 10, seed=12, **kw))
    assert (a[:, 3:13] != b[:, 3:13]).any()
    np.testing.assert_array_equal(a[:, :3], ids[:, :3])
    assert ((a >= 0) & (a < VOCAB)).all()


# ---------------------------------------------------------------------------
# InferenceSession.generate
# ---------------------------------------------------------------------------
def test_session_padding_and_chunking_equal_direct_generate(pair):
    ffj_, fft_ = pair
    sess = InferenceSession(fft_, batch_buckets=(1, BATCH),
                            decode_segment=0)
    ids = np.concatenate([_prompt(10, 4), _prompt(11, 4)[:1]])  # 3 rows
    got = sess.generate(ids, 4, 6)
    assert isinstance(got, np.ndarray) and got.shape == ids.shape
    np.testing.assert_array_equal(got[:2], _np(fft_.generate(ids[:2], 4, 6)))
    np.testing.assert_array_equal(got[2:], _np(fft_.generate(ids[2:], 4, 6)))
    _assert_margins(ffj_, got, 4, 6)
    np.testing.assert_array_equal(
        got, JaxSession(ffj_, batch_buckets=(1, BATCH),
                        decode_segment=0).generate(ids, 4, 6))
    # ragged rows: padding to bucket 2 gives the padded row a 1-token
    # prompt
    plen = np.array([2, 5, 3], np.int32)
    got = sess.generate(ids, plen, 6)
    np.testing.assert_array_equal(got[:2],
                                  _np(fft_.generate(ids[:2], plen[:2], 6)))
    np.testing.assert_array_equal(got[2:], _np(fft_.generate(ids[2:],
                                                             plen[2:], 6)))
    # chunks draw from per-chunk seeds
    sampled = sess.generate(np.concatenate([ids[:2], ids[:2]]), 4, 6,
                            temperature=1.5, seed=3)
    np.testing.assert_array_equal(
        sampled[:2], _np(fft_.generate(ids[:2], 4, 6, temperature=1.5,
                                       seed=3)))
    np.testing.assert_array_equal(
        sampled[2:], _np(fft_.generate(ids[:2], 4, 6, temperature=1.5,
                                       seed=(3 + 0x9E3779B1) & 0x7FFFFFFF)))
    # beams go through generate_beam
    np.testing.assert_array_equal(
        sess.generate(ids[:2], 4, 6, num_beams=2),
        _np(fft_.generate_beam(ids[:2], 4, 6, num_beams=2)))
    with pytest.raises(ValueError, match="beam search"):
        sess.generate(ids, plen, 6, num_beams=2)


@pytest.mark.parametrize("ragged", [False, True])
def test_segmented_greedy_equals_single_hold(pair, ragged):
    ffj_, fft_ = pair
    plen = np.array([2, 4], np.int32) if ragged else 3
    ids = _prompt(12, plen)
    single = InferenceSession(fft_, batch_buckets=(BATCH,),
                              decode_segment=0)
    seg = InferenceSession(fft_, batch_buckets=(BATCH,), decode_segment=3)
    want = single.generate(ids, plen, 10)
    # a later segment re-prefills what an earlier one decoded: the same
    # tokens wherever no two scores nearly tie
    _assert_margins(ffj_, want, plen, 10)
    np.testing.assert_array_equal(seg.generate(ids, plen, 10), want)
    np.testing.assert_array_equal(seg.clone().generate(ids, plen, 10), want)
    # eos forced on the host across segments
    eos = int(want[1, np.broadcast_to(plen, (BATCH,))[1]])
    want = single.generate(ids, plen, 10, eos_token_id=eos)
    np.testing.assert_array_equal(
        seg.generate(ids, plen, 10, eos_token_id=eos), want)
    start = np.broadcast_to(plen, (BATCH,))[1]
    assert (want[1, start:start + 10] == eos).all()


# ---------------------------------------------------------------------------
# entry points, eligibility and the fallback
# ---------------------------------------------------------------------------
def test_gpt2_weights_carry_over_exactly(pair):
    ffj_, fft_ = pair
    ref = jax.device_get(ffj_.params)
    assert set(fft_.params) == set(ref)
    for name, ws in ref.items():
        for wname, arr in ws.items():
            np.testing.assert_array_equal(_np(fft_.params[name][wname]),
                                          np.asarray(arr))
    assert [(l.name, int(l.op_type)) for l in fft_.layers] == \
        [(l.name, int(l.op_type)) for l in ffj_.layers]


def test_generate_validates_like_jax(pair):
    ffj_, fft_ = pair
    ids = _prompt(13, 4)
    for ff in (ffj_, fft_):
        with pytest.raises(ValueError, match="prompt_len must be >= 1"):
            ff.generate(ids, 0, 2)
        with pytest.raises(ValueError, match="exceeds the sequence"):
            ff.generate(ids, 10, 7)
        with pytest.raises(ValueError, match="ragged prompt_len"):
            ff.generate(ids, np.array([1, 2, 3]), 2)
        with pytest.raises(ValueError, match="each prompt_len"):
            ff.generate(ids, np.array([1, 15]), 2)
        with pytest.raises(ValueError, match="num_beams"):
            ff.generate_beam(ids, 4, 2, num_beams=0)
    out = fft_.generate(torch.from_numpy(ids), torch.tensor([2, 3]), 2)
    assert out.device.type == "cpu" and out.dtype == torch.int32
    assert fft_._decode_measured[BATCH]["n"] >= 1


def test_auto_mode_falls_back_and_remembers_the_shape(caplog):
    ffj_, fft_ = _carry(_gpt2(ffj, JaxGPTConfig, jax_build_gpt2, "xla"),
                        _gpt2(fft, GPTConfig, build_gpt2, "xla",
                              device="cpu"))
    ids = _prompt(14, 3)
    want = _np(fft_.generate(ids, 3, 5, kv_cache=False))
    attempts = []

    def broken(*args, **kw):
        attempts.append(1)
        raise RuntimeError("KV path broken on purpose")

    fft_._generate_kv = broken
    with caplog.at_level(logging.WARNING, logger="flexflow_tpu_torch"):
        np.testing.assert_array_equal(_np(fft_.generate(ids, 3, 5)), want)
        np.testing.assert_array_equal(_np(fft_.generate(ids, 3, 5)), want)
    assert attempts == [1] and fft_._kv_fallback_count == 1
    assert (BATCH, SEQ) in fft_.executor._kv_failed_shapes
    assert "falling back" in caplog.text
    with pytest.raises(RuntimeError, match="on purpose"):
        fft_.generate(ids, 3, 5, kv_cache=True)


def test_non_causal_graph_is_not_kv_eligible():
    for pkg, kw in ((ffj, {}), (fft, {"device": "cpu"})):
        ff = pkg.FFModel(_config(pkg, "xla"), **kw)
        ids = ff.create_tensor((BATCH, SEQ), pkg.DataType.DT_INT32,
                               name="input_ids")
        t = ff.embedding(ids, VOCAB, 32)
        t = ff.multihead_attention(t, t, t, 32, 4)
        ff.compile(pkg.SGDOptimizer(0.01), "sparse_categorical_crossentropy",
                   [], output_tensor=ff.softmax(ff.dense(t, VOCAB)))
        assert not ff._kv_decode_eligible({"input_ids"}, None)
        with pytest.raises(ValueError, match="causal"):
            ff.generate(_prompt(15, 2), 2, 2, kv_cache=True)
