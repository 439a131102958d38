"""The port's LLaMA family against the JAX package: a tiny LLaMA built
through ``FFModel`` in both (``build_llama``, primitive and fused
attention; GQA, a sliding window and Qwen2's q/k/v biases in the fused
form), the reference's weights carried into the port by
``interop.load_reference_params``; then the forward logits, N-step loss
histories, the KV prefill caches and decode rows, greedy tokens (scalar
and ragged prompts) and the re-forward path compared; ``_apply_rope``,
``llama_fuse_params`` and the executor's freeing of dead activations;
and ``llama_load_hf_state_dict`` against ``transformers``' own CPU logits
for locally built tiny ``LlamaForCausalLM`` and ``Qwen2ForCausalLM``.

Everything runs with f32 compute, so the two graphs agree op for op and
differ only in f32 summation order (and an ulp of f32 ``pow``/``cos``/
``sin`` in the RoPE frequencies at these small positions): logits, caches
and decode rows hold to 1e-5, tokens must be identical, and every greedy
token comparison also asserts JAX's top-1/top-2 margin above 1e-4 (ten
times the tolerance). Loss histories use Adam at epsilon 1e-4, as
``test_torch_train.py`` does. ``attention:flash`` runs the JAX Pallas
kernel in interpret mode and the port's plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.models import LlamaConfig as JaxLlamaConfig
from flexflow_tpu.models import build_llama as jax_build_llama
from flexflow_tpu.models.nlp import llama_fuse_params as jax_fuse
from flexflow_tpu.ops.nn_ops import _apply_rope as jax_rope
from flexflow_tpu_torch.interop import load_reference_params
from flexflow_tpu_torch.kernels import flash_attention
from flexflow_tpu_torch.models import LlamaConfig, build_llama
from flexflow_tpu_torch.models.nlp import (llama_fuse_params,
                                           llama_load_hf_state_dict)
from flexflow_tpu_torch.ops.nn_ops import _apply_rope
from flexflow_tpu_torch.serving import InferenceSession

BATCH, SEQ, VOCAB = 2, 12, 96
ATOL = 1e-5
MARGIN = 1e-4

# name -> (fused_attention, LlamaConfig overrides)
VARIANTS = {
    "primitive": (False, {}),
    "fused": (True, {}),
    "gqa": (True, {"num_kv_heads": 2}),
    "window": (True, {"sliding_window": 4}),
    "qwen2": (True, {"num_kv_heads": 2, "attention_bias": True}),
}


def _lcfg(cls, **over):
    lc = cls.tiny()
    lc.max_position = SEQ
    for k, v in over.items():
        setattr(lc, k, v)
    return lc


def _llama(pkg, cfg_cls, builder, variant, impl="xla", optimizer=None,
           **model_kw):
    fused, over = VARIANTS[variant]
    cfg = pkg.FFConfig()
    cfg.batch_size = BATCH
    cfg.only_data_parallel = True
    cfg.use_bf16_compute = False
    cfg.kernel_impls = f"attention:{impl}"
    ff = pkg.FFModel(cfg, **model_kw)
    out = builder(ff, BATCH, SEQ, _lcfg(cfg_cls, **over),
                  fused_attention=fused)
    ff.compile(optimizer or pkg.SGDOptimizer(0.01),
               "sparse_categorical_crossentropy", [], output_tensor=out)
    return ff


def _pair(variant, impl="xla", optimizer=None):
    """(JAX model, port model carrying its weights) of one variant."""
    ffj_ = _llama(ffj, JaxLlamaConfig, jax_build_llama, variant, impl,
                  optimizer(ffj) if optimizer else None)
    fft_ = _llama(fft, LlamaConfig, build_llama, variant, impl,
                  optimizer(fft) if optimizer else None, device="cpu")
    load_reference_params(fft_, jax.device_get(ffj_.params),
                          [(l.name, l.op_type) for l in ffj_.layers])
    return ffj_, fft_


_PAIRS = {}


def _shared_pair(variant, impl="xla"):
    """One pair per (variant, impl) for the module's inference tests, so
    JAX compiles each program once."""
    if (variant, impl) not in _PAIRS:
        _PAIRS[(variant, impl)] = _pair(variant, impl)
    return _PAIRS[(variant, impl)]


def _ids(seed, rows=BATCH, cols=SEQ):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (rows, cols)).astype(np.int32)


def _prompt(seed, plen):
    ids = np.zeros((BATCH, SEQ), np.int32)
    n = int(np.max(plen))
    ids[:, :n] = _ids(seed, cols=n)
    return ids


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_margins(ffj_, out, plen, steps):
    """JAX's score rows at every decode step of ``out`` have top-1/top-2
    margins above MARGIN (one re-forward over the final ids: the causal
    mask makes row t the step's row)."""
    scores = np.asarray(ffj_.executor.scored_forward(
        ffj_.params, ffj_.state, {"input_ids": np.asarray(out, np.int32)}))
    plen = np.broadcast_to(np.asarray(plen), (out.shape[0],))
    for r in range(out.shape[0]):
        for i in range(steps):
            row = np.sort(scores[r, plen[r] - 1 + i])
            assert row[-1] - row[-2] > MARGIN, (r, i, row[-1] - row[-2])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pos_kind", ["vector", "scalar", "per_row"])
def test_apply_rope_matches_jax(pos_kind):
    """The prefill's (L,) positions, the decode step's one position, and
    the ragged decode's (B, 1) per-row positions."""
    rng = np.random.default_rng(4)
    L = 1 if pos_kind != "vector" else 9
    x = rng.standard_normal((3, L, 4, 16)).astype(np.float32)
    pos = {"vector": np.arange(L), "scalar": np.array([7]),
           "per_row": np.array([[3], [11], [40]])}[pos_kind]
    got = _apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    want = jax_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 10000.0)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_rope_needs_causal_self_attention():
    ff = fft.FFModel(fft.FFConfig(), device="cpu")
    x = ff.create_tensor((1, 4, 32), name="x")
    ff.multihead_attention(x, x, x, 32, 4, rope=True, causal=False)
    ff.compile(fft.SGDOptimizer(0.01), "identity", [])
    with pytest.raises(ValueError, match="causal"):
        ff.executor.make_forward()(ff.params, ff.state,
                                   {"x": np.zeros((1, 4, 32), np.float32)})


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_logits_match_jax(variant):
    ffj_, fft_ = _shared_pair(variant)
    ids = _ids(0)
    want = np.asarray(ffj_.executor.scored_forward(
        ffj_.params, ffj_.state, {"input_ids": ids}))
    got = fft_.executor.scored_forward(fft_.params, fft_.state,
                                       {"input_ids": ids})
    assert tuple(got.shape) == (BATCH, SEQ, VOCAB)
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)
    probs = fft_.executor.make_forward()(fft_.params, fft_.state,
                                         {"input_ids": ids})
    np.testing.assert_allclose(
        _np(probs), np.asarray(ffj_.executor.make_forward()(
            ffj_.params, ffj_.state, {"input_ids": ids})), atol=ATOL,
        rtol=0)


def test_fused_flash_forward_runs_the_plain_kernel_per_layer():
    ffj_, fft_ = _shared_pair("fused", "flash")
    ids = _ids(1)
    calls = flash_attention.plain_calls
    got = fft_.executor.scored_forward(fft_.params, fft_.state,
                                       {"input_ids": ids})
    assert flash_attention.plain_calls - calls == 2      # one per layer
    want = ffj_.executor.scored_forward(ffj_.params, ffj_.state,
                                        {"input_ids": ids})
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_primitive_build_refuses_what_it_cannot_compute():
    for over in ({"num_kv_heads": 2}, {"sliding_window": 4},
                 {"attention_bias": True}):
        ff = fft.FFModel(fft.FFConfig(), device="cpu")
        with pytest.raises(ValueError, match="fused_attention=True"):
            build_llama(ff, BATCH, SEQ, _lcfg(LlamaConfig, **over))


def test_llama_config_defaults_are_llama_7b():
    lc = LlamaConfig()
    assert (lc.vocab_size, lc.hidden_size, lc.intermediate_size,
            lc.num_layers, lc.num_heads, lc.max_position) == \
        (32000, 4096, 11008, 32, 32, 2048)
    assert (lc.rope_theta, lc.rms_eps) == (10000.0, 1e-6)
    jl = JaxLlamaConfig()
    assert vars(lc) == vars(jl)
    assert vars(LlamaConfig.tiny()) == vars(JaxLlamaConfig.tiny())


# ---------------------------------------------------------------------------
# llama_fuse_params
# ---------------------------------------------------------------------------
def test_fuse_params_matches_jax_and_the_primitive_logits():
    ffj_, fft_ = _shared_pair("primitive")
    lc = _lcfg(LlamaConfig)
    fused = llama_fuse_params(fft_.params, lc)
    want = jax_fuse(jax.device_get(ffj_.params), _lcfg(JaxLlamaConfig))
    assert set(fused) == set(want)
    for ln, ws in want.items():
        assert set(fused[ln]) == set(ws), ln
        for wn, w in ws.items():
            np.testing.assert_array_equal(_np(fused[ln][wn]), np.asarray(w))
    ff = _llama(fft, LlamaConfig, build_llama, "fused", device="cpu")
    ff.params = fused
    ids = _ids(2)
    np.testing.assert_allclose(
        _np(ff.executor.scored_forward(ff.params, ff.state,
                                       {"input_ids": ids})),
        _np(fft_.executor.scored_forward(fft_.params, fft_.state,
                                         {"input_ids": ids})),
        atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="GQA"):
        llama_fuse_params(fft_.params, _lcfg(LlamaConfig, num_kv_heads=2))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _adam(pkg):
    return pkg.AdamOptimizer(alpha=1e-3, weight_decay=0.01, epsilon=1e-4)


def _train(ff, batches):
    step_fn = ff.executor.make_train_step()
    return [float(np.asarray(ff._run_train_step(step_fn, b)["loss"]))
            for b in batches]


@pytest.mark.parametrize("variant,impl", [("primitive", "xla"),
                                          ("fused", "xla"),
                                          ("fused", "flash"),
                                          ("qwen2", "xla")])
def test_loss_history_matches_jax(variant, impl):
    """Three Adam steps of next-token CE from the same weights: the loss
    of every step and the final weights."""
    ffj_, fft_ = _pair(variant, impl, _adam)
    ids = _ids(5, rows=3 * BATCH, cols=SEQ + 1)
    batches = [{"input_ids": ids[i::3, :SEQ], "label": ids[i::3, 1:]}
               for i in range(3)]
    want = _train(ffj_, batches)
    got = _train(fft_, batches)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.isfinite(got).all()
    jp = jax.device_get(ffj_.params)
    for ln, ws in fft_.params.items():
        for wn, t in ws.items():
            np.testing.assert_allclose(_np(t), np.asarray(jp[ln][wn]),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{ln}/{wn}")


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant,impl", [("fused", "xla"),
                                          ("fused", "flash"),
                                          ("gqa", "flash"),
                                          ("qwen2", "xla")])
def test_kv_prefill_and_decode_rows_match_jax(variant, impl):
    """The prefill caches hold keys already rotated, at the kv-head
    count; each decode step's row (RoPE at kv_index) matches JAX's and
    the re-forward's row at the same position."""
    ffj_, fft_ = _shared_pair(variant, impl)
    plen = 5
    ids = _prompt(3, 9)
    ct = fft_.executor.kv_prefill(fft_.params, fft_.state,
                                  {"input_ids": ids}, prefill_len=plen)
    _, cj = ffj_.executor.kv_prefill(ffj_.params, ffj_.state,
                                     {"input_ids": ids},
                                     prefill_len=jnp.int32(plen))
    assert set(ct) == set(cj)
    kvh = VARIANTS[variant][1].get("num_kv_heads", 4)
    for name, bufs in cj.items():
        for k, want in bufs.items():
            assert tuple(ct[name][k].shape) == (BATCH, SEQ, kvh, 8)
            np.testing.assert_allclose(_np(ct[name][k]), np.asarray(want),
                                       atol=ATOL, rtol=0)
    full = np.asarray(ffj_.executor.scored_forward(ffj_.params, ffj_.state,
                                                   {"input_ids": ids}))
    for cur in range(plen, plen + 4):
        step = {"input_ids": ids[:, cur - 1:cur]}
        row, ct = fft_.executor.kv_decode_step(fft_.params, fft_.state,
                                               step, ct, cur - 1)
        rj, cj = ffj_.executor.kv_decode_step(ffj_.params, ffj_.state, step,
                                              cj, jnp.int32(cur - 1))
        np.testing.assert_allclose(_np(row), np.asarray(rj), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(_np(row), full[:, cur - 1], atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("variant,impl", [("fused", "xla"),
                                          ("fused", "flash"),
                                          ("window", "xla"),
                                          ("qwen2", "flash")])
def test_greedy_generation_matches_jax(variant, impl):
    """Greedy KV decode, scalar and ragged prompts, through FFModel and
    InferenceSession: tokens identical to JAX's, every chosen token
    decided by a clear margin, no fallback to the re-forward."""
    ffj_, fft_ = _shared_pair(variant, impl)
    for plen, steps in ((4, 6), (np.array([3, 6], np.int32), 5)):
        ids = _prompt(6, plen)
        want = np.asarray(ffj_.generate(ids, plen, steps))
        got = _np(fft_.generate(ids, plen, steps))
        np.testing.assert_array_equal(got, want)
        _assert_margins(ffj_, want, plen, steps)
        sess = _np(InferenceSession(fft_, batch_buckets=(BATCH,))
                   .generate(ids, plen, steps))
        np.testing.assert_array_equal(sess, want)
    assert getattr(fft_, "_kv_fallback_count", 0) == 0


def test_primitive_generates_by_reforward_like_jax_and_the_fused_form():
    """The primitive form is not KV-eligible (no attention op to cache),
    so it generates by full re-forwards, as JAX's does; with its weights
    fused, the fused form's KV decode gives the same tokens."""
    ffj_, fft_ = _shared_pair("primitive")
    names = {t.name for t in fft_.graph_inputs}
    assert not fft_._kv_decode_eligible(names, None)
    assert not ffj_._kv_decode_eligible(names, None)
    ids = _prompt(7, 4)
    want = np.asarray(ffj_.generate(ids, 4, 6))
    got = _np(fft_.generate(ids, 4, 6))
    np.testing.assert_array_equal(got, want)
    _assert_margins(ffj_, want, 4, 6)
    assert getattr(fft_, "_kv_fallback_count", 0) == 0
    ff = _llama(fft, LlamaConfig, build_llama, "fused", device="cpu")
    ff.params = llama_fuse_params(fft_.params, _lcfg(LlamaConfig))
    assert ff._kv_decode_eligible(names, None)
    np.testing.assert_array_equal(_np(ff.generate(ids, 4, 6)), want)


# ---------------------------------------------------------------------------
# the executor frees dead activations when autograd records nothing
# ---------------------------------------------------------------------------
def test_freeing_dead_activations_is_bit_identical():
    _, fft_ = _shared_pair("fused")
    ex, prog = fft_.executor, fft_.executor.program
    ids = _ids(8)

    def run(grad):
        ctx = ex._kv_ctx(None, fft_.state)
        env = prog.init_env({"input_ids": ids}, fft_.device)
        with torch.set_grad_enabled(grad):
            prog.emit_layers(prog.layers, env, fft_.params, ctx)
        return env

    kept, freed = run(True), run(False)
    assert len(kept) == len(prog.layers) + 1       # every output, the ids
    out = prog.output_tensors[0].guid
    # only the graph's output survives, beside the unread-after-use ids
    assert set(freed) == {out}
    assert torch.equal(kept[out], freed[out])
    # the public entries agree with a forward that keeps everything
    with torch.enable_grad():
        keep_all = ex.scored_forward(fft_.params, fft_.state,
                                     {"input_ids": ids})
    assert torch.equal(keep_all, ex.scored_forward(fft_.params, fft_.state,
                                                   {"input_ids": ids}))


# ---------------------------------------------------------------------------
# HuggingFace checkpoints
# ---------------------------------------------------------------------------
def _hf_llama(kv_heads=4):
    from transformers import LlamaConfig as HFLlamaConfig
    from transformers import LlamaForCausalLM
    torch.manual_seed(0)
    return LlamaForCausalLM(HFLlamaConfig(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=kv_heads, max_position_embeddings=SEQ,
        rope_theta=10000.0, rms_norm_eps=1e-6, attention_bias=False,
        tie_word_embeddings=False)).eval()


def _hf_qwen2():
    from transformers import Qwen2Config, Qwen2ForCausalLM
    torch.manual_seed(0)
    return Qwen2ForCausalLM(Qwen2Config(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=SEQ, rms_norm_eps=1e-6,
        tie_word_embeddings=True, sliding_window=None,
        use_sliding_window=False)).eval()


def _hf_check(hf, variant, fused):
    """Port probabilities within 2e-4 of transformers' softmax (the JAX
    package's HF tolerance) and greedy tokens equal to hf.generate."""
    _, over = VARIANTS[variant]
    lc = _lcfg(LlamaConfig, **over)
    ff = _llama(fft, LlamaConfig, build_llama,
                variant if fused else "primitive", device="cpu")
    ff.params = llama_load_hf_state_dict(hf.state_dict(), lc, fused=fused,
                                         device="cpu")
    ids = _ids(9)
    probs = _np(ff.executor.make_forward()(ff.params, ff.state,
                                           {"input_ids": ids}))
    with torch.no_grad():
        want = torch.softmax(hf(torch.from_numpy(ids).long()).logits,
                             dim=-1).numpy()
    assert np.abs(probs - want).max() < 2e-4
    prompt = np.zeros((1, SEQ), np.int32)
    prompt[0, :4] = ids[0, :4]
    ours = _np(ff.generate(np.repeat(prompt, BATCH, 0), 4, 5))[0, :9]
    with torch.no_grad():
        theirs = hf.generate(torch.from_numpy(prompt[:, :4]).long(),
                             max_new_tokens=5, do_sample=False).numpy()[0]
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("fused", [False, True])
def test_hf_llama_matches_transformers(fused):
    pytest.importorskip("transformers")
    _hf_check(_hf_llama(), "fused", fused)


def test_hf_llama_gqa_matches_transformers():
    pytest.importorskip("transformers")
    _hf_check(_hf_llama(kv_heads=2), "gqa", True)


def test_hf_qwen2_matches_transformers():
    """q/k/v biases, GQA and a tied LM head (no lm_head.weight)."""
    pytest.importorskip("transformers")
    _hf_check(_hf_qwen2(), "qwen2", True)


def test_hf_loader_refuses_what_the_layout_cannot_take():
    pytest.importorskip("transformers")
    hf = _hf_llama(kv_heads=2)
    with pytest.raises(ValueError, match="fused=True"):
        llama_load_hf_state_dict(hf.state_dict(),
                                 _lcfg(LlamaConfig, num_kv_heads=2),
                                 device="cpu")
    sd = dict(_hf_llama().state_dict())
    sd["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(32)
    with pytest.raises(ValueError, match="unmapped"):
        llama_load_hf_state_dict(sd, _lcfg(LlamaConfig), device="cpu")
    params = llama_load_hf_state_dict(_hf_qwen2().state_dict(),
                                      _lcfg(LlamaConfig, num_kv_heads=2,
                                            attention_bias=True),
                                      fused=True, device="cpu")
    assert all(t.dtype == torch.float32 for ws in params.values()
               for t in ws.values())
    # bf16 checkpoints are widened to the f32 masters
    bf = {k: v.to(torch.bfloat16) for k, v in _hf_llama().state_dict()
          .items()}
    p16 = llama_load_hf_state_dict(bf, _lcfg(LlamaConfig), device="cpu")
    assert p16["q_proj_0"]["kernel"].dtype == torch.float32
