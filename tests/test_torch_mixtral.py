"""The port's Mixtral against the JAX package: a tiny Mixtral (vocab 96,
hidden 32, 4 heads / 2 kv heads of 8, 4 SwiGLU experts top-2, 2 layers,
seq 12) built through ``FFModel`` in both, the reference's weights carried
into the port by ``interop.load_reference_params``; then the forward
probabilities, a 4-step SGD loss history, the KV prefill caches and decode
rows, greedy tokens (scalar and ragged prompts) against JAX's and the
re-forward oracle's; ``mixtral_load_hf_state_dict`` against the JAX
function's arrays and ``transformers``' own CPU logits for a locally
built tiny ``MixtralForCausalLM``.

f32 compute throughout, so the two graphs agree op for op and differ only
in f32 summation order: probabilities hold to 2e-5, logits, caches and
decode rows to 1e-5, the loss history to 1e-5 relative; tokens must be
identical, each decided by a top-1/top-2 margin above 1e-4 in JAX's rows.
The router's top-k runs on distinct probabilities here, so its picks are
not ties. ``attention:flash`` runs the JAX Pallas kernel in interpret mode
and the port's plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.models import MixtralConfig as JaxMixtralConfig
from flexflow_tpu.models import build_mixtral as jax_build_mixtral
from flexflow_tpu.models.nlp import \
    mixtral_load_hf_state_dict as jax_mixtral_hf
from flexflow_tpu_torch.interop import load_reference_params
from flexflow_tpu_torch.kernels import flash_attention
from flexflow_tpu_torch.models import MixtralConfig, build_mixtral
from flexflow_tpu_torch.models.nlp import mixtral_load_hf_state_dict
from flexflow_tpu_torch.serving import InferenceSession

BATCH, SEQ, VOCAB = 2, 12, 96
ATOL = 1e-5
PROB_TOL = 2e-5
MARGIN = 1e-4


def _mcfg(cls):
    mc = cls.tiny()
    mc.max_position = SEQ
    return mc


def _mixtral(pkg, cfg_cls, builder, impl="xla", **model_kw):
    cfg = pkg.FFConfig()
    cfg.batch_size = BATCH
    cfg.only_data_parallel = True
    cfg.use_bf16_compute = False
    cfg.kernel_impls = f"attention:{impl}"
    ff = pkg.FFModel(cfg, **model_kw)
    out = builder(ff, BATCH, SEQ, _mcfg(cfg_cls))
    ff.compile(pkg.SGDOptimizer(0.01), "sparse_categorical_crossentropy", [],
               output_tensor=out)
    return ff


def _pair(impl="xla"):
    """(JAX model, port model carrying its weights)."""
    ffj_ = _mixtral(ffj, JaxMixtralConfig, jax_build_mixtral, impl)
    fft_ = _mixtral(fft, MixtralConfig, build_mixtral, impl, device="cpu")
    load_reference_params(fft_, jax.device_get(ffj_.params),
                          [(l.name, l.op_type) for l in ffj_.layers])
    return ffj_, fft_


_PAIRS = {}


def _shared_pair(impl="xla"):
    """One pair per impl for the module's inference tests, so JAX compiles
    each program once."""
    if impl not in _PAIRS:
        _PAIRS[impl] = _pair(impl)
    return _PAIRS[impl]


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
    scores = np.asarray(ffj_.executor.scored_forward(
        ffj_.params, ffj_.state, {"input_ids": np.asarray(out, np.int32)}))
    plen = np.broadcast_to(np.asarray(plen), (out.shape[0],))
    for r in range(out.shape[0]):
        for i in range(steps):
            row = np.sort(scores[r, plen[r] - 1 + i])
            assert row[-1] - row[-2] > MARGIN, (r, i, row[-1] - row[-2])


def test_mixtral_config_defaults_are_mixtral_8x7b():
    mc = MixtralConfig()
    assert (mc.vocab_size, mc.hidden_size, mc.intermediate_size,
            mc.num_layers, mc.num_heads, mc.num_kv_heads, mc.num_experts,
            mc.experts_per_tok) == (32000, 4096, 14336, 32, 32, 8, 8, 2)
    assert vars(mc) == vars(JaxMixtralConfig())
    assert vars(MixtralConfig.tiny()) == vars(JaxMixtralConfig.tiny())


def test_graph_lines_up_with_jax():
    ffj_, fft_ = _shared_pair()
    assert [(l.name, int(l.op_type)) for l in fft_.layers] == \
        [(l.name, int(l.op_type)) for l in ffj_.layers]
    # the expert-id constants are graph inputs, not parameters
    assert len(fft_.const_inputs) == 4
    assert all(not any("constant" in ln for ln in p) for p in
               (fft_.params, jax.device_get(ffj_.params)))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_probabilities_match_jax(impl):
    ffj_, fft_ = _shared_pair(impl)
    ids = _ids(0)
    calls = flash_attention.plain_calls
    probs = fft_.executor.make_forward()(fft_.params, fft_.state,
                                         {"input_ids": ids})
    if impl == "flash":
        assert flash_attention.plain_calls - calls == 2   # one per layer
    want = np.asarray(ffj_.executor.make_forward()(
        ffj_.params, ffj_.state, {"input_ids": ids}))
    assert tuple(probs.shape) == (BATCH, SEQ, VOCAB)
    np.testing.assert_allclose(_np(probs), want, atol=PROB_TOL, rtol=0)
    got = fft_.executor.scored_forward(fft_.params, fft_.state,
                                       {"input_ids": ids})
    np.testing.assert_allclose(
        _np(got), np.asarray(ffj_.executor.scored_forward(
            ffj_.params, ffj_.state, {"input_ids": ids})), atol=ATOL,
        rtol=0)
    np.testing.assert_allclose(_np(fft_.forward({"input_ids": ids})), want,
                               atol=PROB_TOL, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_sgd_loss_history_matches_jax(impl):
    """Four SGD steps of next-token CE from the same weights: every
    step's loss within 1e-5 relative, and the final weights."""
    ffj_, fft_ = _pair(impl)
    ids = _ids(5, rows=4 * BATCH, cols=SEQ + 1)
    batches = [{"input_ids": ids[i::4, :SEQ], "label": ids[i::4, 1:]}
               for i in range(4)]
    hist = {}
    for name, ff in (("jax", ffj_), ("port", fft_)):
        step = ff.executor.make_train_step()
        hist[name] = [float(np.asarray(ff._run_train_step(step, b)["loss"]))
                      for b in batches]
    np.testing.assert_allclose(hist["port"], hist["jax"], rtol=1e-5, atol=0)
    assert hist["port"][-1] < hist["port"][0]
    jp = jax.device_get(ffj_.params)
    for ln, ws in fft_.params.items():
        for wn, t in ws.items():
            np.testing.assert_allclose(_np(t), np.asarray(jp[ln][wn]),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{ln}/{wn}")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_kv_prefill_and_decode_rows_match_jax(impl):
    """The prefill caches (rotated keys at the kv-head count) and each
    decode step's row, where routing runs at L = 1 per row, against JAX's
    and the re-forward's row at the same position."""
    ffj_, fft_ = _shared_pair(impl)
    plen = 5
    ids = _prompt(3, 9)
    ct = fft_.executor.kv_prefill(fft_.params, fft_.state,
                                  {"input_ids": ids}, prefill_len=plen)
    _, cj = ffj_.executor.kv_prefill(ffj_.params, ffj_.state,
                                     {"input_ids": ids},
                                     prefill_len=jnp.int32(plen))
    assert set(ct) == set(cj)
    for name, bufs in cj.items():
        for k, want in bufs.items():
            assert tuple(ct[name][k].shape) == (BATCH, SEQ, 2, 8)
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


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_kv_generate_matches_the_reforward_oracle_and_jax(impl):
    """Greedy KV decode, scalar and ragged prompts, through FFModel and
    InferenceSession: tokens equal to the port's re-forward path and to
    JAX's, each decided by a clear margin, no fallback."""
    ffj_, fft_ = _shared_pair(impl)
    for plen, steps in ((4, 5), (np.array([3, 6], np.int32), 5)):
        ids = _prompt(6, plen)
        want = np.asarray(ffj_.generate(ids, plen, steps))
        kv = _np(fft_.generate(ids, plen, steps, kv_cache=True))
        oracle = _np(fft_.generate(ids, plen, steps, kv_cache=False))
        np.testing.assert_array_equal(kv, oracle)
        np.testing.assert_array_equal(kv, want)
        _assert_margins(ffj_, want, plen, steps)
        sess = _np(InferenceSession(fft_, batch_buckets=(BATCH,))
                   .generate(ids, plen, steps))
        np.testing.assert_array_equal(sess, want)
    assert getattr(fft_, "_kv_fallback_count", 0) == 0


# ---------------------------------------------------------------------------
# HuggingFace checkpoints
# ---------------------------------------------------------------------------
def _hf_mixtral():
    from transformers import MixtralConfig as HFMixtralConfig
    from transformers import MixtralForCausalLM
    torch.manual_seed(0)
    return MixtralForCausalLM(HFMixtralConfig(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=SEQ, rms_norm_eps=1e-6, rope_theta=10000.0,
        sliding_window=None, tie_word_embeddings=False)).eval()


def test_hf_loader_gives_the_jax_functions_arrays():
    pytest.importorskip("transformers")
    sd = _hf_mixtral().state_dict()
    got = mixtral_load_hf_state_dict(sd, _mcfg(MixtralConfig), device="cpu")
    want = jax_mixtral_hf({k: v.numpy() for k, v in sd.items()},
                          _mcfg(JaxMixtralConfig))
    assert set(got) == set(want)
    for ln, ws in want.items():
        assert set(got[ln]) == set(ws), ln
        for wn, w in ws.items():
            assert got[ln][wn].dtype == torch.float32
            np.testing.assert_array_equal(_np(got[ln][wn]), np.asarray(w),
                                          err_msg=f"{ln}/{wn}")
    bad = dict(sd)
    bad["model.layers.0.block_sparse_moe.experts.9.w1.weight"] = \
        torch.zeros(64, 32)
    with pytest.raises(ValueError, match="unmapped"):
        mixtral_load_hf_state_dict(bad, _mcfg(MixtralConfig), device="cpu")


def test_hf_mixtral_matches_transformers():
    """Probabilities within 2e-4 of transformers' softmax (the JAX
    package's HF tolerance), and greedy KV tokens equal to hf.generate."""
    pytest.importorskip("transformers")
    hf = _hf_mixtral()
    ff = _mixtral(fft, MixtralConfig, build_mixtral, device="cpu")
    ff.params = mixtral_load_hf_state_dict(hf.state_dict(),
                                           _mcfg(MixtralConfig),
                                           device="cpu")
    ids = _ids(9)
    probs = _np(ff.forward({"input_ids": ids}))
    with torch.no_grad():
        want = torch.softmax(hf(torch.from_numpy(ids).long()).logits,
                             dim=-1).numpy()
    assert np.abs(probs - want).max() < 2e-4
    prompt = np.zeros((1, SEQ), np.int32)
    prompt[0, :4] = ids[0, :4]
    ours = _np(ff.generate(np.repeat(prompt, BATCH, 0), 4, 5,
                           kv_cache=True))[0, :9]
    # no eos: the random model may emit HF's default eos id 2, which
    # would end hf.generate early
    hf.generation_config.eos_token_id = None
    hf.generation_config.pad_token_id = 0
    with torch.no_grad():
        theirs = hf.generate(torch.from_numpy(prompt[:, :4]).long(),
                             max_new_tokens=5, do_sample=False).numpy()[0]
    np.testing.assert_array_equal(ours, theirs)
    assert getattr(ff, "_kv_fallback_count", 0) == 0
