"""NLP model zoo: the Transformer encoder, BERT, GPT-2, the NMT seq2seq,
the LLaMA family and Mixtral.

The port of ``TransformerConfig``/``build_transformer``,
``BertConfig``/``build_bert``, ``GPTConfig``/``build_gpt2``,
``NMTConfig``/``build_nmt``, ``LlamaConfig``/``build_llama`` (with
``llama_fuse_params`` and ``llama_load_hf_state_dict``) and
``MixtralConfig``/``build_mixtral`` (with ``mixtral_load_hf_state_dict``)
in ``flexflow_tpu/models/nlp.py``: the same layer sequences and weight
layouts, so a model built in both packages lines up layer for layer
(``interop``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ffconst import ActiMode, AggrMode, DataType
from ..model import FFModel


@dataclasses.dataclass
class TransformerConfig:
    """The reference ``transformer.cc`` TransformerConfig defaults."""
    hidden_size: int = 512
    embedding_size: int = 512
    num_heads: int = 8
    num_layers: int = 6
    sequence_length: int = 512


def create_attention_encoder(ff: FFModel, input, hidden_dim: int,
                             num_heads: int, kdim: int, vdim: int):
    """One encoder layer as the reference ``transformer.cc:33-45``: MHA,
    then two dense layers; no residual and no LayerNorm (the reference
    example has neither)."""
    t = ff.multihead_attention(input, input, input, hidden_dim, num_heads,
                               kdim, vdim)
    return ff.dense(ff.dense(t, hidden_dim, ActiMode.AC_MODE_RELU,
                             use_bias=False),
                    hidden_dim, ActiMode.AC_MODE_NONE, use_bias=False)


def build_transformer(ff: FFModel, batch_size: int,
                      cfg: TransformerConfig | None = None):
    """The reference Transformer benchmark (``transformer.cc:135-158``):
    an encoder stack on (B, L, H) input, a final dense(1); MSE loss. kdim
    = vdim = hidden / heads, which the op splits over the heads again, so
    each head is hidden / heads**2 wide (8 at the defaults)."""
    cfg = cfg or TransformerConfig()
    x = ff.create_tensor((batch_size, cfg.sequence_length, cfg.hidden_size),
                         name="input")
    t = x
    for _ in range(cfg.num_layers):
        t = create_attention_encoder(ff, t, cfg.hidden_size, cfg.num_heads,
                                     cfg.hidden_size // cfg.num_heads,
                                     cfg.hidden_size // cfg.num_heads)
    return ff.dense(t, 1, ActiMode.AC_MODE_NONE, use_bias=False)


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024        # BERT-large
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    num_labels: int = 2

    @classmethod
    def base(cls):
        return cls(hidden_size=768, num_layers=12, num_heads=12,
                   intermediate_size=3072)

    @classmethod
    def tiny(cls):
        """For tests/compile checks."""
        return cls(vocab_size=1024, hidden_size=64, num_layers=2,
                   num_heads=4, intermediate_size=128, max_position=64)


def _bert_layer(ff: FFModel, t, cfg: BertConfig, causal: bool = False):
    attn = ff.multihead_attention(t, t, t, cfg.hidden_size, cfg.num_heads,
                                  dropout=cfg.dropout, causal=causal)
    t = ff.layer_norm(ff.add(t, ff.dropout(attn, cfg.dropout)),
                      [-1])
    ffn = ff.dense(t, cfg.intermediate_size, ActiMode.AC_MODE_GELU)
    ffn = ff.dense(ffn, cfg.hidden_size)
    return ff.layer_norm(ff.add(t, ff.dropout(ffn, cfg.dropout)), [-1])


def build_bert(ff: FFModel, batch_size: int, seq_len: int,
               cfg: BertConfig | None = None, classifier: bool = True):
    """BERT encoder (token ids -> pooled classification probabilities).

    Post-LN encoder; embeddings = word + position. The pooler reshapes
    to the compile-time ``batch_size``, so a serving session over this
    graph uses that one batch bucket."""
    cfg = cfg or BertConfig()
    ids = ff.create_tensor((batch_size, seq_len), DataType.DT_INT32,
                           name="input_ids")
    pos = ff.create_tensor((batch_size, seq_len), DataType.DT_INT32,
                           name="position_ids")
    tok = ff.embedding(ids, cfg.vocab_size, cfg.hidden_size,
                       AggrMode.AGGR_MODE_NONE, name="word_embeddings")
    pe = ff.embedding(pos, cfg.max_position, cfg.hidden_size,
                      AggrMode.AGGR_MODE_NONE, name="position_embeddings")
    t = ff.layer_norm(ff.add(tok, pe), [-1])
    t = ff.dropout(t, cfg.dropout)
    for _ in range(cfg.num_layers):
        t = _bert_layer(ff, t, cfg)
    if not classifier:
        return t
    # pooler: first-token representation -> dense tanh -> classifier
    cls_tok = ff.reshape(ff.slice_tensor(t, starts=[0], ends=[1], axes=[1]),
                         (batch_size, cfg.hidden_size))
    pooled = ff.dense(cls_tok, cfg.hidden_size, ActiMode.AC_MODE_TANH)
    logits = ff.dense(pooled, cfg.num_labels)
    return ff.softmax(logits)


@dataclasses.dataclass
class GPTConfig:
    """GPT-2 sizes (124M by default; medium 355M, XL 1.5B)."""
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position: int = 1024
    dropout: float = 0.0

    @classmethod
    def gpt2_xl(cls):
        return cls(hidden_size=1600, num_layers=48, num_heads=25)

    @classmethod
    def gpt2_medium(cls):
        return cls(hidden_size=1024, num_layers=24, num_heads=16)

    @classmethod
    def tiny(cls):
        return cls(vocab_size=512, hidden_size=64, num_layers=2,
                   num_heads=4, max_position=128)


def build_gpt2(ff: FFModel, batch_size: int, seq_len: int,
               cfg: GPTConfig | None = None):
    """GPT-2 decoder-only LM: pre-LN blocks, causal attention, an untied
    bias-free LM head, softmax over the vocabulary."""
    cfg = cfg or GPTConfig()
    ids = ff.create_tensor((batch_size, seq_len), DataType.DT_INT32,
                           name="input_ids")
    pos = ff.create_tensor((batch_size, seq_len), DataType.DT_INT32,
                           name="position_ids")
    tok = ff.embedding(ids, cfg.vocab_size, cfg.hidden_size, name="wte")
    pe = ff.embedding(pos, cfg.max_position, cfg.hidden_size, name="wpe")
    t = ff.dropout(ff.add(tok, pe), cfg.dropout)
    for _ in range(cfg.num_layers):
        h = ff.layer_norm(t, [-1])
        attn = ff.multihead_attention(h, h, h, cfg.hidden_size,
                                      cfg.num_heads, dropout=cfg.dropout,
                                      causal=True)
        t = ff.add(t, attn)
        h = ff.layer_norm(t, [-1])
        ffn = ff.dense(h, 4 * cfg.hidden_size, ActiMode.AC_MODE_GELU)
        ffn = ff.dense(ffn, cfg.hidden_size)
        t = ff.add(t, ffn)
    t = ff.layer_norm(t, [-1])
    logits = ff.dense(t, cfg.vocab_size, use_bias=False, name="lm_head")
    return ff.softmax(logits)


@dataclasses.dataclass
class NMTConfig:
    """LSTM seq2seq with attention (the reference's legacy ``nmt/`` app:
    embed -> stacked LSTM encoder/decoder -> attention -> softmax)."""
    src_vocab: int = 32000
    tgt_vocab: int = 32000
    embed_dim: int = 512
    hidden_size: int = 512
    num_layers: int = 2
    num_heads: int = 1           # attention over encoder states


def build_nmt(ff: FFModel, batch_size: int, src_len: int, tgt_len: int,
              cfg: NMTConfig | None = None):
    """Teacher-forcing NMT: an encoder LSTM over the source, a decoder
    LSTM over the (shifted) target, the decoder attending to the encoder
    states, a dense projection to the target vocabulary. Returns (b,
    tgt_len, tgt_vocab) logits; train with sparse CE against the gold
    target."""
    cfg = cfg or NMTConfig()
    src = ff.create_tensor((batch_size, src_len), dtype=DataType.DT_INT32,
                           name="src_ids")
    tgt = ff.create_tensor((batch_size, tgt_len), dtype=DataType.DT_INT32,
                           name="tgt_ids")
    enc = ff.embedding(src, cfg.src_vocab, cfg.embed_dim,
                       AggrMode.AGGR_MODE_NONE, name="src_embed")
    enc = ff.lstm(enc, cfg.hidden_size, cfg.num_layers, name="encoder")
    dec = ff.embedding(tgt, cfg.tgt_vocab, cfg.embed_dim,
                       AggrMode.AGGR_MODE_NONE, name="tgt_embed")
    dec = ff.lstm(dec, cfg.hidden_size, cfg.num_layers, name="decoder")
    # the attention readout over the encoder states, batched over all
    # decoder positions
    ctx = ff.multihead_attention(dec, enc, enc, cfg.hidden_size,
                                 cfg.num_heads, name="attention")
    h = ff.add(dec, ctx, name="attn_residual")
    return ff.dense(h, cfg.tgt_vocab, ActiMode.AC_MODE_NONE,
                    name="vocab_proj")


@dataclasses.dataclass
class LlamaConfig:
    """LLaMA-family decoder (RMSNorm, SwiGLU, rotary embeddings). The
    defaults are LLaMA-7B's geometry (Touvron et al. 2023, Table 2)."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    # grouped-query attention (LLaMA-2-70B/LLaMA-3 family); 0 = MHA.
    # Only the fused_attention build consumes this.
    num_kv_heads: int = 0
    # Mistral-family sliding-window attention; 0 = full causal.
    # fused_attention only.
    sliding_window: int = 0
    # Qwen2-family q/k/v projection biases (o_proj stays bias-free; the
    # fused op's bo is zero). fused_attention only.
    attention_bias: bool = False
    max_position: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6

    @classmethod
    def tiny(cls):
        return cls(vocab_size=96, hidden_size=32, intermediate_size=64,
                   num_layers=2, num_heads=4, max_position=64)


def _rope_tables(seq_len: int, head_dim: int, theta: float):
    """(1, 1, s, d) f32 cos and sin tables of the primitive build's RoPE,
    in float64 then cast, as the JAX package builds them."""
    inv = 1.0 / theta ** (np.arange(0, head_dim, 2) / head_dim)
    freqs = np.outer(np.arange(seq_len), inv)          # (s, d/2)
    emb = np.concatenate([freqs, freqs], axis=-1)      # (s, d) half-split
    shape = (1, 1, seq_len, head_dim)
    return (np.cos(emb).reshape(shape).astype(np.float32),
            np.sin(emb).reshape(shape).astype(np.float32))


def build_llama(ff: FFModel, batch_size: int, seq_len: int,
                cfg: LlamaConfig | None = None, lm_head: bool = True,
                fused_attention: bool = False):
    """Causal LM: (b, s) token ids -> (b, s, vocab) probabilities (or the
    final hidden states when ``lm_head=False``), HF weight layout (q/k/v/o
    and gate/up/down per layer, half-split rotate RoPE).

    ``fused_attention=True`` builds each attention block as one
    OP_MULTIHEAD_ATTENTION with in-op RoPE (GQA, sliding window and q/k/v
    biases as the config asks): it takes the flash kernel and the KV-cache
    decode. The primitive form (dense / transpose / batch_matmul / slice /
    concat, its RoPE tables and causal mask as constant tensors) computes
    the same function but carries seq-length-baked constants, so it
    generates by full re-forwards. ``llama_fuse_params`` converts its
    weights to the fused layout."""
    cfg = cfg or LlamaConfig()
    b, s = batch_size, seq_len
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh

    ids = ff.create_tensor((b, s), DataType.DT_INT32, name="input_ids")
    h = ff.embedding(ids, cfg.vocab_size, cfg.hidden_size,
                     AggrMode.AGGR_MODE_NONE, name="embed_tokens")

    def mlp_block(h, i):
        """SwiGLU MLP and residual, shared by both attention forms (the
        layer names are llama_fuse_params' pass-through contract)."""
        x2 = ff.rms_norm(h, eps=cfg.rms_eps, name=f"post_norm_{i}")
        gate = ff.dense(x2, cfg.intermediate_size, use_bias=False,
                        name=f"gate_proj_{i}")
        up = ff.dense(x2, cfg.intermediate_size, use_bias=False,
                      name=f"up_proj_{i}")
        silu = ff.multiply(gate, ff.sigmoid(gate), name=f"silu_{i}")
        down = ff.dense(ff.multiply(silu, up), cfg.hidden_size,
                        use_bias=False, name=f"down_proj_{i}")
        return ff.add(h, down, name=f"mlp_res_{i}")

    def head(h):
        h = ff.rms_norm(h, eps=cfg.rms_eps, name="final_norm")
        if not lm_head:
            return h
        # a final softmax, so the loss takes CE on its input logits (the
        # executor's rule, as for build_gpt2 / build_bert)
        return ff.softmax(ff.dense(h, cfg.vocab_size, use_bias=False,
                                   name="lm_head"))

    if fused_attention:
        for i in range(cfg.num_layers):
            x = ff.rms_norm(h, eps=cfg.rms_eps, name=f"input_norm_{i}")
            attn_out = ff.multihead_attention(
                x, x, x, cfg.hidden_size, nh,
                bias=cfg.attention_bias, causal=True,
                rope=True, rope_theta=cfg.rope_theta,
                num_kv_heads=cfg.num_kv_heads,
                sliding_window=cfg.sliding_window, name=f"attn_{i}")
            h = ff.add(h, attn_out, name=f"attn_res_{i}")
            h = mlp_block(h, i)
        return head(h)

    if cfg.sliding_window or cfg.attention_bias \
            or cfg.num_kv_heads not in (0, nh):
        raise ValueError(
            "sliding_window/GQA/attention_bias need "
            "fused_attention=True: the primitive build is plain full "
            "bias-free MHA")
    cos_np, sin_np = _rope_tables(s, hd, cfg.rope_theta)
    cos_t = ff.create_tensor(cos_np.shape, create_grad=False,
                             name="rope_cos")
    cos_t.set_tensor(cos_np)
    sin_t = ff.create_tensor(sin_np.shape, create_grad=False,
                             name="rope_sin")
    sin_t.set_tensor(sin_np)
    mask_np = np.triu(np.full((1, 1, s, s), -1e9, np.float32), 1)
    mask_t = ff.create_tensor(mask_np.shape, create_grad=False,
                              name="causal_mask")
    mask_t.set_tensor(mask_np)

    def heads(x, name):
        # (b, s, H) -> (b, nh, s, hd)
        return ff.transpose(ff.reshape(x, (b, s, nh, hd),
                                       name=f"{name}_split"),
                            (0, 2, 1, 3), name=f"{name}_t")

    def rope(x, name):
        x1 = ff.slice_tensor(x, [0], [hd // 2], [3], name=f"{name}_lo")
        x2 = ff.slice_tensor(x, [hd // 2], [hd], [3], name=f"{name}_hi")
        rot = ff.concat([ff.scalar_multiply(x2, -1.0), x1], axis=-1,
                        name=f"{name}_rot")
        return ff.add(ff.multiply(x, cos_t), ff.multiply(rot, sin_t),
                      name=f"{name}_rope")

    for i in range(cfg.num_layers):
        x = ff.rms_norm(h, eps=cfg.rms_eps, name=f"input_norm_{i}")
        q = rope(heads(ff.dense(x, cfg.hidden_size, use_bias=False,
                                name=f"q_proj_{i}"), f"q{i}"), f"q{i}")
        k = rope(heads(ff.dense(x, cfg.hidden_size, use_bias=False,
                                name=f"k_proj_{i}"), f"k{i}"), f"k{i}")
        v = heads(ff.dense(x, cfg.hidden_size, use_bias=False,
                           name=f"v_proj_{i}"), f"v{i}")
        kt = ff.transpose(k, (0, 1, 3, 2), name=f"kT_{i}")
        scores = ff.scalar_multiply(
            ff.batch_matmul(q, kt, name=f"qk_{i}"), 1.0 / math.sqrt(hd))
        probs = ff.softmax(ff.add(scores, mask_t), axis=-1,
                           name=f"probs_{i}")
        ctx = ff.batch_matmul(probs, v, name=f"ctx_{i}")
        merged = ff.reshape(ff.transpose(ctx, (0, 2, 1, 3)),
                            (b, s, cfg.hidden_size), name=f"merge_{i}")
        attn_out = ff.dense(merged, cfg.hidden_size, use_bias=False,
                            name=f"o_proj_{i}")
        h = ff.add(h, attn_out, name=f"attn_res_{i}")
        h = mlp_block(h, i)

    return head(h)


def _fuse_qkvo(q, k, v, o, e, nh, kvh):
    """(in, out) dense kernels -> the fused attention's wq/wk/wv (e,
    heads, hd) and wo (nh, hd, e): the one reshape convention of
    llama_fuse_params and the HF loader (numpy arrays or tensors)."""
    hd = e // nh
    return {"wq": q.reshape(e, nh, hd),
            "wk": k.reshape(e, kvh, hd),
            "wv": v.reshape(e, kvh, hd),
            "wo": o.reshape(nh, hd, e)}


def llama_fuse_params(params, cfg: LlamaConfig):
    """Primitive-layout LLaMA params (``q_proj_{i}`` / ``k_proj_{i}`` /
    ``v_proj_{i}`` / ``o_proj_{i}`` dense kernels, the HF import layout)
    in the fused-attention layout (``attn_{i}``: wq/wk/wv (e, h, d), wo
    (h, d, e)). Norms, FFN, embeddings and lm_head share names and pass
    through as they are, so primitive weights serve through the flash and
    KV-decode path. Leaves may be tensors or numpy arrays; the fused ones
    are reshaped views of them."""
    if cfg.num_kv_heads not in (0, cfg.num_heads):
        raise ValueError(
            "llama_fuse_params converts the MHA primitive layout; a GQA "
            "target (num_kv_heads < num_heads) has no primitive source: "
            "load GQA checkpoints into the fused layout directly")
    nh = cfg.num_heads
    e = cfg.hidden_size
    fused = {f"attn_{i}": _fuse_qkvo(
        params[f"q_proj_{i}"]["kernel"], params[f"k_proj_{i}"]["kernel"],
        params[f"v_proj_{i}"]["kernel"], params[f"o_proj_{i}"]["kernel"],
        e, nh, nh) for i in range(cfg.num_layers)}
    skip = {f"{p}_proj_{i}" for i in range(cfg.num_layers)
            for p in ("q", "k", "v", "o")}
    out = {name: leaf for name, leaf in params.items() if name not in skip}
    out.update(fused)
    return out


def llama_load_hf_state_dict(state_dict, cfg: LlamaConfig,
                             fused: bool = False, device="cuda"):
    """A HuggingFace ``LlamaForCausalLM`` (or ``Qwen2ForCausalLM``) state
    dict in ``build_llama``'s parameter layout: primitive by default,
    fused-attention with ``fused`` (which GQA and q/k/v-bias checkpoints
    need). HF stores Linear weights as (out, in), dense kernels here are
    (in, out); RoPE carries no weights. A checkpoint without
    ``lm_head.weight`` ties the head to the embedding. Values may be
    tensors (bf16 ones are widened: the params are f32 masters) or numpy
    arrays. Returns the params tree, f32 tensors on ``device`` (the card
    unless the caller asks for the CPU, as ``FFModel`` does; the widening
    and transposes run there), for ``FFModel.params``; a checkpoint tensor
    the layout does not take raises."""
    nh = cfg.num_heads
    e = cfg.hidden_size
    hd = e // nh
    kvh = cfg.num_kv_heads or nh
    if (kvh != nh or cfg.attention_bias) and not fused:
        raise ValueError("GQA / attention-bias checkpoints need "
                         "fused=True (the primitive build is plain "
                         "bias-free MHA)")
    sd = {k: torch.as_tensor(v).detach().to(device=device,
                                             dtype=torch.float32)
          for k, v in state_dict.items()}
    consumed = set()

    def take(key):
        consumed.add(key)
        return sd[key]

    # tie_word_embeddings checkpoints (Llama-3.2-1B/3B, small Qwen2) omit
    # lm_head.weight: the head shares the embedding matrix
    lm_w = take("lm_head.weight") if "lm_head.weight" in sd \
        else sd["model.embed_tokens.weight"]
    params = {
        "embed_tokens": {"kernel": take("model.embed_tokens.weight")},
        "final_norm": {"scale": take("model.norm.weight")},
        "lm_head": {"kernel": lm_w.t().contiguous()},
    }
    if params["embed_tokens"]["kernel"].shape[1] != e:
        raise ValueError(
            f"embed_tokens kernel shape "
            f"{tuple(params['embed_tokens']['kernel'].shape)} does not "
            f"match hidden_size {e}")

    def kernel(key):
        return take(key).t().contiguous()

    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        params[f"input_norm_{i}"] = {
            "scale": take(p + "input_layernorm.weight")}
        params[f"post_norm_{i}"] = {
            "scale": take(p + "post_attention_layernorm.weight")}
        for proj in ("gate", "up", "down"):
            params[f"{proj}_proj_{i}"] = {
                "kernel": kernel(p + f"mlp.{proj}_proj.weight")}
        q = kernel(p + "self_attn.q_proj.weight")       # (e, nh*hd)
        k = kernel(p + "self_attn.k_proj.weight")       # (e, kvh*hd)
        v = kernel(p + "self_attn.v_proj.weight")
        o = kernel(p + "self_attn.o_proj.weight")       # (nh*hd, e)
        if tuple(q.shape) != (e, nh * hd) or tuple(k.shape) != (e, kvh * hd):
            raise ValueError(
                f"checkpoint/config head mismatch: q {tuple(q.shape)} "
                f"k {tuple(k.shape)} vs (e={e}, nh={nh}, kvh={kvh}, "
                f"hd={hd})")
        if fused:
            attn = _fuse_qkvo(q, k, v, o, e, nh, kvh)
            if cfg.attention_bias:
                # Qwen2 family: q/k/v carry biases, o_proj does not; the
                # fused op's bo is present but zero
                attn["bq"] = take(p + "self_attn.q_proj.bias").reshape(nh, hd)
                attn["bk"] = take(p + "self_attn.k_proj.bias").reshape(kvh,
                                                                        hd)
                attn["bv"] = take(p + "self_attn.v_proj.bias").reshape(kvh,
                                                                        hd)
                attn["bo"] = torch.zeros(e, device=device)
            params[f"attn_{i}"] = attn
        else:
            params[f"q_proj_{i}"] = {"kernel": q}
            params[f"k_proj_{i}"] = {"kernel": k}
            params[f"v_proj_{i}"] = {"kernel": v}
            params[f"o_proj_{i}"] = {"kernel": o}
    # every checkpoint tensor must be mapped (the legacy rotary inv_freq
    # buffers are recomputed in the op): a dropped weight (attention
    # biases, extra layers) would give wrong numbers with no signal
    leftover = [k_ for k_ in sd
                if k_ not in consumed and "rotary_emb" not in k_]
    if leftover:
        raise ValueError(
            f"unmapped checkpoint tensors {sorted(leftover)[:8]}"
            f"{'...' if len(leftover) > 8 else ''}: config/architecture "
            f"mismatch (attention_bias / num_layers / tied embeddings?)")
    return params


@dataclasses.dataclass
class MixtralConfig:
    """Mixtral-family sparse-MoE decoder (Mistral backbone: fused
    attention + GQA + RoPE, FFN replaced by a top-k mixture of SwiGLU
    experts). The defaults are Mixtral-8x7B's widths; ``rope_theta`` and
    ``rms_eps`` keep the JAX package's defaults (HF's published config
    has 1e6 and 1e-5)."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    num_experts: int = 8
    experts_per_tok: int = 2
    max_position: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    # Mistral-backbone sliding window (HF MixtralConfig defaults 4096);
    # 0 = full causal
    sliding_window: int = 0

    @classmethod
    def tiny(cls):
        return cls(vocab_size=96, hidden_size=32, intermediate_size=64,
                   num_layers=2, num_heads=4, num_kv_heads=2,
                   num_experts=4, experts_per_tok=2, max_position=64)


def build_mixtral(ff: FFModel, batch_size: int, seq_len: int,
                  cfg: MixtralConfig | None = None,
                  lm_head: bool = True):
    """Mixtral decoder as a dense mixture, as the JAX package builds it:
    every expert computes, and each token weights its top-k experts by
    their renormalised router probabilities (HF MixtralSparseMoeBlock's
    function). The dense form keeps shapes static and is KV-decode
    eligible."""
    cfg = cfg or MixtralConfig()
    b, s = batch_size, seq_len
    E, k = cfg.num_experts, cfg.experts_per_tok

    ids = ff.create_tensor((b, s), DataType.DT_INT32, name="input_ids")
    h = ff.embedding(ids, cfg.vocab_size, cfg.hidden_size,
                     AggrMode.AGGR_MODE_NONE, name="embed_tokens")
    # one constant id per expert, shared by every layer's routing mask
    expert_sel = [ff.create_constant((1,), float(e_i), DataType.DT_INT32)
                  for e_i in range(E)]

    for i in range(cfg.num_layers):
        x = ff.rms_norm(h, eps=cfg.rms_eps, name=f"input_norm_{i}")
        attn_out = ff.multihead_attention(
            x, x, x, cfg.hidden_size, cfg.num_heads, bias=False,
            causal=True, rope=True, rope_theta=cfg.rope_theta,
            num_kv_heads=cfg.num_kv_heads,
            sliding_window=cfg.sliding_window, name=f"attn_{i}")
        h = ff.add(h, attn_out, name=f"attn_res_{i}")

        x2 = ff.rms_norm(h, eps=cfg.rms_eps, name=f"post_norm_{i}")
        router = ff.dense(x2, E, use_bias=False, name=f"moe_gate_{i}")
        probs = ff.softmax(router, axis=-1, name=f"moe_probs_{i}")
        vals, idx = ff.top_k(probs, k, True, name=f"moe_topk_{i}")
        denom = ff.reduce_sum(vals, [-1], keepdims=True,
                              name=f"moe_denom_{i}")
        moe_out = None
        for e_i in range(E):
            m = ff.cast(ff.equal(idx, expert_sel[e_i],
                                 name=f"moe_eq_{i}_{e_i}"),
                        DataType.DT_FLOAT, name=f"moe_m_{i}_{e_i}")
            w = ff.divide(
                ff.reduce_sum(ff.multiply(vals, m), [-1], keepdims=True,
                              name=f"moe_w_{i}_{e_i}"),
                denom, name=f"moe_wn_{i}_{e_i}")
            gate = ff.dense(x2, cfg.intermediate_size, use_bias=False,
                            name=f"e{e_i}_w1_{i}")
            up = ff.dense(x2, cfg.intermediate_size, use_bias=False,
                          name=f"e{e_i}_w3_{i}")
            act = ff.multiply(ff.multiply(gate, ff.sigmoid(gate)), up,
                              name=f"moe_act_{i}_{e_i}")
            down = ff.dense(act, cfg.hidden_size, use_bias=False,
                            name=f"e{e_i}_w2_{i}")
            contrib = ff.multiply(down, w, name=f"moe_c_{i}_{e_i}")
            moe_out = contrib if moe_out is None else \
                ff.add(moe_out, contrib, name=f"moe_sum_{i}_{e_i}")
        h = ff.add(h, moe_out, name=f"mlp_res_{i}")

    h = ff.rms_norm(h, eps=cfg.rms_eps, name="final_norm")
    if not lm_head:
        return h
    return ff.softmax(ff.dense(h, cfg.vocab_size, use_bias=False,
                               name="lm_head"))


def mixtral_load_hf_state_dict(state_dict, cfg: MixtralConfig,
                               device="cuda"):
    """A HuggingFace ``MixtralForCausalLM`` state dict in
    ``build_mixtral``'s parameter layout: the fused attention's wq/wk/wv/
    wo (``_fuse_qkvo``), the router ``moe_gate_{i}``, and expert x's w1 /
    w2 / w3 as the dense kernels ``e{x}_w1_{i}`` / ``e{x}_w2_{i}`` /
    ``e{x}_w3_{i}`` (HF Linear weights are (out, in), dense kernels (in,
    out)). Values may be tensors (widened to the f32 masters) or numpy
    arrays. Returns f32 tensors on ``device`` (the card unless the
    caller asks for the CPU); a checkpoint tensor the layout does not take
    raises."""
    nh, e = cfg.num_heads, cfg.hidden_size
    hd = e // nh
    kvh = cfg.num_kv_heads or nh
    sd = {k_: torch.as_tensor(v).detach().to(device=device,
                                              dtype=torch.float32)
          for k_, v in state_dict.items()}
    consumed = set()

    def take(key):
        consumed.add(key)
        return sd[key]

    def kernel(key):
        return take(key).t().contiguous()

    lm_w = take("lm_head.weight") if "lm_head.weight" in sd \
        else sd["model.embed_tokens.weight"]
    params = {
        "embed_tokens": {"kernel": take("model.embed_tokens.weight")},
        "final_norm": {"scale": take("model.norm.weight")},
        "lm_head": {"kernel": lm_w.t().contiguous()},
    }
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        params[f"input_norm_{i}"] = {
            "scale": take(p + "input_layernorm.weight")}
        params[f"post_norm_{i}"] = {
            "scale": take(p + "post_attention_layernorm.weight")}
        q = kernel(p + "self_attn.q_proj.weight")
        k = kernel(p + "self_attn.k_proj.weight")
        if tuple(q.shape) != (e, nh * hd) or tuple(k.shape) != (e, kvh * hd):
            raise ValueError(
                f"checkpoint/config head mismatch: q {tuple(q.shape)} "
                f"k {tuple(k.shape)} vs (e={e}, nh={nh}, kvh={kvh}, "
                f"hd={hd})")
        params[f"attn_{i}"] = _fuse_qkvo(
            q, k, kernel(p + "self_attn.v_proj.weight"),
            kernel(p + "self_attn.o_proj.weight"), e, nh, kvh)
        params[f"moe_gate_{i}"] = {
            "kernel": kernel(p + "block_sparse_moe.gate.weight")}
        for x in range(cfg.num_experts):
            ep = p + f"block_sparse_moe.experts.{x}."
            for w in ("w1", "w2", "w3"):
                params[f"e{x}_{w}_{i}"] = {
                    "kernel": kernel(ep + f"{w}.weight")}
    leftover = [k_ for k_ in sd
                if k_ not in consumed and "rotary_emb" not in k_]
    if leftover:
        raise ValueError(f"unmapped checkpoint tensors "
                         f"{sorted(leftover)[:8]}: config mismatch")
    return params
