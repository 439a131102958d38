"""NLP model zoo of the serving slice: BERT.

The port of ``BertConfig`` and ``build_bert`` in
``flexflow_tpu/models/nlp.py``: the same layer sequence, so a BERT built
in both packages lines up layer for layer (``interop``). The Transformer,
GPT-2, NMT, LLaMA and Mixtral builders come with later slices.
"""
from __future__ import annotations

import dataclasses

from ..ffconst import ActiMode, AggrMode, DataType
from ..model import FFModel


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
