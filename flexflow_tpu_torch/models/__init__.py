from .nlp import BertConfig, GPTConfig, build_bert, build_gpt2  # noqa: F401
