from .nlp import (BertConfig, GPTConfig, LlamaConfig, build_bert,  # noqa: F401
                  build_gpt2, build_llama)
