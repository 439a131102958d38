from .misc import (CandleConfig, MoeConfig, build_candle_uno,  # noqa: F401
                   build_mlp, build_moe_mnist)
from .nlp import (BertConfig, GPTConfig, LlamaConfig,  # noqa: F401
                  MixtralConfig, build_bert, build_gpt2, build_llama,
                  build_mixtral)
