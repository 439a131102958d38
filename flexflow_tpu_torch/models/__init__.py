from .vision import (build_alexnet, build_alexnet_cifar10,  # noqa: F401
                     build_inception_v3, build_resnet50, build_resnext50)
from .nlp import (BertConfig, GPTConfig, LlamaConfig,  # noqa: F401
                  MixtralConfig, NMTConfig, TransformerConfig, build_bert,
                  build_gpt2, build_llama, build_mixtral, build_nmt,
                  build_transformer)
from .recsys import DLRMConfig, XDLConfig, build_dlrm, build_xdl  # noqa: F401
from .misc import (CandleConfig, MoeConfig, build_candle_uno,  # noqa: F401
                   build_mlp, build_moe_mnist)
