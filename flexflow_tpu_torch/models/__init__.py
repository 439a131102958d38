from .nlp import BertConfig, build_bert  # noqa: F401
