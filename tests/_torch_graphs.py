"""Graphs built the same way in both packages, for the search tests
(``test_torch_costmodel.py``, ``test_torch_substitution.py``,
``test_torch_search.py``, ``test_torch_remat.py``): each builder returns
the JAX package's FFModel and the port's, layer for layer the same
graph (names, params, shapes). Nothing is compiled here."""
import flexflow_tpu as ffj
import flexflow_tpu.models as jmodels
import flexflow_tpu_torch as fft
import flexflow_tpu_torch.models as tmodels


def _pair(build, batch=8, **cfg_kw):
    out = []
    for pkg, models, kw in ((ffj, jmodels, {}),
                            (fft, tmodels, {"device": "cpu"})):
        cfg = pkg.FFConfig()
        cfg.batch_size = batch
        for k, v in cfg_kw.items():
            setattr(cfg, k, v)
        ff = pkg.FFModel(cfg, **kw)
        build(ff, models, batch)
        out.append(ff)
    return tuple(out)


def bert(batch=8, seq=16, layers=2, dropout=0.0, **cfg_kw):
    def build(ff, m, b):
        c = m.BertConfig.tiny()
        c.num_layers, c.max_position, c.dropout = layers, seq, dropout
        m.build_bert(ff, b, seq, c)
    return _pair(build, batch, **cfg_kw)


def gpt2(batch=8, seq=16, layers=2, **cfg_kw):
    def build(ff, m, b):
        c = m.GPTConfig.tiny()
        c.num_layers, c.max_position = layers, seq
        m.build_gpt2(ff, b, seq, c)
    return _pair(build, batch, **cfg_kw)


def llama(batch=4, seq=12, layers=3, **cfg_kw):
    def build(ff, m, b):
        c = m.LlamaConfig.tiny()
        c.num_layers = layers
        m.build_llama(ff, b, seq, c)
    return _pair(build, batch, **cfg_kw)


def resnet(batch=8, **cfg_kw):
    def build(ff, m, b):
        m.build_resnet50(ff, b, num_classes=10, image_hw=32)
    return _pair(build, batch, **cfg_kw)


def dlrm(batch=8, **cfg_kw):
    def build(ff, m, b):
        c = m.DLRMConfig()
        c.embedding_size = (1000, 2000)
        c.sparse_feature_size = 16
        c.mlp_bot = (4, 16, 16)
        c.mlp_top = (48, 16, 2)
        m.build_dlrm(ff, b, c)
    return _pair(build, batch, **cfg_kw)


def mlp(batch=8, **cfg_kw):
    def build(ff, m, b):
        m.build_mlp(ff, b, in_dim=64, hidden=(128, 64), num_classes=10)
    return _pair(build, batch, **cfg_kw)


GRAPHS = {"bert": bert, "gpt2": gpt2, "resnet": resnet, "dlrm": dlrm}
