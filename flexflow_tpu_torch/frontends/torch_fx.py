"""PyTorch frontend: torch.fx symbolic trace -> FFModel builder calls.

The port of ``flexflow_tpu/frontends/torch_fx.py``: the same tracing,
constant folding, lowering and weight copy, onto the port's ``FFModel``.
Reference parity: ``python/flexflow/torch/model.py`` (``PyTorchModel.
torch_to_ff``, ``_trace_model``): trace the module (HF transformers models
via ``transformers.utils.fx`` when requested), walk nodes in topological
order, and dispatch each fx node to the matching FFModel builder. The
reference's file serialization hand-off is supported with the same names
(``torch_to_file`` / ``file_to_ff``; ``model.py:2408-2604``), in the JAX
package's file format, so a graph file written by either package loads
in the other. ``transformers`` is imported only on the HF paths.

Constants the trace folds (``torch.arange`` positions, masks, buffers)
become constant input tensors of the graph (``create_tensor(create_grad=
False)`` + ``set_tensor``), which the executor puts on the device once,
at ``compile``.

Weight transfer: ``PyTorchModel.copy_weights(ff)`` moves the torch
module's trained parameters into the compiled FFModel (the reference used
``Parameter.set_weights`` NumPy round-trips the same way). As in the JAX
package, ``nn.MultiheadAttention`` weights are not copied: the FF
attention layer keeps its own initialisation, and its input is handed on
as (batch, seq, embed) whatever the module's ``batch_first`` says.
"""
from __future__ import annotations

import contextlib
import math
import operator
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..ffconst import AggrMode, DataType, OperatorType, PoolType
from ..core.tensor import Tensor
from ..model import FFModel


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


# HF module classes lowered whole to one FF op (name-matched so imports
# survive transformers version drift); also forced to be fx leaf modules
_OPAQUE_HF_MODULES = frozenset({
    "Conv1D", "T5LayerNorm", "MT5LayerNorm", "LlamaRMSNorm",
    "MistralRMSNorm", "NewGELUActivation", "GELUActivation",
    "FastGELUActivation", "QuickGELUActivation",
})


def _meta_override_for(cls_name: str):
    """Shape-level meta evaluation for an opaque HF module (its real
    weights cannot mix with the tracer's meta tensors)."""
    import torch

    if cls_name == "Conv1D":
        def f(mod, x, *a, **k):
            return torch.empty(*x.shape[:-1], mod.nf, device="meta",
                               dtype=x.dtype)
    else:  # norms / activations: shape-preserving
        def f(mod, x, *a, **k):
            return torch.empty_like(x, device="meta")
    return f


@contextlib.contextmanager
def _patched_hf_mask_vmap(root_module=None):
    """Tracing-compatibility shims for current transformers versions
    (whose fx support has drifted behind the modeling code):

    - ``masking_utils`` builds attention masks with ``torch.vmap``, which
      rejects fx proxies. Its mask functions are elementwise predicates
      over (batch, head, q_idx, kv_idx), so an index-broadcasting
      evaluation is exactly equivalent — swap it in while tracing.
    - ``HFProxy`` installs meta-tensor metadata but defines no
      ``__iter__``, so tuple unpacking (``q, k, v = x.split(...)``,
      ``(*x.shape[:-1], -1)``) raises TraceError; iterate by emitting
      ``getitem`` proxies when the metadata length is known.
    """
    try:
        import transformers.masking_utils as mu
        from transformers.utils import fx as hf_fx
    except ImportError:
        yield
        return
    orig = getattr(mu, "_vmap_for_bhqkv", None)

    def broadcast_bhqkv(mask_function, bh_indices: bool = True):
        if bh_indices:
            def wrapped(batch, head, q, kv):
                return mask_function(batch[:, None, None, None],
                                     head[None, :, None, None],
                                     q[None, None, :, None],
                                     kv[None, None, None, :])
        else:
            def wrapped(batch, head, q, kv):
                return mask_function(batch, head, q[:, None], kv[None, :])
        return wrapped

    def hfproxy_iter(self):
        md = getattr(self, "_metadata", None)
        if md is not None and hasattr(md, "__len__"):
            return iter(self[i] for i in range(len(md)))
        import torch.fx as tfx
        return tfx.Proxy.__iter__(self)

    # keep HF composite modules we lower as single FF ops OPAQUE, so
    # their weights stay trainable layer weights instead of tracing
    # into addmm over frozen get_attr constants
    orig_leaf = hf_fx.HFTracer.is_leaf_module

    def leaf(self, m, qualname):
        return type(m).__name__ in _OPAQUE_HF_MODULES \
            or orig_leaf(self, m, qualname)

    # meta-shape overrides for each opaque module type present in the
    # model (their real weights cannot mix with meta tensors)
    added_overrides = []
    if root_module is not None:
        for _, m in root_module.named_modules():
            t = type(m)
            if t.__name__ in _OPAQUE_HF_MODULES \
                    and t not in hf_fx._MANUAL_META_OVERRIDES:
                hf_fx._MANUAL_META_OVERRIDES[t] = \
                    _meta_override_for(t.__name__)
                added_overrides.append(t)

    orig_iter = getattr(hf_fx.HFProxy, "__iter__", None)
    if orig is not None:
        mu._vmap_for_bhqkv = broadcast_bhqkv
    hf_fx.HFProxy.__iter__ = hfproxy_iter
    hf_fx.HFTracer.is_leaf_module = leaf
    try:
        yield
    finally:
        if orig is not None:
            mu._vmap_for_bhqkv = orig
        hf_fx.HFTracer.is_leaf_module = orig_leaf
        for t in added_overrides:
            del hf_fx._MANUAL_META_OVERRIDES[t]
        if orig_iter is None:
            del hf_fx.HFProxy.__iter__
        else:
            hf_fx.HFProxy.__iter__ = orig_iter


class ConstValue:
    """Host-side constant flowing through the fx graph (shape bookkeeping,
    attention-mask arithmetic, buffer slices). Ops whose inputs are all
    constants are folded eagerly with torch itself; a constant is
    materialized into an FF constant tensor only when it meets a real
    graph tensor (the reference frontend's Node-attribute equivalent)."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = np.asarray(arr)

    @property
    def shape(self):
        return tuple(self.arr.shape)

    def __repr__(self):
        return f"ConstValue{self.shape}"


def _has_graph_tensor(x) -> bool:
    if isinstance(x, Tensor):
        return True
    if isinstance(x, (list, tuple)):
        return any(_has_graph_tensor(v) for v in x)
    if isinstance(x, dict):
        return any(_has_graph_tensor(v) for v in x.values())
    return False


class PyTorchModel:
    def __init__(self, module, is_hf_model: bool = False,
                 batch_size: int = 1,
                 input_names: Optional[Sequence[str]] = None):
        import torch
        self.module = module.eval()
        self.is_hf_model = is_hf_model
        self.batch_size = batch_size
        # explicit trace inputs for HF models whose forward signature the
        # tracer mis-guesses (e.g. T5EncoderModel)
        self.input_names = list(input_names) if input_names else None
        # torch module path -> ALL ff layers it produced (a module called
        # several times, e.g. T5's shared embedding, lowers to several
        # FF layers — every one must receive the weights)
        self._layers_of_module: Dict[str, List[str]] = {}

    # ------------------------------------------------------------------
    def _trace(self):
        import torch.fx
        if self.is_hf_model:
            from transformers.utils import fx as hf_fx
            with _patched_hf_mask_vmap(self.module):
                if self.input_names:
                    return hf_fx.symbolic_trace(
                        self.module, input_names=self.input_names)
                return hf_fx.symbolic_trace(self.module)

        class _Tracer(torch.fx.Tracer):
            # keep modules we lower whole (RMS norms etc.) opaque in the
            # plain-fx path too, so they fuse instead of tracing open
            def is_leaf_module(self, m, qualname):
                return type(m).__name__ in _OPAQUE_HF_MODULES \
                    or super().is_leaf_module(m, qualname)

        tracer = _Tracer()
        graph = tracer.trace(self.module)
        return torch.fx.GraphModule(self.module, graph)

    # ------------------------------------------------------------------
    def torch_to_ff(self, ff: FFModel, input_tensors: Sequence[Tensor]
                    ) -> List[Tensor]:
        """Build the FF graph from the traced module. ``input_tensors``
        bind to placeholders by name when names match, else in order
        (reference ``torch_to_ff``)."""
        import torch
        if self.is_hf_model and not self.input_names:
            # trace exactly the inputs the caller provides, so the HF
            # tracer does not add placeholders (masks etc.) we can't bind
            self.input_names = [t.name for t in input_tensors]
        gm = self._trace()
        modules = dict(gm.named_modules())
        env: Dict[str, Any] = {}
        inputs = list(input_tensors)
        by_name = {t.name: t for t in input_tensors}
        outputs: List[Tensor] = []

        def val(x):
            if isinstance(x, torch.fx.Node):
                return env[x.name]
            if isinstance(x, slice):
                return slice(val(x.start), val(x.stop), val(x.step))
            if isinstance(x, (list, tuple)):
                return type(x)(val(v) for v in x)
            if isinstance(x, dict):
                return {k: val(v) for k, v in x.items()}
            return x

        for node in gm.graph.nodes:
            if node.op == "placeholder":
                t = by_name.get(node.target, by_name.get(node.name))
                if t is not None:
                    env[node.name] = t
                    if t in inputs:
                        inputs.remove(t)
                else:
                    if not inputs:
                        raise ValueError(
                            f"no tensor for placeholder {node.name!r}")
                    env[node.name] = inputs.pop(0)
            elif node.op == "get_attr":
                t = self._get_attr(gm, node.target)
                env[node.name] = ConstValue(t.detach().cpu().numpy())
            elif node.op == "call_module":
                m = modules[node.target]
                a = [self._ensure_tensor(ff, val(x), f"{node.name}_c{i}")
                     for i, x in enumerate(node.args)]
                env[node.name] = self._module_to_ff(ff, m, node, a)
            elif node.op == "call_function":
                a = [val(x) for x in node.args]
                kw = {k: val(v) for k, v in node.kwargs.items()}
                if not (_has_graph_tensor(a) or _has_graph_tensor(kw)):
                    env[node.name] = self._eager(node.target, a, kw)
                else:
                    env[node.name] = self._function_to_ff(ff, node.target,
                                                          node, a, kw)
            elif node.op == "call_method":
                a = [val(x) for x in node.args]
                kw = {k: val(v) for k, v in node.kwargs.items()}
                if not (_has_graph_tensor(a) or _has_graph_tensor(kw)):
                    env[node.name] = self._eager_method(node.target, a, kw)
                else:
                    env[node.name] = self._method_to_ff(ff, node.target,
                                                        node, a, kw)
            elif node.op == "output":
                out = val(node.args[0])
                if isinstance(out, dict):
                    out = [v for v in out.values()
                           if isinstance(v, Tensor)]
                outputs = list(out) if isinstance(out, (list, tuple)) \
                    else [out]
                outputs = [o for o in outputs if isinstance(o, Tensor)]
        return outputs

    # ------------------------------------------------------------------
    # const folding
    # ------------------------------------------------------------------
    @staticmethod
    def _to_torch(v):
        import torch
        if isinstance(v, ConstValue):
            return torch.from_numpy(np.ascontiguousarray(v.arr))
        if isinstance(v, (list, tuple)):
            return type(v)(PyTorchModel._to_torch(x) for x in v)
        return v

    @staticmethod
    def _from_torch(r):
        import torch
        if isinstance(r, torch.Tensor):
            return ConstValue(r.detach().cpu().numpy())
        if isinstance(r, (list, tuple)) and not isinstance(r, torch.Size):
            return type(r)(PyTorchModel._from_torch(x) for x in r)
        return r

    def _eager(self, fn, args, kwargs):
        """Fold a call_function over constants by just calling it."""
        return self._from_torch(fn(*self._to_torch(tuple(args)),
                                   **{k: self._to_torch(v)
                                      for k, v in kwargs.items()}))

    def _eager_method(self, method, args, kwargs):
        import torch
        obj, rest = args[0], args[1:]
        tobj = self._to_torch(obj)
        # python-level objects (tuples from size(), ints) pass through
        if not isinstance(tobj, torch.Tensor) and not hasattr(tobj, method):
            raise NotImplementedError(f"eager method {method} on {tobj!r}")
        r = getattr(tobj, method)(*self._to_torch(tuple(rest)),
                                  **{k: self._to_torch(v)
                                     for k, v in kwargs.items()})
        return self._from_torch(r)

    def _ensure_tensor(self, ff: FFModel, v, name: str):
        """Materialize a constant into an FF constant input tensor."""
        if isinstance(v, ConstValue):
            arr = v.arr
            dt = {np.dtype("int64"): DataType.DT_INT32,
                  np.dtype("int32"): DataType.DT_INT32,
                  np.dtype("bool"): DataType.DT_INT32,
                  np.dtype("float64"): DataType.DT_FLOAT,
                  }.get(arr.dtype, DataType.DT_FLOAT)
            if arr.dtype in (np.dtype("int64"), np.dtype("bool")):
                arr = arr.astype(np.int32)
            elif arr.dtype == np.dtype("float64"):
                arr = arr.astype(np.float32)
            t = ff.create_tensor(tuple(arr.shape), dtype=dt,
                                 create_grad=False, name=name)
            t.set_tensor(arr)
            return t
        if isinstance(v, (list, tuple)):
            return type(v)(self._ensure_tensor(ff, x, f"{name}_{i}")
                           for i, x in enumerate(v))
        return v

    @staticmethod
    def _get_attr(gm, target: str):
        obj = gm
        for part in target.split("."):
            obj = getattr(obj, part)
        return obj

    # ------------------------------------------------------------------
    def _module_to_ff(self, ff: FFModel, m, node, args):
        import torch.nn as nn
        x = args[0] if args else None
        name = node.name
        if isinstance(m, nn.Linear):
            out = ff.dense(x, m.out_features, use_bias=m.bias is not None,
                           name=name)
        elif isinstance(m, nn.Conv2d):
            kh, kw = _pair(m.kernel_size)
            sh, sw = _pair(m.stride)
            ph, pw = _pair(m.padding) if not isinstance(m.padding, str) \
                else (0, 0)
            out = ff.conv2d(x, m.out_channels, kh, kw, sh, sw, ph, pw,
                            groups=m.groups, use_bias=m.bias is not None,
                            name=name)
        elif isinstance(m, nn.MaxPool2d):
            kh, kw = _pair(m.kernel_size)
            sh, sw = _pair(m.stride or m.kernel_size)
            ph, pw = _pair(m.padding)
            out = ff.pool2d(x, kh, kw, sh, sw, ph, pw, PoolType.POOL_MAX,
                            name=name)
        elif isinstance(m, (nn.AvgPool2d, nn.AdaptiveAvgPool2d)):
            if isinstance(m, nn.AdaptiveAvgPool2d):
                oh, ow = _pair(m.output_size)
                ih, iw = x.shape[2], x.shape[3]
                kh, kw = ih // oh, iw // ow
                out = ff.pool2d(x, kh, kw, kh, kw, 0, 0, PoolType.POOL_AVG,
                                name=name)
            else:
                kh, kw = _pair(m.kernel_size)
                sh, sw = _pair(m.stride or m.kernel_size)
                ph, pw = _pair(m.padding)
                out = ff.pool2d(x, kh, kw, sh, sw, ph, pw,
                                PoolType.POOL_AVG, name=name)
        elif isinstance(m, nn.BatchNorm2d):
            # momentum=0.0 is legitimate (frozen running stats); only
            # None (torch's "cumulative average" mode) needs a default
            mom = 0.1 if m.momentum is None else m.momentum
            out = ff.batch_norm(x, relu=False, eps=m.eps,
                                momentum=mom, name=name)
        elif isinstance(m, nn.LayerNorm):
            axes = list(range(-len(m.normalized_shape), 0))
            out = ff.layer_norm(x, axes, m.elementwise_affine, m.eps,
                                name=name)
        elif isinstance(m, nn.Embedding):
            out = ff.embedding(x, m.num_embeddings, m.embedding_dim,
                               AggrMode.AGGR_MODE_NONE, name=name)
        elif isinstance(m, nn.EmbeddingBag):
            aggr = {"sum": AggrMode.AGGR_MODE_SUM,
                    "mean": AggrMode.AGGR_MODE_AVG}[m.mode]
            out = ff.embedding(x, m.num_embeddings, m.embedding_dim, aggr,
                               name=name)
        elif isinstance(m, nn.MultiheadAttention):
            q, k, v = args[0], args[1], args[2]
            attn = ff.multihead_attention(q, k, v, m.embed_dim, m.num_heads,
                                          dropout=m.dropout, name=name)
            self._layers_of_module.setdefault(node.target, []) \
                .append(ff.layers[-1].name)
            # torch MHA returns (output, weights); traced graphs getitem(0)
            return [attn, None]
        elif isinstance(m, nn.ReLU):
            out = ff.relu(x, name=name)
        elif isinstance(m, nn.GELU):
            out = ff.gelu(x, name=name)
        elif isinstance(m, nn.Sigmoid):
            out = ff.sigmoid(x, name=name)
        elif isinstance(m, nn.Tanh):
            out = ff.tanh(x, name=name)
        elif isinstance(m, nn.ELU):
            out = ff.elu(x, name=name)
        elif isinstance(m, nn.LeakyReLU):
            out = ff._unary(OperatorType.OP_LEAKYRELU, x, name,
                            negative_slope=m.negative_slope)
        elif isinstance(m, nn.Softmax):
            out = ff.softmax(x, axis=m.dim if m.dim is not None else -1,
                             name=name)
        elif isinstance(m, nn.Dropout):
            out = ff.dropout(x, m.p, name=name)
        elif isinstance(m, nn.Flatten):
            out = ff.flat(x, name=name)
        elif isinstance(m, nn.Identity):
            out = ff.identity(x, name=name)
        elif isinstance(m, nn.Sequential):
            out = x
            for i, sub in enumerate(m):
                # register under the true torch path so copy_weights finds it
                fake = type("N", (), {
                    "name": f"{name}_{i}",
                    "target": f"{node.target}.{i}"})
                out = self._module_to_ff(ff, sub, fake, [out])
            return out
        # HF-transformers module classes, matched by name so importing
        # does not require the specific transformers version (the
        # reference's frontend special-cases these the same way,
        # python/flexflow/torch/model.py T5LayerNorm handling)
        elif type(m).__name__ == "Conv1D" and hasattr(m, "nf"):
            # transformers.pytorch_utils.Conv1D (GPT-2): a Linear that
            # stores its kernel (in, out) — FF's native layout
            out = ff.dense(x, m.nf, use_bias=True, name=name)
        elif type(m).__name__ in ("T5LayerNorm", "MT5LayerNorm",
                                  "LlamaRMSNorm", "MistralRMSNorm"):
            # RMS norm (no mean subtraction, no bias): fuse the whole
            # module to OP_RMSNORM instead of tracing its pow/mean/rsqrt
            eps = getattr(m, "variance_epsilon", getattr(m, "eps", 1e-6))
            out = ff.rms_norm(x, eps=eps, name=name)
        elif type(m).__name__ in ("NewGELUActivation", "GELUActivation",
                                  "FastGELUActivation",
                                  "QuickGELUActivation"):
            out = ff.gelu(x, name=name)
        else:
            raise NotImplementedError(
                f"torch module {type(m).__name__} not supported")
        self._layers_of_module.setdefault(
            node.target if hasattr(node, "target") else name, []) \
            .append(ff.layers[-1].name)
        return out

    def _prep(self, ff, v, name, i):
        """Graph-op operand prep: 0-d constants become python scalars,
        array constants become FF constant tensors."""
        if isinstance(v, ConstValue):
            if v.arr.ndim == 0:
                return v.arr.item()
            return self._ensure_tensor(ff, v, f"{name}_c{i}")
        if isinstance(v, (list, tuple)) and any(
                isinstance(x, ConstValue) for x in v):
            return type(v)(self._prep(ff, x, name, f"{i}_{j}")
                           for j, x in enumerate(v))
        return v

    # ------------------------------------------------------------------
    def _function_to_ff(self, ff: FFModel, fn, node, args, kwargs):
        import torch
        import torch.nn.functional as F
        name = node.name
        raw_args, raw_kwargs = list(args), dict(kwargs)
        args = [self._prep(ff, a, name, i) for i, a in enumerate(args)]
        kwargs = {k: self._prep(ff, v, name, k) for k, v in kwargs.items()}
        if fn in (operator.add, torch.add):
            return self._bin(ff, ff.add, args, name)
        if fn in (operator.sub, torch.sub):
            return self._bin(ff, ff.subtract, args, name)
        if fn in (operator.mul, torch.mul):
            return self._bin(ff, ff.multiply, args, name)
        if fn in (operator.truediv, torch.div):
            return self._bin(ff, ff.divide, args, name)
        if fn in (torch.matmul, torch.bmm):
            return ff.batch_matmul(args[0], args[1], name=name)
        if fn is F.scaled_dot_product_attention:
            # (b, h, s, d) SDPA — lowered to the same op chain the
            # reference's attention uses (scores/softmax/context matmuls);
            # the MHA op path runs the flash kernel instead when the
            # module-level nn.MultiheadAttention is traced
            q, k, v = args[0], args[1], args[2]
            # positional order: (q, k, v, attn_mask, dropout_p, is_causal)
            # — use RAW values so a bool ConstValue mask keeps its dtype
            attn_mask = raw_kwargs.get(
                "attn_mask", raw_args[3] if len(raw_args) > 3 else None)
            dropout_p = raw_kwargs.get(
                "dropout_p", raw_args[4] if len(raw_args) > 4 else 0.0)
            is_causal = raw_kwargs.get(
                "is_causal", raw_args[5] if len(raw_args) > 5 else False)
            scale = kwargs.get("scale") or 1.0 / math.sqrt(q.shape[-1])
            r = len(k.shape)
            perm = list(range(r))
            perm[-1], perm[-2] = perm[-2], perm[-1]
            kt = ff.transpose(k, perm, name=f"{name}_kT")
            scores = ff.scalar_multiply(
                ff.batch_matmul(q, kt, name=f"{name}_qk"), float(scale))
            if is_causal:
                s_q, s_k = q.shape[-2], k.shape[-2]
                mask = np.triu(np.full((s_q, s_k), -1e9, np.float32), 1)
                scores = ff.add(scores, self._ensure_tensor(
                    ff, ConstValue(mask), f"{name}_causal"))
            if attn_mask is not None:
                if isinstance(attn_mask, ConstValue):
                    # torch bool mask = keep-where-True; float = additive
                    if attn_mask.arr.dtype == np.dtype("bool"):
                        attn_mask = ConstValue(np.where(
                            attn_mask.arr, 0.0, -1e9).astype(np.float32))
                    attn_mask = self._ensure_tensor(ff, attn_mask,
                                                    f"{name}_mask")
                scores = ff.add(scores, attn_mask, name=f"{name}_masked")
            probs = ff.softmax(scores, axis=-1, name=f"{name}_probs")
            if dropout_p:
                probs = ff.dropout(probs, dropout_p, name=f"{name}_drop")
            return ff.batch_matmul(probs, v, name=f"{name}_ctx")
        if fn is F.relu or fn is torch.relu:
            return ff.relu(args[0], name=name)
        if fn is F.gelu:
            return ff.gelu(args[0], name=name)
        if fn is F.silu:
            return ff.multiply(args[0], ff.sigmoid(args[0]), name=name)
        if fn is torch.sigmoid or fn is F.sigmoid:
            return ff.sigmoid(args[0], name=name)
        if fn is torch.tanh or fn is F.tanh:
            return ff.tanh(args[0], name=name)
        if fn is F.softmax or fn is torch.softmax:
            axis = kwargs.get("dim", args[1] if len(args) > 1 else -1)
            return ff.softmax(args[0], axis=axis, name=name)
        if fn is F.dropout:
            return ff.dropout(args[0], kwargs.get("p", 0.5), name=name)
        if fn is torch.cat:
            axis = kwargs.get("dim", args[1] if len(args) > 1 else 0)
            return ff.concat(args[0], axis=axis, name=name)
        if fn is torch.flatten:
            return ff.flat(args[0], name=name)
        if fn is torch.transpose:
            d0, d1 = args[1], args[2]
            r = len(args[0].shape)
            perm = list(range(r))
            perm[d0 % r], perm[d1 % r] = perm[d1 % r], perm[d0 % r]
            return ff.transpose(args[0], perm, name=name)
        if fn is torch.permute:
            return ff.transpose(args[0], list(args[1]), name=name)
        if fn is torch.reshape:
            return ff.reshape(args[0], list(args[1]), name=name)
        if fn is torch.exp:
            return ff.exp(args[0], name=name)
        if fn is torch.sqrt:
            return ff.sqrt(args[0], name=name)
        if fn is torch.rsqrt:
            return ff.rsqrt(args[0], name=name)
        if fn is torch.pow or fn is operator.pow:
            return ff.pow(args[0], args[1], name=name)
        if fn is torch.mean:
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            keep = kwargs.get("keepdim", False)
            dims = [dims] if isinstance(dims, int) else list(dims)
            return ff.mean(args[0], dims, keep, name=name)
        if fn is operator.getitem:
            x, idx = args
            if isinstance(x, (list, tuple)):
                return x[idx]
            return self._getitem_tensor(ff, x, idx, name)
        if fn is getattr:
            if args[1] == "device":
                return None  # host bookkeeping; FF placement is global
            if args[1] == "dtype":
                import torch as _t
                return _t.float32  # mask finfo() etc.; FF dtypes are global
            return getattr(args[0], args[1])
        raise NotImplementedError(f"torch function {fn} not supported")

    @staticmethod
    def _bin(ff, builder, args, name):
        a, b = args[0], args[1]
        if isinstance(b, (int, float)):
            sc = {ff.add: ff.scalar_add, ff.subtract: ff.scalar_sub,
                  ff.multiply: ff.scalar_multiply,
                  ff.divide: ff.scalar_true_divide}[builder]
            return sc(a, float(b), name=name)
        return builder(a, b, name=name)

    def _getitem_tensor(self, ff, x, idx, name):
        if not isinstance(idx, tuple):
            idx = (idx,)
        starts, ends, axes, squeeze_axes = [], [], [], []
        for d, i in enumerate(idx):
            if isinstance(i, slice):
                if i.start is None and i.stop is None:
                    continue
                starts.append(i.start or 0)
                ends.append(i.stop if i.stop is not None else x.shape[d])
                axes.append(d)
            elif isinstance(i, int):
                i = i % x.shape[d]  # negative index (e.g. x[:, -1])
                starts.append(i)
                ends.append(i + 1)
                axes.append(d)
                squeeze_axes.append(d)
            elif i is Ellipsis:
                continue
        out = ff.slice_tensor(x, starts, ends, axes, name=name) \
            if starts else x
        if squeeze_axes:
            out = ff.squeeze(out, squeeze_axes)
        return out

    # ------------------------------------------------------------------
    def _method_to_ff(self, ff: FFModel, method: str, node, args, kwargs):
        name = node.name
        args = [self._prep(ff, a, name, i) for i, a in enumerate(args)]
        kwargs = {k: self._prep(ff, v, name, k) for k, v in kwargs.items()}
        x = args[0]
        if method == "to" or method == "type_as":
            # dtype cast; FF tensors stay in their graph dtype (bf16/f32
            # policy handled by emission), so this is an identity
            return x
        if method == "expand":
            sizes = [x.shape[d] if s == -1 else s
                     for d, s in enumerate(args[1:])]
            if tuple(sizes) == tuple(x.shape):
                return x
            raise NotImplementedError("expand to new shape on graph tensor")
        if method == "float":
            return x
        if method == "view" or method == "reshape":
            shape = args[1:] if not isinstance(args[1], (list, tuple)) \
                else list(args[1])
            return ff.reshape(x, [int(s) for s in shape], name=name)
        if method == "flatten":
            return ff.flat(x, name=name)
        if method == "permute":
            perm = args[1:] if not isinstance(args[1], (list, tuple)) \
                else list(args[1])
            return ff.transpose(x, [int(p) for p in perm], name=name)
        if method == "transpose":
            r = len(x.shape)
            d0, d1 = args[1] % r, args[2] % r
            perm = list(range(r))
            perm[d0], perm[d1] = perm[d1], perm[d0]
            return ff.transpose(x, perm, name=name)
        if method == "contiguous" or method == "clone" or method == "detach":
            return x
        if method == "size":
            return x.shape if len(args) == 1 else x.shape[args[1]]
        if method == "mean":
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            dims = [dims] if isinstance(dims, int) else list(dims)
            return ff.mean(x, dims, kwargs.get("keepdim", False), name=name)
        if method == "softmax":
            return ff.softmax(x, kwargs.get("dim", -1), name=name)
        if method == "relu":
            return ff.relu(x, name=name)
        if method == "pow":
            return ff.pow(x, args[1], name=name)
        if method == "rsqrt":
            return ff.rsqrt(x, name=name)
        if method == "sqrt":
            return ff.sqrt(x, name=name)
        if method == "exp":
            return ff.exp(x, name=name)
        if method == "tanh":
            return ff.tanh(x, name=name)
        if method == "sigmoid":
            return ff.sigmoid(x, name=name)
        if method == "sum":
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            dims = [dims] if isinstance(dims, int) else list(dims)
            return ff.reduce_sum(x, dims, kwargs.get("keepdim", False),
                                 name=name)
        if method == "masked_fill":
            mask, value = args[1], args[2]
            # additive lowering: x + where(mask, value, 0); exact for the
            # -inf/-1e9 attention-mask pattern this appears in
            if isinstance(mask, ConstValue):
                add = ConstValue(np.where(
                    mask.arr, np.float32(max(value, -1e9)),
                    np.float32(0.0)))
                return ff.add(x, self._ensure_tensor(ff, add,
                                                     f"{name}_mf"),
                              name=name)
            raise NotImplementedError("masked_fill with tensor mask")
        if method == "unsqueeze":
            return ff.unsqueeze(x, [args[1]], name=name)
        if method == "squeeze":
            return ff.squeeze(x, [args[1]], name=name)
        if method == "split":
            # torch semantics: split(split_size, dim) = chunks OF SIZE
            # split_size (FF's int arg means number of chunks)
            dim = kwargs.get("dim", args[2] if len(args) > 2 else 0)
            ssz = args[1]
            if isinstance(ssz, int):
                d = x.shape[dim % len(x.shape)]
                sizes = [ssz] * (d // ssz)
                if d % ssz:
                    sizes.append(d % ssz)
            else:
                sizes = [int(s) for s in ssz]
            return ff.split(x, sizes, dim, name=name)
        raise NotImplementedError(f"torch method {method} not supported")

    # ------------------------------------------------------------------
    def copy_weights(self, ff: FFModel):
        """Copy torch parameters into the compiled FFModel (transposing
        Linear kernels: torch stores (out, in), FF stores (in, out))."""
        import torch.nn as nn
        for path, mod in self.module.named_modules():
            for lname in self._layers_of_module.get(path, ()):
                if lname in ff.params or lname in ff.state:
                    self._copy_module_weights(ff, mod, lname)

    def _copy_module_weights(self, ff: FFModel, mod, lname: str):
        import torch.nn as nn
        if isinstance(mod, nn.Linear):
            ff.set_weights(lname, "kernel",
                           mod.weight.detach().cpu().numpy().T)
            if mod.bias is not None:
                ff.set_weights(lname, "bias",
                               mod.bias.detach().cpu().numpy())
        elif isinstance(mod, nn.Conv2d):
            ff.set_weights(lname, "kernel",
                           mod.weight.detach().cpu().numpy())
            if mod.bias is not None:
                ff.set_weights(lname, "bias",
                               mod.bias.detach().cpu().numpy())
        elif isinstance(mod, (nn.Embedding, nn.EmbeddingBag)):
            ff.set_weights(lname, "kernel",
                           mod.weight.detach().cpu().numpy())
        elif isinstance(mod, nn.LayerNorm) and mod.elementwise_affine:
            ff.set_weights(lname, "scale",
                           mod.weight.detach().cpu().numpy())
            if mod.bias is not None:  # nn.LayerNorm(bias=False): FF's
                ff.set_weights(lname, "bias",  # zero bias is equivalent
                               mod.bias.detach().cpu().numpy())
        elif isinstance(mod, nn.BatchNorm2d):
            if mod.affine:
                ff.set_weights(lname, "scale",
                               mod.weight.detach().cpu().numpy())
                ff.set_weights(lname, "bias",
                               mod.bias.detach().cpu().numpy())
            if mod.track_running_stats and lname in ff.state:
                ff.set_state(lname, "mean",
                             mod.running_mean.detach().cpu().numpy())
                ff.set_state(lname, "var",
                             mod.running_var.detach().cpu().numpy())
        elif type(mod).__name__ == "Conv1D" and hasattr(mod, "nf"):
            # GPT-2 Conv1D kernel is already (in, out)
            ff.set_weights(lname, "kernel",
                           mod.weight.detach().cpu().numpy())
            ff.set_weights(lname, "bias",
                           mod.bias.detach().cpu().numpy())
        elif type(mod).__name__ in ("T5LayerNorm", "MT5LayerNorm",
                                    "LlamaRMSNorm", "MistralRMSNorm"):
            ff.set_weights(lname, "scale",
                           mod.weight.detach().cpu().numpy())

    # ------------------------------------------------------------------
    # file serialization hand-off (reference ``torch_to_file`` /
    # ``file_to_ff``, python/flexflow/torch/model.py:2408-2604): trace
    # once where torch is installed, then rebuild + train the FF graph
    # anywhere WITHOUT torch. Graph structure goes into JSON (the same
    # program schema the strategy export uses); constant tensors (masks,
    # folded buffers) ride a sidecar ``<path>.npz``.
    # ------------------------------------------------------------------
    def torch_to_file(self, ff: FFModel,
                      input_tensors: Sequence[Tensor], path: str):
        """Build the FF graph from the traced module and serialize it
        (plus its constant inputs) to ``path`` (+ ``path.npz``)."""
        import json
        from ..search.serialization import program_to_json
        outputs = self.torch_to_ff(ff, input_tensors)
        consts = [t for t in ff.input_tensors
                  if t.get_tensor() is not None]
        doc = {
            "format": "flexflow-tpu-graph-v1",
            "inputs": [{"name": t.name, "shape": list(t.shape),
                        "dtype": int(t.dtype)}
                       for t in input_tensors],
            "consts": [{"name": t.name, "shape": list(t.shape),
                        "dtype": int(t.dtype)} for t in consts],
            "program": program_to_json(
                ff.layers, list(input_tensors) + consts, outputs[0]),
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        if consts:
            np.savez(path + ".npz",
                     **{t.name: np.asarray(t.get_tensor())
                        for t in consts})
        return outputs

    export_graph = torch_to_file

    @staticmethod
    def file_to_ff(path: str, ff: FFModel,
                   input_tensors: Sequence[Tensor]) -> List[Tensor]:
        """Rebuild a serialized graph into ``ff`` — no torch needed.
        ``input_tensors`` bind by position to the recorded inputs."""
        import json
        from ..search.serialization import program_from_json
        with open(path) as f:
            doc = json.load(f)
        if doc.get("format") != "flexflow-tpu-graph-v1":
            raise ValueError(f"not a graph file: {path}")
        if len(input_tensors) != len(doc["inputs"]):
            raise ValueError(
                f"{len(input_tensors)} input tensors for "
                f"{len(doc['inputs'])} recorded inputs")
        for t, rec in zip(input_tensors, doc["inputs"]):
            if tuple(t.shape) != tuple(rec["shape"]):
                raise ValueError(
                    f"input {rec['name']}: expected {rec['shape']}, "
                    f"got {t.shape}")
            t.name = rec["name"]
        consts = []
        if doc["consts"]:
            data = np.load(path + ".npz")
            for rec in doc["consts"]:
                t = ff.create_tensor(tuple(rec["shape"]),
                                     dtype=DataType(rec["dtype"]),
                                     create_grad=False, name=rec["name"])
                t.set_tensor(data[rec["name"]])
                consts.append(t)
        layers, out_t = program_from_json(
            doc["program"], list(input_tensors) + consts)
        ff.layers.extend(layers)
        return [out_t]

    import_graph = file_to_ff


def torch_to_flexflow_graph(module, ff: FFModel,
                            input_tensors: Sequence[Tensor],
                            is_hf_model: bool = False):
    """One-call convenience (reference ``fx.torch_to_flexflow``)."""
    m = PyTorchModel(module, is_hf_model)
    return m, m.torch_to_ff(ff, input_tensors)
