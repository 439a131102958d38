"""The port's optimizers and fused Adam (flexflow_tpu_torch/runtime/
optimizers.py, kernels/opt_update.py) against the JAX package's.

On the CPU the port's fused wrapper runs its plain version on each leaf;
the JAX Pallas kernel runs in interpret mode. The same numpy leaves, made
from a seed, go to both; ragged leaf sizes exercise the JAX kernel's lane
padding. Updates hold to rtol = 1e-6, atol = 1e-7, the JAX package's own
bound between its fused and unfused Adam (tests/test_kernel_tier.py):
both sides round every f32 operation once, but XLA may contract a
multiply and an add into one FMA where PyTorch does not. A bf16 weight
holds to one bf16 ulp, where such a difference can move its rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.opt_update import \
    fused_adam_update as jax_fused_adam_update
from flexflow_tpu.runtime import optimizers as jax_opt
from flexflow_tpu_torch.kernels.opt_update import (fused_adam_update,
                                                   fused_adam_update_plain)
from flexflow_tpu_torch.runtime import optimizers as opt

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"a": {"kernel": (33, 17), "bias": (5,)},
          "b": {"w": (3, 5, 7), "s": (1,), "big": (130, 129)}}


def _tree(rng, scale=1.0, positive=False):
    def leaf(shape):
        x = rng.standard_normal(shape)
        return (np.abs(x) if positive else x * scale).astype(np.float32)
    return {ln: {wn: leaf(sh) for wn, sh in ws.items()}
            for ln, ws in SHAPES.items()}


def _torch(tree):
    return {ln: {wn: torch.from_numpy(a.copy()) for wn, a in ws.items()}
            for ln, ws in tree.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(port_tree, jax_tree, **tol):
    for ln, ws in port_tree.items():
        for wn, t in ws.items():
            np.testing.assert_allclose(
                t.float().numpy(), np.asarray(jax_tree[ln][wn],
                                              np.float32),
                err_msg=f"{ln}/{wn}", **(tol or TOL))


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_adam_plain_matches_jax_kernel(wd):
    rng = np.random.default_rng(0)
    w, g = _tree(rng), _tree(rng, 1e-2)
    m, v = _tree(rng, 1e-3), _tree(rng, positive=True)
    alpha_t = np.float32(3e-4)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=wd)
    for ln, ws in SHAPES.items():
        for wn in ws:
            want = jax_fused_adam_update(
                *(jnp.asarray(t[ln][wn]) for t in (w, g, m, v)),
                jnp.asarray(alpha_t), interpret=True, **kw)
            got = fused_adam_update_plain(
                *(torch.from_numpy(t[ln][wn]) for t in (w, g, m, v)),
                torch.tensor(alpha_t), **kw)
            for x, y, name in zip(got, want, "wmv"):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           err_msg=f"{ln}/{wn} {name}",
                                           **TOL)


def test_fused_adam_plain_bf16_weight_matches_jax_kernel():
    rng = np.random.default_rng(1)
    shape = (7, 130)
    w = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    m = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    v = np.abs(rng.standard_normal(shape)).astype(np.float32) * 1e-5
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=0.01)
    want = jax_fused_adam_update(
        jnp.asarray(w, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16),
        jnp.asarray(m), jnp.asarray(v), jnp.float32(1e-3), interpret=True,
        **kw)
    got = fused_adam_update_plain(
        torch.from_numpy(w).bfloat16(), torch.from_numpy(g).bfloat16(),
        torch.from_numpy(m), torch.from_numpy(v), torch.tensor(1e-3), **kw)
    assert got[0].dtype == torch.bfloat16
    w_want = np.asarray(want[0]).astype(np.float32)
    np.testing.assert_allclose(got[0].float().numpy(), w_want, rtol=2 ** -8,
                               atol=0)
    for x, y in zip(got[1:], want[1:]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


def test_fused_wrapper_updates_in_place_and_counts_plain_calls():
    rng = np.random.default_rng(2)
    w, g, m, v = (_torch(t) for t in (_tree(rng), _tree(rng, 1e-2),
                                      _tree(rng, 1e-3),
                                      _tree(rng, positive=True)))
    leaves = [(w[ln][wn], g[ln][wn], m[ln][wn], v[ln][wn])
              for ln, ws in SHAPES.items() for wn in ws]
    alpha_t = torch.tensor(2e-4)
    kw = dict(beta1=0.8, beta2=0.99, eps=1e-6, wd=0.1)
    want = [fused_adam_update_plain(*x, alpha_t, **kw) for x in leaves]
    ptrs = [x[0].data_ptr() for x in leaves]
    before = fused_adam_update.plain_calls, fused_adam_update.launches
    fused_adam_update(*(list(c) for c in zip(*leaves)), alpha_t, **kw)
    assert fused_adam_update.plain_calls == before[0] + 1
    assert fused_adam_update.launches == before[1]
    assert [x[0].data_ptr() for x in leaves] == ptrs
    for (wt, _, mt, vt), (pw, pm, pv) in zip(leaves, want):
        for a, b in ((wt, pw), (mt, pm), (vt, pv)):
            torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)


def test_fused_wrapper_rejects_what_the_kernel_does_not_take():
    w = torch.zeros(4)
    a = torch.tensor(1e-3)
    with pytest.raises(TypeError, match="float32"):
        fused_adam_update([w], [w], [w.bfloat16()], [w], a)
    with pytest.raises(ValueError, match="shapes differ"):
        fused_adam_update([w], [torch.zeros(5)], [w], [w], a)
    with pytest.raises(TypeError, match="scalar"):
        fused_adam_update([w], [w], [w], [w], torch.zeros(2))
    with pytest.raises(ValueError, match="one entry per leaf"):
        fused_adam_update([w], [], [w], [w], a)


@pytest.mark.parametrize("step", [1, 2, 10, 1000, 100000])
def test_alpha_t_matches_jax(step):
    o = opt.AdamOptimizer(alpha=1e-3, beta1=0.9, beta2=0.999)
    j = jax_opt.AdamOptimizer(alpha=1e-3, beta1=0.9, beta2=0.999)
    t = jnp.asarray(step, jnp.int32).astype(jnp.float32)
    want = j.alpha * jnp.sqrt(1.0 - j.beta2 ** t) / (1.0 - j.beta1 ** t)
    got = o.alpha_t(step, "cpu")
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert o.alpha_t(torch.tensor(step), "cpu").item() == got.item()


def _run_both(port_opt, jax_optimizer, steps=3, seed=3):
    rng = np.random.default_rng(seed)
    p0 = _tree(rng)
    grads = [_tree(rng, 1e-2) for _ in range(steps)]
    tp, jp = _torch(p0), _jax(p0)
    ts, js = port_opt.init_state(tp), jax_optimizer.init_state(jp)
    for i, g in enumerate(grads):
        tp, ts = port_opt.update(tp, _torch(g), ts, i + 1)
        jp, js = jax_optimizer.update(jp, _jax(g), js,
                                      jnp.asarray(i + 1, jnp.int32))
    return tp, ts, jp, js


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_update_matches_jax(wd):
    kw = dict(alpha=1e-3, beta1=0.9, beta2=0.999, weight_decay=wd,
              epsilon=1e-8)
    tp, ts, jp, js = _run_both(opt.AdamOptimizer(**kw),
                               jax_opt.AdamOptimizer(**kw))
    _close(tp, jp)
    for slot in ("m", "v"):
        _close(ts[slot], js[slot])


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
def test_sgd_update_matches_jax(momentum, nesterov):
    kw = dict(lr=0.05, momentum=momentum, nesterov=nesterov,
              weight_decay=0.01)
    tp, ts, jp, js = _run_both(opt.SGDOptimizer(**kw),
                               jax_opt.SGDOptimizer(**kw))
    _close(tp, jp)
    assert set(ts) == set(js)
    if momentum:
        _close(ts["v"], js["v"])


def test_fused_tree_update_equals_unfused_update_in_place():
    """For f32 weights the fused tree update is the unfused one bit for
    bit, and both overwrite the leaves they were given."""
    o = opt.AdamOptimizer(alpha=1e-3, weight_decay=0.01)
    rng = np.random.default_rng(4)
    p0, g = _tree(rng), _tree(rng, 1e-2)
    pa, pb = _torch(p0), _torch(p0)
    sa, sb = o.init_state(pa), o.init_state(pb)
    ptr = pb["a"]["kernel"].data_ptr()
    for step in (1, 2):
        pa, sa = o.update(pa, _torch(g), sa, step)
        pb, sb = opt.fused_adam_tree_update(o, pb, _torch(g), sb, step)
    assert pb["a"]["kernel"].data_ptr() == ptr
    for x, y in ((pa, pb), (sa["m"], sb["m"]), (sa["v"], sb["v"])):
        for ln, ws in x.items():
            for wn, t in ws.items():
                torch.testing.assert_close(t, y[ln][wn], atol=0.0, rtol=0.0)
