"""Sequence parallelism over a world of ranks: the port's ring attention,
Ulysses and the ``seq`` mesh axis, held against the JAX package.

- The ring's chunk math (``_chunk_attn``, ``_merge``, ``_chunk_grads``)
  in one process, in its three modes (full, causal diagonal, skipped),
  f32 and bf16, against the JAX package's on the same seeded inputs.
- ``ring_attention`` and ``ulysses_attention`` on gloo worlds of 2 and 4
  CPU ranks (``tests/_torch_world.py``, each rank its contiguous chunk
  ``(b, h, s/N, d)``) against the JAX package's under ``shard_map`` on 2
  and 4 of the conftest's CPU devices (Ulysses' flash kernel in interpret
  mode), causal and not: outputs and the q, k, v gradients of a seeded
  cotangent, with the ring's hops and bytes and Ulysses' flash calls.
- GPT-2 (vocab 64, hidden 32, 4 heads, 2 layers) and LLaMA-tiny with GQA
  (2 kv heads of 4) and RoPE, at batch 4 and seq 16, f32, SGD, forced
  ``attention:ring``, at seq 2 (2 ranks), seq 4 and dp 2 x seq 2 (4
  ranks), each against the JAX package compiled with the same
  ``MachineSpec(num_devices=n)`` and seq degree: the forward, the
  first-step gradients and a 3-step loss history.
- The refusals, which mirror the JAX package's: dropout above 0, the
  KV-cache paths, a length the seq degree does not divide,
  ``--seq-parallel`` with ``--pp`` / ``--tp``, a forced ring with no seq
  axis.

Tolerances: f32 within 1e-5 (outputs, losses; gradients 1e-5 + 1e-4
relative); bf16 within 2e-2 of the largest magnitude (the scores are
rounded to bf16 in both packages, then every step is f32). Each world
shape is launched once for the module.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import flexflow_tpu as ffj
from flexflow_tpu.kernels import registry as jreg
from flexflow_tpu.kernels.flash_attention import NEG_INF as JNEG_INF
from flexflow_tpu.models import GPTConfig, LlamaConfig, build_gpt2, \
    build_llama
from flexflow_tpu.parallel.machine import MachineSpec
from flexflow_tpu.utils.jax_compat import shard_map

import torch
from _torch_world import run_world
from flexflow_tpu_torch.kernels import ring_attention as tra
from flexflow_tpu_torch.kernels import registry as treg

# (the JAX package's kernels/__init__ binds the name to the function)
jra = importlib.import_module("flexflow_tpu.kernels.ring_attention")

F32_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
BF16_TOL = 2e-2
B, H, S, D = 2, 4, 32, 16          # the functions' whole (b, h, s, d)
BATCH, SEQ, STEPS = 4, 16, 3       # the models'


def _close(got, want, dtype, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0,
                                   err_msg=what)
    else:
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
        assert err <= BF16_TOL, (what, err)


# ----------------------------------------------------------------------
# the chunk math in one process
# ----------------------------------------------------------------------

def _qkv(seed, shape=(B, H, 8, D)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_chunk_math_matches_jax(mode, dtype):
    q, k, v, do = _qkv(mode)
    sc = 1.0 / np.sqrt(D)
    jq, jk, jv = (jnp.asarray(t, getattr(jnp, dtype)) for t in (q, k, v))
    tq, tk, tv = (torch.from_numpy(t).to(getattr(torch, dtype))
                  for t in (q, k, v))
    if mode == 2:
        # the JAX ring's skip branch: zeros and NEG_INF
        jo = jnp.zeros(q.shape, jnp.float32)
        jl = jnp.sum(jo, axis=-1) + JNEG_INF
    else:
        jo, jl = jra._chunk_attn(jq, jk, jv, sc, mode)
    to, tl = tra._chunk_attn(tq, tk, tv, sc, mode)
    _close(to, jo, dtype, "o")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=F32_TOL if dtype == "float32"
                               else BF16_TOL, rtol=0)
    # merged with another chunk's partial (the full one)
    jo2, jl2 = jra._chunk_attn(jq, jv, jk, sc, 0)
    to2, tl2 = tra._chunk_attn(tq, tv, tk, sc, 0)
    jm, jml = jra._merge(jo2, jl2, jo, jl)
    tm, tml = tra._merge(to2, tl2, to, tl)
    assert np.isfinite(tm.numpy()).all() and np.isfinite(tml.numpy()).all()
    _close(tm, jm, dtype, "merged o")
    _close(tml, jml, dtype, "merged lse")
    # the gradients of the merged whole's chunk, at its own lse
    delta = (do * np.asarray(jm)).sum(-1)
    if mode == 2:
        jg = [np.zeros_like(q)] * 3
    else:
        jg = jra._chunk_grads(jq, jk, jv, jnp.asarray(do), jml,
                              jnp.asarray(delta), sc, mode)
    tg = tra._chunk_grads(tq, tk, tv, torch.from_numpy(do),
                          torch.from_numpy(np.asarray(jml)),
                          torch.from_numpy(delta), sc, mode)
    for name, g, w in zip(("dq", "dk", "dv"), tg, jg):
        assert g.dtype == torch.float32
        _close(g, w, dtype, name)


# ----------------------------------------------------------------------
# the functions and the models over worlds of 2 and 4 ranks
# ----------------------------------------------------------------------

FN_CASES = [(fn, causal, dtype) for fn in ("ring", "ulysses")
            for causal in (False, True) for dtype in ("float32", "bfloat16")]


def _fn_name(fn, causal, dtype):
    return f"{fn}_{'causal' if causal else 'full'}_{dtype}"


def _fn_inputs():
    rng = np.random.default_rng(7)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(4)]


def _jax_fn(fn, causal, dtype, n):
    """The JAX package's function under shard_map on ``n`` of the CPU
    devices: (o, dq, dk, dv) whole."""
    q, k, v, do = _fn_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    spec = P(None, None, "sp", None)
    kw = {"interpret": True} if fn == "ulysses" else {}
    f = shard_map(functools.partial(
        getattr(jra, f"{fn}_attention"), axis_name="sp", causal=causal,
        **kw), mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
        check_vma=False)
    dt = getattr(jnp, dtype)

    @jax.jit
    def run(q_, k_, v_, do_):
        o, vjp = jax.vjp(f, q_, k_, v_)
        return (o, *vjp(do_))
    return [np.asarray(t, np.float32) for t in run(
        *(jnp.asarray(t, dt) for t in (q, k, v, do)))]


# (name, model, argv, world)
MODEL_RUNS = [
    ("gpt_sp2", "gpt", ("--seq-parallel", "2"), 2),
    ("llama_sp2", "llama", ("--seq-parallel", "2"), 2),
    ("gpt_sp4", "gpt", ("--seq-parallel", "4"), 4),
    ("llama_sp4", "llama", ("--seq-parallel", "4"), 4),
    ("gpt_dp2_sp2", "gpt", ("--seq-parallel", "2"), 4),
    ("llama_dp2_sp2", "llama", ("--seq-parallel", "2"), 4),
]


def _batches(vocab, n=2):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
        out.append({"input_ids": ids,
                    "position_ids": np.tile(np.arange(SEQ, dtype=np.int32),
                                            (BATCH, 1)),
                    "label": ids})
    return out


def _jax_model(kind, seq, n):
    """The JAX package's model at seq degree ``seq`` over ``n`` CPU
    devices, forced ring, f32, SGD: its weights, layers, batches, the
    forward on the first batch, the first-step gradients and a loss
    history."""
    cfg = ffj.FFConfig()
    cfg.batch_size, cfg.use_bf16_compute = BATCH, False
    cfg.only_data_parallel, cfg.seq_parallel_degree = True, seq
    cfg.kernel_impls = "attention:ring"
    ff = ffj.FFModel(cfg)
    if kind == "gpt":
        out = build_gpt2(ff, BATCH, SEQ, GPTConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_position=SEQ, dropout=0.0))
        batches = _batches(64)
    else:
        lc = LlamaConfig.tiny()
        lc.max_position, lc.num_kv_heads = SEQ, 2
        out = build_llama(ff, BATCH, SEQ, lc, fused_attention=True)
        batches = _batches(lc.vocab_size)
    ff.compile(ffj.SGDOptimizer(0.05), "sparse_categorical_crossentropy",
               [], output_tensor=out, machine_spec=MachineSpec(
                   num_devices=n))
    ex = ff.executor
    b0 = batches[0]

    def loss_fn(p):
        outs, _, aux, capture = ex._forward(p, ff.state, b0, True, 0)
        return ex._loss_and_metrics(outs, capture, b0["label"], aux)[0]

    ref = {"params": jax.device_get(ff.params),
           "layers": [(l.name, int(l.op_type)) for l in ff.layers],
           "batches": batches,
           "mesh": dict(ff.dmesh.axis_sizes),
           "plan": sorted(set(ff.strategy.kernel_impls.values())),
           "forward": np.asarray(ex.make_forward()(ff.params, ff.state, {
               k: v for k, v in b0.items() if k != "label"})),
           "grads": jax.device_get(jax.jit(jax.grad(loss_fn))(ff.params))}
    step = ex.make_train_step()
    ref["losses"] = [float(np.asarray(ff._run_train_step(
        step, batches[i % 2])["loss"])) for i in range(STEPS)]
    return ref


def _model_key(name):
    _, kind, argv, world = next(r for r in MODEL_RUNS if r[0] == name)
    return kind, int(argv[1]), world


@pytest.fixture(scope="module")
def jax_refs():
    fns = {(n, c): _jax_fn(*c, n) for n in (2, 4) for c in FN_CASES}
    models = {r[0]: _jax_model(*_model_key(r[0])) for r in MODEL_RUNS}
    return {"fns": fns, "models": models}


@pytest.fixture(scope="module")
def worlds(jax_refs, tmp_path_factory):
    """One launch of 2 ranks and one of 4: the functions on every case,
    the models of MODEL_RUNS from the JAX weights (and, on 2, the compile
    refusals and the calibration rows)."""
    q, k, v, do = _fn_inputs()
    out = {}
    for world in (2, 4):
        fns = [(_fn_name(*c), c[0], q, k, v, do, c[1], c[2])
               for c in FN_CASES]
        runs = [(n, kind, argv, n) for n, kind, argv, w in MODEL_RUNS
                if w == world]
        refs = {n: {key: jax_refs["models"][n][key]
                    for key in ("params", "layers", "batches")}
                for n, _, _, _ in runs}
        out[world] = run_world("seq", world, {
            "fns": fns, "runs": runs, "refs": refs, "steps": STEPS,
            "refusals": world == 2,
            "cache": str(tmp_path_factory.mktemp("calib"))
            if world == 2 else None}, timeout=150)
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fn,causal,dtype", FN_CASES)
def test_functions_match_jax(world, fn, causal, dtype, jax_refs, worlds):
    name = _fn_name(fn, causal, dtype)
    ranks = [r["fns"][name] for r in worlds[world]]
    want = jax_refs["fns"][(world, (fn, causal, dtype))]
    for j, key in enumerate(("o", "dq", "dk", "dv")):
        got = np.concatenate([r[key] for r in ranks], axis=2)
        _close(got, want[j], dtype, f"{name} {key}")
    assert ranks[0]["dtype"] == f"torch.{dtype}"
    chunk = B * H * (S // world) * D
    isz = 4 if dtype == "float32" else 2
    for r in ranks:
        if fn == "ring":
            # forward: N - 1 hops of (k, v); backward: N hops, (k, v, dk,
            # dv) and at the last dk, dv only (the accumulators in f32)
            assert r["fwd_hops"] == (world - 1, (world - 1) * 2 * chunk
                                     * isz)
            assert r["bwd_hops"] == (world, (world - 1) * 2 * chunk * isz
                                     + world * 2 * chunk * 4)
            assert r["flash_calls"] == [0, 0, 0]
        else:
            # one flash forward, dq and dk/dv a call a rank (their plain
            # versions on the CPU), no ring hop
            assert r["fwd_hops"] == (0, 0) and r["bwd_hops"] == (0, 0)
            assert r["flash_calls"] == [1, 1, 1]


def _assert_model(run, ref):
    np.testing.assert_allclose(run["forward"], ref["forward"],
                               atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(run["losses"], ref["losses"], atol=F32_TOL,
                               rtol=0)
    pos = {n: i for i, n in enumerate(run["names"])}
    jpos = {n: i for i, (n, _) in enumerate(ref["layers"])}
    got = {pos[ln]: ws for ln, ws in run["grads"].items()}
    want = {jpos[ln]: ws for ln, ws in ref["grads"].items()}
    assert set(got) == set(want)
    for p, ws in want.items():
        for wn, g in ws.items():
            np.testing.assert_allclose(got[p][wn], np.asarray(g),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"layer {p} {wn}")


@pytest.mark.parametrize("name", [r[0] for r in MODEL_RUNS])
def test_seq_parallel_models_match_jax(name, jax_refs, worlds):
    kind, seq, world = _model_key(name)
    run = next(r["models"][name] for r in worlds[world][:1])
    ref = jax_refs["models"][name]
    assert run["mesh"] == ref["mesh"] == (
        {"x0": 1, "seq": seq} if seq == world else {"x0": 2, "seq": 2})
    assert run["plan"] == ref["plan"] == ["ring"]
    _assert_model(run, ref)
    # every rank holds the same whole gradients and losses
    for other in worlds[world][1:]:
        np.testing.assert_array_equal(other["models"][name]["losses"],
                                      run["losses"])


@pytest.mark.parametrize("name", [r[0] for r in MODEL_RUNS])
def test_seq_parallel_step_syncs_over_dp_only(name, worlds):
    """The gradient sync runs over the batch dims only: nothing at pure
    seq, and over dp 2 x seq 2 the same collectives as dp 2 alone would
    (one a replicated leaf, none over ``seq``). The ring hops: 2 layers,
    each N - 1 a forward and 2N - 1 a forward and backward."""
    kind, seq, world = _model_key(name)
    run = worlds[world][0]["models"][name]
    n_leaves = sum(len(ws) for ws in run["grads"].values())
    assert run["sync_calls"] == (0 if seq == world else STEPS * n_leaves)
    layers = 2
    assert run["hops"] == layers * (seq - 1) + (STEPS + 1) * layers * (
        2 * seq - 1)


def test_ring_calibration_rows_over_the_seq_group(worlds):
    """Over the seq world: the hop rows (``coll_ppermute``) at both
    payloads and ring's ``op_attention@ring`` at s = 256 and 512 (128 and
    256 times the degree), keyed by the degree and the world's
    transport; a warm table measures nothing; the cost model reads both,
    and no ring row answers without the degree."""
    for r in worlds[2]:
        c = r["calib"]
        assert c["backend"] == "cpu+gloo"
        assert c["keys"] == sorted(
            [f"cpu+gloo|coll_ppermute|float32|{1 << e}|2" for e in (12, 14)]
            + [f"cpu+gloo|op_attention@ring|float32|{4 * 8 * 64 * s}|2"
               for s in (256, 512)])
        # the host's two rows, 4 collectives x 2 payloads at degrees 1
        # (the (1, 2) mesh's first axis) and 2, 2 hops, 2 ring rows
        assert c["measured"] == 2 + 4 * 2 * 2 + 2 + 2
        assert c["again"] == 0
        assert c["hop_4k"] > 0 and c["ring_s512"] > 0
        assert c["ring_deg0"] is None


# ----------------------------------------------------------------------
# the refusals
# ----------------------------------------------------------------------

def test_indivisible_length_refused_at_compile(worlds):
    msg = worlds[2][0]["refusals"]["indivisible"]
    assert msg is not None and "attention:ring is not available" in msg \
        and "not divisible by the seq-axis degree 2" in msg
    # the JAX package refuses the same compile with the same reason
    cfg = ffj.FFConfig()
    cfg.batch_size, cfg.only_data_parallel = 2, True
    cfg.seq_parallel_degree, cfg.kernel_impls = 2, "attention:ring"
    ff = ffj.FFModel(cfg)
    q = ff.create_tensor((2, 15, 16), name="q")
    ff.multihead_attention(q, q, q, embed_dim=16, num_heads=4)
    with pytest.raises(ValueError, match="not divisible by the seq-axis "
                       "degree 2"):
        ff.compile(ffj.SGDOptimizer(0.01), "identity", [],
                   machine_spec=MachineSpec(num_devices=2))


def _mha(pkg, dropout=0.0, **cfg_kw):
    cfg = pkg.FFConfig()
    cfg.batch_size, cfg.only_data_parallel = 2, True
    for key, val in cfg_kw.items():
        setattr(cfg, key, val)
    ff = pkg.FFModel(cfg, **({"device": "cpu"} if pkg is not ffj else {}))
    q = ff.create_tensor((2, 16, 16), name="q")
    ff.multihead_attention(q, q, q, embed_dim=16, num_heads=4,
                           dropout=dropout, causal=True)
    return ff


def test_forced_ring_without_seq_axis_refused_in_both():
    import flexflow_tpu_torch as fft
    for pkg in (ffj, fft):
        ff = _mha(pkg, kernel_impls="attention:ring")
        with pytest.raises(ValueError, match="sequence axis"):
            ff.compile(pkg.SGDOptimizer(0.01), "identity", [])


@pytest.mark.parametrize("flag", ["pipeline_stages", "tensor_parallel"])
def test_seq_parallel_with_pp_or_tp_refused_in_both(flag):
    import flexflow_tpu_torch as fft
    for pkg in (ffj, fft):
        ff = _mha(pkg, seq_parallel_degree=2, **{flag: 2})
        with pytest.raises(ValueError, match="does not compose with "
                           "--pp/--tp presets"):
            ff.compile(pkg.SGDOptimizer(0.01), "identity", [])


def test_ring_with_dropout_refused_in_both():
    """A plan that carries ``ring`` past the compile's predicate (set on
    the executor, as an imported strategy would) still refuses dropout
    in training, in both packages, with the same error."""
    import flexflow_tpu_torch as fft
    msgs = []
    for pkg in (ffj, fft):
        ff = _mha(pkg, dropout=0.1)
        ff.compile(pkg.SGDOptimizer(0.01), "identity", [])
        ff.executor._kernel_impls = {"attention": "ring"}
        x = np.zeros((2, 16, 16), np.float32)
        with pytest.raises(ValueError) as err:
            ff.executor._forward(ff.params, ff.state, {"q": x}, True, 0)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "has no in-kernel dropout" in msgs[0]
    # the predicate refuses it first, in both registries
    ctx = dict(seq_degree=2, dropout=0.1)
    for reg in (jreg, treg):
        assert "dropout" in reg.get_impl("attention", "ring").available(
            reg.attention_ctx({"num_heads": 4, "embed_dim": 16}, 16, 16,
                              **ctx))


def test_ring_plan_under_the_kv_cache_paths():
    """The ring's predicate refuses the KV-cache paths in both
    registries; a ring plan that reaches a prefill takes the default
    choice there, as in the JAX package (its cache equals the plain
    path's)."""
    import flexflow_tpu_torch as fft
    for reg in (jreg, treg):
        reason = reg.get_impl("attention", "ring").available(
            reg.attention_ctx({"num_heads": 4, "embed_dim": 16}, 16, 16,
                              seq_degree=2, kv_mode="prefill"))
        assert reason is not None and "KV-cache" in reason
    ff = _mha(fft, kernel_impls="attention:xla")
    ff.compile(fft.SGDOptimizer(0.01), "identity", [])
    x = np.random.default_rng(0).standard_normal((2, 16, 16)).astype(
        np.float32)
    plain = ff.executor.kv_prefill(ff.params, ff.state, {"q": x})
    ff.executor._kernel_impls = {"attention": "ring"}
    ring = ff.executor.kv_prefill(ff.params, ff.state, {"q": x})
    for name, c in plain.items():
        for key in c:
            torch.testing.assert_close(ring[name][key], c[key], rtol=0,
                                       atol=0)
