"""Pipelines over a world of ranks: the port's region detection, GPipe,
interleaved, ragged and in-stage tp schedules through ``FFModel.compile``,
held against the JAX package.

Region detection (``parallel/pipeline_lowering.py``) runs on graphs built
the same way in both packages and must pick the same layers, chunks,
counts, edges and Megatron roles. The schedules run through the port's
``FFModel.compile`` on gloo worlds of CPU ranks (``tests/_torch_world.py``;
one launch of 2 ranks and one of 4), GPT-2 (vocab 64, hidden 32, 4 heads,
4 layers, seq 16, batch 16) in f32 with SGD, and are held against the JAX
package's pipelined models of the same configuration on the conftest's 8
CPU devices, whose weights (the ``pp::`` leaves: ``(S, ...)``,
``(v, S, ...)``, the ragged ``(S, cmax, ...)``, tp-split or not) the
ranks load through ``interop``; or against the JAX package's plain model,
whose weights are grafted into the pipelined port model (the JAX
pipelined step equals its plain step at dropout 0, gradients counted
once). Meshes: the JAX pp 2 runs are dp 4 x pp 2 (dp 2 x pp 2 x tp 2
with in-stage tp); the port's ranks are pp 2 on two ranks, pp 4 and
dp 2 x pp 2 and pp 2 x tp 2 on four. Tolerances (f32): the forward
within 1e-5, first-step gradients within 1e-5 + 1e-4 relative, a 3-step
SGD loss history within 1e-5.

At dropout 0.1 the port's masks on a microbatch are its serial step's on
those rows (``EmitCtx.local_rows``); the JAX package draws its stages'
masks per schedule step, so that run is held against the port's own
one-rank serial step, with a control draw of other masks reading far off.
"""
import jax
import numpy as np
import pytest

import flexflow_tpu as ffj
from flexflow_tpu.models import BertConfig, GPTConfig, build_bert, build_gpt2
from flexflow_tpu.parallel import pipeline_lowering as jpl

import _torch_graphs as graphs
from _torch_world import run_world
from flexflow_tpu_torch.parallel import pipeline_lowering as tpl

BATCH, SEQ, STEPS = 16, 16, 3
FWD_TOL, LOSS_TOL = 1e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


# ----------------------------------------------------------------------
# region detection
# ----------------------------------------------------------------------

def _region_doc(region, layers):
    """A region by layer positions (names differ between the packages'
    builds only where layers are numbered per process)."""
    if region is None:
        return None
    pos = {l.name: i for i, l in enumerate(layers)}
    return {"start": region.start, "end": region.end,
            "stages": region.n_stages, "micro": region.n_microbatches,
            "chunks": region.n_chunks, "unit": region.layers_per_stage,
            "entry": region.entry_guid - layers[0].outputs[0].guid,
            "blocks": [[pos[n] for n in names]
                       for names in region.stage_layer_names],
            "counts": region.counts,
            "prologue": [pos[l.name] for l in region.prologue],
            "epilogue": [pos[l.name] for l in region.epilogue],
            "prologue_inputs": sorted(t.name
                                      for t in region.prologue_inputs)}


@pytest.mark.parametrize("model,layers,stages,chunks,micro", [
    ("gpt2", 4, 2, 1, 0), ("gpt2", 4, 4, 1, 4), ("gpt2", 4, 2, 2, 4),
    ("bert", 4, 2, 1, 0), ("bert", 4, 4, 1, 0), ("bert", 4, 2, 2, 4)])
def test_region_detection_matches_jax(model, layers, stages, chunks,
                                      micro):
    jff, tff = getattr(graphs, model)(batch=BATCH, layers=layers)
    got = [_region_doc(pl.find_pipeline_region(ff.layers, stages, micro,
                                               chunks), ff.layers)
           for pl, ff in ((jpl, jff), (tpl, tff))]
    assert got[0] is not None and got[0] == got[1]


@pytest.mark.parametrize("model,layers,stages", [
    ("gpt2", 6, 4), ("gpt2", 4, 2), ("bert", 4, 2), ("bert", 3, 2)])
def test_ragged_region_detection_matches_jax(model, layers, stages):
    jff, tff = getattr(graphs, model)(batch=BATCH, layers=layers)
    got = [_region_doc(pl.find_ragged_pipeline_region(ff.layers, stages),
                       ff.layers) for pl, ff in ((jpl, jff), (tpl, tff))]
    assert got[0] is not None and got[0] == got[1]
    assert sum(got[1]["counts"]) == len(got[1]["blocks"])


@pytest.mark.parametrize("model", ["gpt2", "bert"])
def test_tp_roles_match_jax(model):
    jff, tff = getattr(graphs, model)(batch=BATCH, layers=4)
    roles = []
    for pl, ff in ((jpl, jff), (tpl, tff)):
        region = pl.find_pipeline_region(ff.layers, 2)
        pos = {l.name: i for i, l in enumerate(ff.layers)}
        roles.append({pos[n]: r for n, r in
                      pl.assign_tp_roles(region.template, 2).items()})
    assert roles[0] == roles[1]
    assert sorted(set(roles[1].values())) == ["attn", "col", "row"]
    # heads that do not divide get no role
    assert tpl.assign_tp_roles(tpl.find_pipeline_region(
        tff.layers, 2).template, 3) == {}


# ----------------------------------------------------------------------
# the schedules over a world, against the JAX package
# ----------------------------------------------------------------------

def _batches(vocab, n=2, labels=None):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
        out.append({"input_ids": ids,
                    "position_ids": np.tile(np.arange(SEQ, dtype=np.int32),
                                            (BATCH, 1)),
                    "label": ids if labels is None else rng.integers(
                        0, labels, (BATCH, 1)).astype(np.int32)})
    return out


def _jax_run(model="gpt", pp=1, chunks=1, tp=1, ragged="auto",
             dropout=0.0):
    """The JAX package's model on the conftest's devices (pipelined under
    ``pp``): its weights and layers, the forward on the first batch, the
    first-step gradients and an SGD loss history."""
    cfg = ffj.FFConfig()
    cfg.batch_size, cfg.use_bf16_compute = BATCH, False
    cfg.pipeline_stages, cfg.pipeline_microbatches = pp, 4
    cfg.pipeline_chunks, cfg.pipeline_tp = chunks, tp
    cfg.pipeline_ragged = ragged
    ff = ffj.FFModel(cfg)
    if model == "gpt":
        out = build_gpt2(ff, BATCH, SEQ, GPTConfig(
            vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
            max_position=SEQ, dropout=dropout))
        batches = _batches(64)
    else:
        b = BertConfig.tiny()
        b.max_position, b.dropout, b.num_layers = SEQ, 0.0, 4
        out = build_bert(ff, BATCH, SEQ, b)
        batches = _batches(b.vocab_size, labels=b.num_labels)
    ff.compile(ffj.SGDOptimizer(0.05), "sparse_categorical_crossentropy",
               [], output_tensor=out)
    ex = ff.executor
    b0 = batches[0]

    def loss_fn(p):
        outs, _, aux, capture = ex._forward(p, ff.state, b0, True, 0)
        return ex._loss_and_metrics(outs, capture, b0["label"], aux)[0]

    ref = {"params": jax.device_get(ff.params),
           "layers": [(l.name, int(l.op_type)) for l in ff.layers],
           "batches": batches,
           "forward": np.asarray(ex.make_forward()(ff.params, ff.state, {
               k: v for k, v in b0.items() if k != "label"})),
           "grads": jax.device_get(jax.jit(jax.grad(loss_fn))(ff.params)),
           "mesh": dict(ff.dmesh.axis_sizes)}
    step = ex.make_train_step()
    ref["losses"] = [float(np.asarray(ff._run_train_step(
        step, batches[i % 2])["loss"])) for i in range(STEPS)]
    pipe = ex.pipe
    ref["region"] = None if pipe is None else (pipe.start, pipe.end,
                                               pipe.counts)
    return ref


def _payload(ref):
    return {k: ref[k] for k in ("params", "layers", "batches")}


def _by_position(grads, names, region):
    """Gradients keyed by layer position, a pipeline's stacked leaves cut
    into their blocks (``region``: the run's start, end, stages, chunks
    and ragged counts)."""
    pos = {n: i for i, n in enumerate(names)}
    out = {}
    for key, ws in grads.items():
        if not key.startswith("pp::"):
            out[pos[key]] = ws
            continue
        j = pos[key[4:]] - region["start"]
        for wn, g in ws.items():
            g = np.asarray(g)
            if region["counts"] is not None:
                blocks = [g[s, k] for s, c in enumerate(region["counts"])
                          for k in range(c)]
            elif region["chunks"] > 1:
                blocks = list(g.reshape((-1,) + g.shape[2:]))
            else:
                blocks = list(g)
            per = (region["end"] - region["start"]) // len(blocks)
            for b, blk in enumerate(blocks):
                out.setdefault(region["start"] + b * per + j, {})[wn] = blk
    return out


def _assert_matches(run, ref, jax_pipelined):
    np.testing.assert_allclose(run["forward"], ref["forward"],
                               atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(run["losses"], ref["losses"],
                               atol=LOSS_TOL, rtol=0)
    got = _by_position(run["grads"], run["names"], run["region"])
    want = _by_position(ref["grads"], [n for n, _ in ref["layers"]],
                        run["region"]) if jax_pipelined else \
        _by_position(ref["grads"], [n for n, _ in ref["layers"]], None)
    assert set(got) == set(want)
    for p, ws in want.items():
        for wn, g in ws.items():
            np.testing.assert_allclose(got[p][wn], np.asarray(g),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"layer {p} {wn}")


GPIPE = ("--pp", "2", "--pipeline-microbatches", "4")
# (name, world, model, argv, dropout, JAX reference, JAX reference is
# pipelined)
RUNS = [
    ("gpipe", 2, "gpt", GPIPE, 0.0, "gpipe", True),
    ("interleaved", 2, "gpt", GPIPE + ("--pipeline-chunks", "2"), 0.0,
     "interleaved", True),
    ("ragged", 2, "gpt", GPIPE + ("--pipeline-ragged", "force"), 0.0,
     "ragged", True),
    ("bert_gpipe", 2, "bert", GPIPE, 0.0, "bert_gpipe", True),
    ("gpipe_grafted", 2, "gpt", GPIPE, 0.0, "plain", False),
    ("pp2_tp2", 4, "gpt", GPIPE + ("--pp-tp", "2"), 0.0, "tp", True),
    ("pp4", 4, "gpt", ("--pp", "4", "--pipeline-microbatches", "4"), 0.0,
     "plain", False),
    ("dp2_pp2", 4, "gpt", GPIPE, 0.0, "plain", False),
]


@pytest.fixture(scope="module")
def jax_refs():
    return {"plain": _jax_run(), "gpipe": _jax_run(pp=2),
            "interleaved": _jax_run(pp=2, chunks=2),
            "ragged": _jax_run(pp=2, ragged="force"),
            "tp": _jax_run(pp=2, tp=2),
            "bert_gpipe": _jax_run("bert", pp=2)}


@pytest.fixture(scope="module")
def worlds(jax_refs):
    """One launch of 2 ranks and one of 4 running every case of RUNS (and
    the dropout-0.1 pipelined step on 2)."""
    out = {}
    for world in (2, 4):
        runs = [(n, m, a, d, r) for n, w, m, a, d, r, _ in RUNS
                if w == world]
        if world == 2:
            runs.append(("dropout", "gpt", GPIPE, 0.1, "plain"))
        refs = {r: _payload(jax_refs[r]) for _, _, _, _, r in runs}
        out.update(run_world("pipeline", world, {
            "runs": runs, "refs": refs, "batch": BATCH, "steps": STEPS},
            timeout=150)[0])
    return out


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_pipelined_step_matches_jax(name, jax_refs, worlds):
    _, world, _, argv, _, ref_key, pipelined = next(r for r in RUNS
                                                    if r[0] == name)
    run, ref = worlds[name], jax_refs[ref_key]
    assert run["region"]["stages"] == int(argv[1])
    if pipelined:
        assert (run["region"]["start"], run["region"]["end"],
                run["region"]["counts"]) == ref["region"]
    _assert_matches(run, ref, pipelined)


def test_pipeline_meshes_layouts_and_sends(worlds):
    """Each case's mesh, its stacked leaves' local blocks (a stage's
    slice, its tp share) and its hand-offs a step: GPipe on pp 2 sends 4
    activations forward and 4 cotangents back over the pair of ranks, one
    direction a rank; the interleaved ring 12 a rank."""
    assert worlds["gpipe"]["mesh"] == {"x0": 2}
    assert worlds["pp2_tp2"]["mesh"] == {"x0": 2, "x1": 2}
    assert worlds["dp2_pp2"]["mesh"] == {"x0": 2, "x1": 2}
    assert worlds["pp4"]["mesh"] == {"x0": 4}
    assert worlds["gpipe"]["sends_per_step"] == 4
    assert worlds["interleaved"]["sends_per_step"] == 12
    assert worlds["gpipe"]["route"] == "direct"
    g = worlds["gpipe"]["local"]
    assert all(shape[0] == 1 for shape in g.values())
    inter = worlds["interleaved"]["local"]
    assert all(shape[:2] == (2, 1) for shape in inter.values())
    rag = worlds["ragged"]
    assert rag["region"]["counts"] == (2, 2) and rag["region"]["prologue"] \
        and rag["region"]["epilogue"]
    assert all(shape[:2] == (1, 2) for shape in rag["local"].values())
    # wq (1, e, heads, d): each tp rank holds half of the stage's heads
    tp = [v for k, v in worlds["pp2_tp2"]["local"].items()
          if k.endswith("/wq")]
    full = [v for k, v in worlds["gpipe"]["local"].items()
            if k.endswith("/wq")]
    assert tp[0][2] * 2 == full[0][2]


def test_dropout_pipelined_step_is_the_serial_step(jax_refs, worlds):
    """At dropout 0.1 the pipelined step's gradients are the port's
    one-rank serial step's (same masks on every row); the serial step
    under another draw of every mask reads far off."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.interop import load_reference_params
    from flexflow_tpu_torch.models import GPTConfig as TGPT, \
        build_gpt2 as tbuild
    ref = jax_refs["plain"]
    cfg = FFConfig()
    cfg.batch_size, cfg.device, cfg.seed = BATCH, "cpu", 0
    cfg.use_bf16_compute, cfg.kernel_impls = False, "attention:xla"
    ff = FFModel(cfg)
    out = tbuild(ff, BATCH, SEQ, TGPT(vocab_size=64, hidden_size=32,
                                      num_layers=4, num_heads=4,
                                      max_position=SEQ, dropout=0.1))
    ff.compile(SGDOptimizer(0.05), "sparse_categorical_crossentropy", [],
               output_tensor=out)
    load_reference_params(ff, ref["params"], ref["layers"])
    serial = [{ln: {wn: t.detach().numpy() for wn, t in ws.items()}
               for ln, ws in ff.executor._grads(
                   ff.params, ff.state, ref["batches"][0], draw)[0].items()}
              for draw in (0, 1)]
    run = worlds["dropout"]
    got = _by_position(run["grads"], run["names"], run["region"])
    names = [l.name for l in ff.executor.program.layers]
    worst = [0.0, 0.0]
    for i, want in enumerate(serial):
        w = _by_position(want, names, None)
        for p, ws in w.items():
            for wn, g in ws.items():
                err = float(np.abs(got[p][wn] - g).max()
                            / max(np.abs(g).max(), 1e-6))
                worst[i] = max(worst[i], err)
    assert worst[0] < 1e-4, worst
    assert worst[1] > 1e-2, worst
