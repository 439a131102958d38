"""The port's bucketed overlap of the gradient sync (``runtime/overlap.py``)
against the JAX package's.

The schedule: ``overlap_enabled`` resolves alike, and
``build_overlap_schedule(...).record()`` of BERT-tiny, the Transformer
and an MLP is the JAX package's (buckets, members, bytes, order: layers
paired by position, their generated names differing between the
packages) for coalescing, a giant layer's own bucket, the off and
pipeline cases, grouped members and an imported record. The runtime: one
world of two gloo ranks (``tests/_torch_world.py``, mesh (2,)) trains
BERT-tiny and the Transformer (f32, dropout 0, Adam through the fused
kernel's plain version) serially and under the overlap schedule, with and
without ZeRO at prefetch 0 and 1, and with gradient accumulation: the
overlap runs are bit-equal to the serial ones (weights after 4 steps,
loss histories), launch one fused Adam and one flat collective (two
under ZeRO) per bucket a step, and against the JAX package's overlap run
on a mesh of 2 CPU devices the forward is within 2e-3, the first-step
gradients within 1e-5 + 1e-4 relative, the loss history within 1e-4.
Under the quantized sync (int8) the overlap schedule's per-bucket update
is bit-equal to the quantized step's.
"""
import types

import pytest

import flexflow_tpu as ffj
from flexflow_tpu.executor import GraphProgram as JaxProgram
from flexflow_tpu.models import BertConfig as JaxBertConfig
from flexflow_tpu.models import TransformerConfig as JaxTransformerConfig
from flexflow_tpu.models import build_bert as jax_build_bert
from flexflow_tpu.models import build_mlp as jax_build_mlp
from flexflow_tpu.models import build_transformer as jax_build_transformer
from flexflow_tpu.runtime import overlap as jov
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.executor import GraphProgram
from flexflow_tpu_torch.models import (BertConfig, TransformerConfig,
                                       build_bert, build_mlp,
                                       build_transformer)
from flexflow_tpu_torch.runtime import overlap as tov

from _torch_sync import (DP, assert_matches_jax, jax_run, payload_of,
                         same_weights)
from _torch_world import run_world

OV = DP + ["--overlap-schedule", "on", "--overlap-bucket-mb", "0.05"]
TOV = DP + ["--overlap-schedule", "on", "--overlap-bucket-mb", "0.01"]
ACC = ["--gradient-accumulation-steps", "2"]
QALL = ["--quantized-collectives", "all"]
RUNS = [("dp", DP, "adam", "bert"), ("ov", OV, "adam", "bert"),
        ("ovz0", OV + ["--zero", "--zero-prefetch", "0"], "adam", "bert"),
        ("ovz1", OV + ["--zero", "--zero-prefetch", "1"], "adam", "bert"),
        ("acc", DP + ACC, "adam", "transformer"),
        ("acc_ov", TOV + ACC, "adam", "transformer"),
        ("acc_ovz", TOV + ACC + ["--zero"], "adam", "transformer"),
        ("qsync", DP + QALL, "adam", "bert"),
        ("qsync_ov", OV + QALL, "adam", "bert")]
_CACHE = {}


def _ref():
    if "ref" not in _CACHE:
        _CACHE["ref"] = jax_run("bert", OV[1:], "adam")
        _CACHE["t"] = jax_run("transformer", (), "adam", what="init")
    return _CACHE["ref"]


def _world():
    if "world" not in _CACHE:
        ref = _ref()
        _CACHE["world"] = run_world("sync", 2, {
            "bert": payload_of(ref), "transformer": payload_of(_CACHE["t"]),
            "batch": 8, "seq": 16, "runs": RUNS})
    return _CACHE["world"]


def _cfg(**kw):
    base = {"overlap": "on", "overlap_bucket_mb": 4.0, "zero_prefetch": 1}
    base.update(kw)
    return types.SimpleNamespace(**base)


def _strategy(pipeline=None, banks=None):
    return types.SimpleNamespace(pipeline=pipeline, banks=banks,
                                 place_groups=None, overlap=None)


def _programs(kind):
    """The same model in both packages: (jax program, port program)."""
    out = []
    for pkg, prog in ((ffj, JaxProgram), (fft, GraphProgram)):
        cfg = pkg.FFConfig()
        if pkg is fft:
            cfg.device = "cpu"
        ff = pkg.FFModel(cfg)
        if kind == "bert":
            b = (JaxBertConfig if pkg is ffj else BertConfig).tiny()
            b.max_position = 16
            o = (jax_build_bert if pkg is ffj else build_bert)(ff, 8, 16, b)
        elif kind == "transformer":
            t = (JaxTransformerConfig if pkg is ffj else TransformerConfig)(
                hidden_size=32, num_heads=4, num_layers=2,
                sequence_length=16)
            o = (jax_build_transformer if pkg is ffj
                 else build_transformer)(ff, 8, t)
        else:
            o = (jax_build_mlp if pkg is ffj else build_mlp)(
                ff, 16, in_dim=16, hidden=(16, 2048, 16), num_classes=4)
        out.append(prog(ff.layers, ff.input_tensors, [o]))
    return out


def _by_position(record, program):
    """A record with each member replaced by its layer's index."""
    if record is None:
        return None
    pos = {l.name: i for i, l in enumerate(program.layers)}
    return dict(record, buckets=[dict(b, members=[pos[m] for m in
                                                  b["members"]])
                                 for b in record["buckets"]])


def test_overlap_enabled_resolution_matches_jax(monkeypatch):
    cases = [None] + [types.SimpleNamespace(overlap=v)
                      for v in ("on", "off", "auto", "yes", "0")]
    for env in (None, "1", "0", "true"):
        if env is None:
            monkeypatch.delenv("FF_OVERLAP", raising=False)
        else:
            monkeypatch.setenv("FF_OVERLAP", env)
        for c in cases:
            assert tov.overlap_enabled(c) == jov.overlap_enabled(c), (env, c)


@pytest.mark.parametrize("kind,cap", [("bert", 4.0), ("bert", 0.05),
                                      ("bert", 0.01),
                                      ("transformer", 0.01),
                                      ("mlp", 0.05), ("mlp", 64.0)])
def test_schedule_record_matches_jax(kind, cap):
    """Coalescing below the cap, a giant layer's own bucket (the MLP's
    2048-wide layers and BERT's embeddings over the small caps), every
    weighted layer once, in reverse program order."""
    jp, tp = _programs(kind)
    cfg = _cfg(overlap_bucket_mb=cap)
    want = jov.build_overlap_schedule(jp, _strategy(), cfg)
    got = tov.build_overlap_schedule(tp, _strategy(), cfg)
    assert _by_position(got.record(), tp) == \
        _by_position(want.record(), jp)
    assert len(got.buckets) >= (2 if cap < 1 else 1)


def test_schedule_off_pipeline_grouped_and_imported_match_jax():
    jp, tp = _programs("mlp")
    for st, cfg in ((_strategy(), _cfg(overlap="off")),
                    (_strategy(pipeline=object()), _cfg())):
        assert tov.build_overlap_schedule(tp, st, cfg) is None
        assert jov.build_overlap_schedule(jp, st, cfg) is None
    # bank members are left to the unscheduled tail
    jw = [l.name for l in jp.layers if l.weights]
    tw = [l.name for l in tp.layers if l.weights]
    want = jov.build_overlap_schedule(
        jp, _strategy(banks=[types.SimpleNamespace(members=[jw[0]])]),
        _cfg(overlap_bucket_mb=0.05))
    got = tov.build_overlap_schedule(
        tp, _strategy(banks=[types.SimpleNamespace(members=[tw[0]])]),
        _cfg(overlap_bucket_mb=0.05))
    assert _by_position(got.record(), tp) == \
        _by_position(want.record(), jp)
    assert tw[0] not in {m for b in got.buckets for m in b.members}
    # an imported record is honored verbatim (its order, not the cap)
    rec = {"enabled": True, "bucket_bytes": 123, "zero_prefetch": 0,
           "buckets": [{"order": 1, "members": [tw[0]], "nbytes": 5},
                       {"order": 0, "members": tw[1:], "nbytes": 7}]}
    st = _strategy()
    st.overlap = rec
    got = tov.build_overlap_schedule(tp, st, _cfg())
    assert got.record() == dict(rec, buckets=rec["buckets"][::-1])


def test_overlapped_update_per_bucket_and_unsplittable_fallback():
    import torch
    sched = tov.OverlapSchedule([tov.GradBucket(0, ["b"], 16),
                                 tov.GradBucket(1, ["a"], 16)], 16, 1)
    calls = []

    def update(params, grads, state, step):
        calls.append(sorted(params))
        for ln, ws in params.items():
            for wn, w in ws.items():
                w.sub_(0.1 * grads[ln][wn])
        return params, state

    params = {k: {"w": torch.ones(4)} for k in ("a", "b", "c")}
    grads = {k: {"w": torch.ones(4)} for k in ("a", "b", "c")}
    tov.overlapped_update(update, params, grads, {"m": {}}, 1, sched)
    # each bucket in launch order, then the unscheduled tail
    assert calls == [["b"], ["a"], ["c"]]
    assert all(torch.allclose(p["w"], torch.full((4,), 0.9))
               for p in params.values())
    calls.clear()
    p2, s2 = tov.overlapped_update(update, params, grads, ("opaque",), 1,
                                   sched)
    assert calls == [["a", "b", "c"]] and s2 == ("opaque",)


@pytest.mark.parametrize("name,base", [
    ("ov", "dp"), ("ovz0", "dp"), ("ovz1", "dp"), ("acc_ov", "acc"),
    ("acc_ovz", "acc")])
def test_overlap_is_bit_equal_to_the_serial_step(name, base):
    for rank in _world():
        r = rank["runs"]
        assert r[name]["losses"] == r[base]["losses"]
        same_weights(r[name]["weights"], r[base]["weights"])
        buckets = len(r[name]["overlap"]["buckets"])
        assert buckets >= 2
        # one fused Adam and one flat sync a bucket (two under ZeRO: the
        # reduce-scatter and the weight all-gather)
        assert r[name]["adam_per_step"] == buckets
        zero = "z" in name[len("acc_"):] if name.startswith("acc") \
            else "z" in name
        assert r[name]["sync_calls"] == buckets * (2 if zero else 1)


def test_overlap_run_matches_jax():
    ref = _ref()
    ov = _world()[0]["runs"]["ov"]
    assert_matches_jax(ov, ref)
    # the executed schedule is the JAX executor's for the same program
    got = ov["overlap"]
    want = ref["ff"].strategy.overlap
    names = {n: i for i, n in enumerate(ov["names"])}
    jnames = {l.name: i for i, l in enumerate(ref["ff"].executor.program
                                              .layers)}

    def pos(rec, idx):
        return [(b["order"], [idx[m] for m in b["members"]], b["nbytes"])
                for b in rec["buckets"]]
    assert pos(got, names) == pos(want, jnames)
    assert (got["bucket_bytes"], got["zero_prefetch"]) == \
        (want["bucket_bytes"], want["zero_prefetch"])


def test_quantized_sync_composes_with_overlap_on_two_ranks():
    """dp 2 under int8 (``--quantized-collectives all``): the loss
    history tracks the full-precision dp-2 run within the JAX test's
    bound (5% or 2e-3; the first, pre-update loss to 1e-6), and the
    overlap schedule on the synced gradients is bit-equal to it, one
    fused Adam a bucket."""
    for rank in _world():
        r = rank["runs"]
        lq, lb = r["qsync"]["losses"], r["dp"]["losses"]
        assert r["qsync"]["qsync"] and lq != lb
        assert lq[0] == pytest.approx(lb[0], rel=1e-6)
        for a, b in zip(lq, lb):
            assert abs(a - b) <= max(abs(b) * 0.05, 2e-3), (lq, lb)
        assert r["qsync_ov"]["losses"] == lq
        same_weights(r["qsync_ov"]["weights"], r["qsync"]["weights"])
        assert r["qsync_ov"]["adam_per_step"] == \
            len(r["qsync_ov"]["overlap"]["buckets"])


def test_schedule_counters():
    """``overlap.schedules_built`` counts a schedule an executor adopts
    (and records on its strategy); a pipeline counts
    ``overlap.pipeline_fallbacks``."""
    from flexflow_tpu_torch.obs import events
    was = events.enabled()
    events.enable()
    try:
        c0 = events.counters()
        cfg = fft.FFConfig()
        cfg.device, cfg.overlap, cfg.overlap_bucket_mb = "cpu", "on", 0.05
        ff = fft.FFModel(cfg)
        o = build_mlp(ff, 16, in_dim=16, hidden=(16, 2048, 16),
                      num_classes=4)
        ff.compile(fft.SGDOptimizer(0.01), "sparse_categorical_crossentropy",
                   [], output_tensor=o)
        assert ff.strategy.overlap == ff.executor._overlap_schedule.record()
        _, tp = _programs("mlp")
        tov.build_overlap_schedule(tp, _strategy(pipeline=object()), _cfg())
        c1 = events.counters()
        for name in ("overlap.schedules_built", "overlap.pipeline_fallbacks"):
            assert c1.get(name, 0) == c0.get(name, 0) + 1, name
    finally:
        if not was:
            events.disable()
