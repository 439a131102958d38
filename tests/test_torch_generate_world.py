"""Generation and serving over a world of port ranks, held against the
JAX package on the CPU.

``tests/test_generate_sharded.py``'s cases (the bucket boundary, a
partial batch padded to the bucket, chunking n > cap with the wide-stride
seed fold, ragged prompts, eos across decode segments, segmented decode,
an overlong request refused) and, besides, sampling with a seed and beam
search, through ``InferenceSession`` on that file's tiny GPT-2 (vocab 64,
hidden 32, 2 layers, 4 heads, 16 positions, batch and bucket 4, f32) with
the JAX package's weights (``interop.load_reference_params``), over gloo
worlds of 2 and 4 CPU ranks (``_torch_world.py`` scenario ``generate``):
under the dp preset, the tp preset (tp 2; dp 2 x tp 2 on four ranks) and
a serving-plan bucket strategy that the port searched on a described
mesh of the world's size. The JAX package's data-parallel model is the
oracle:

- every greedy and beam token equal to the oracle's, under every
  strategy (bit-equal ids; the tp run's too);
- the tp run's decode-step scores within 1e-5 of the largest of the
  oracle's re-forward rows at the same positions (the KV decode's row at
  a position is the causal re-forward's row there);
- sampled tokens equal to the port's one-device run (the JAX package
  samples from threefry, the port from ``torch.Generator``);
- every rank holds the same ids, and no generate fell back to the
  re-forward (``ff_kv_fallback_total`` stays 0).

Then the rank-0 relay (``serving/world.py``) over the plan file's
``build_serving_plan_session`` with the floor guard on: requests from
several threads, and a scheduler's forwards, reach every rank in one
order; a request that fails its check reaches no rank; the stop message
ends the followers' loop.
"""
import json
import os
import sys

import numpy as np
import pytest

from flexflow_tpu import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu.models.nlp import GPTConfig, build_gpt2

sys.path.insert(0, os.path.dirname(__file__))
import _torch_world as tw  # noqa: E402

SCORE_TOL = 1e-5
# the oracle's top-2 margin at every compared step must clear this, or
# equal tokens would be luck (f32 sums differ between the packages)
MARGIN = 1e-4


def _jax_oracle():
    """The JAX package's data-parallel tiny GPT-2 (tests/
    test_generate_sharded.py's ``_compiled``), in f32."""
    cfg = FFConfig()
    cfg.batch_size = tw.GEN_BUCKET
    cfg.only_data_parallel = True
    cfg.use_bf16_compute = False
    g = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                  num_heads=4, max_position=tw.GEN_SEQ, dropout=0.0)
    ff = FFModel(cfg)
    out = build_gpt2(ff, tw.GEN_BUCKET, tw.GEN_SEQ, g)
    ff.compile(SGDOptimizer(0.0), "identity", [], output_tensor=out)
    return ff


def _port_plan(n: int, path: str) -> str:
    """The port's serving plan for bucket 4, searched on a described mesh
    of ``n`` devices, its bucket strategy written to ``path``."""
    import flexflow_tpu_torch as fft
    from flexflow_tpu_torch.models import GPTConfig as TGPT
    from flexflow_tpu_torch.models import build_gpt2 as tbuild
    from flexflow_tpu_torch.parallel.machine import DeviceMesh, MachineSpec
    from flexflow_tpu_torch.search import serving_plan as tsp
    cfg = fft.FFConfig()
    cfg.batch_size, cfg.use_bf16_compute = tw.GEN_BUCKET, False
    ff = fft.FFModel(cfg, device="cpu")
    tbuild(ff, tw.GEN_BUCKET, tw.GEN_SEQ, TGPT(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
        max_position=tw.GEN_SEQ, dropout=0.0))
    ff.dmesh = DeviceMesh(MachineSpec(num_devices=n))
    ff.graph_inputs = list(ff.input_tensors)
    ff.config.export_strategy_file = path + ".full.json"
    tsp.optimize_serving_strategy(ff, buckets=(tw.GEN_BUCKET,), budget=16)
    with open(path + ".full.json") as f:
        doc = json.load(f)
    with open(path, "w") as f:
        json.dump(tsp.bucket_strategy_doc(doc, tw.GEN_BUCKET), f)
    # the whole plan, for build_serving_plan_session
    return path + ".full.json"


@pytest.fixture(scope="module")
def oracle():
    ff = _jax_oracle()
    params = {ln: {wn: np.asarray(w) for wn, w in ws.items()}
              for ln, ws in ff.params.items()}
    layers = [(l.name, int(l.op_type)) for l in ff.layers]
    return ff, params, layers


def _jax_cases(ff):
    """The oracle's tokens of every greedy and beam case of
    ``tw.gen_cases``, and its re-forward score rows at the boundary
    case's decode positions."""
    gen = lambda *a, **k: np.asarray(ff.generate(*a, **k))  # noqa: E731
    out = {"boundary": gen(tw.gen_prompts(4, 5), 5, 6, temperature=0.0)}
    lens = np.array([6, 2, 5], np.int32)
    ids = tw.gen_prompts(3, 6, seed=3)
    ids[1, 2:] = 0
    ids[2, 5:] = 0
    out["ragged"] = gen(ids, lens, 5, temperature=0.0)
    out["beam"] = np.asarray(ff.generate_beam(
        tw.gen_prompts(4, 3, seed=9), 3, 5, num_beams=2))
    p = tw.gen_prompts(4, 4, seed=1)
    out["partial_full"] = gen(p, 4, 5, temperature=0.0)
    p10 = tw.gen_prompts(10, 3, seed=2)
    out["chunk"] = np.concatenate([gen(p10[i:i + 4], 3, 6, temperature=0.0)
                                   for i in range(0, 10, 4)])
    out["eos_free"] = gen(tw.gen_prompts(2, 3, seed=4), 3, 6,
                          temperature=0.0)
    p = tw.gen_prompts(4, 4, seed=5)
    out["seg_one"] = gen(p, 4, 8, temperature=0.0)
    out["seg_one_ragged"] = gen(p, np.array([4, 2, 3, 1], np.int32), 8,
                                temperature=0.0)
    ids = out["boundary"]
    batch = {"input_ids": ids, "position_ids": np.tile(
        np.arange(tw.GEN_SEQ, dtype=np.int32), (4, 1))}
    scores = np.asarray(ff.executor.scored_forward(ff.params, ff.state,
                                                   batch))
    out["boundary_scores"] = scores[:, 4:10]
    return out


def _port_one_device(params, layers):
    """The port's one-device run of the sampled cases (the reference for
    sampled tokens, which the packages draw from different streams)."""
    from flexflow_tpu_torch.interop import load_reference_params
    from flexflow_tpu_torch.serving import InferenceSession
    ff = tw._gen_model(["--only-data-parallel"])
    load_reference_params(ff, params, layers)
    sess = InferenceSession(ff, [tw.GEN_BUCKET], decode_segment=0)
    samp = dict(temperature=0.8, seed=11, top_k=20, top_p=0.9)
    fold = np.zeros((9, tw.GEN_SEQ), np.int32)
    fold[:, :2] = 5
    return {"sample": sess.generate(tw.gen_prompts(4, 3, seed=8), 3, 6,
                                    **samp),
            "fold": sess.generate(fold, 2, 6, temperature=0.9, seed=7)}


def _check_run(kind, r, want, one):
    assert r["fallback"] == 0, kind
    for case in ("boundary", "ragged", "beam", "partial_full", "chunk",
                 "eos_free", "seg_one", "seg_one_ragged"):
        np.testing.assert_array_equal(r[case], want[case],
                                      err_msg=f"{kind} {case}")
    got = r["boundary_scores"]
    ref = want["boundary_scores"]
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= SCORE_TOL, (kind, err)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MARGIN
    assert np.array_equal(r["sample"][0], r["sample"][1]), kind
    np.testing.assert_array_equal(r["sample"][0], one["sample"],
                                  err_msg=kind)
    # the JAX reference's own cases, now over the world: padding, the
    # seed fold, eos latching, segments
    np.testing.assert_array_equal(r["partial"], r["partial_full"][:2])
    for k, i in enumerate(range(0, 9, 4)):
        np.testing.assert_array_equal(r["fold"][i:i + 4],
                                      r["fold_chunks"][k])
    assert not np.array_equal(r["fold"][0], r["fold"][4])
    np.testing.assert_array_equal(r["fold"], one["fold"])
    for row in range(3):
        np.testing.assert_array_equal(r["ragged_solo"][row][0],
                                      r["ragged"][row])
    eos = int(r["eos_free"][0, 3])
    assert (r["eos"][0, 3:9] == eos).all(), kind
    for a, b in (("seg_one", "seg"), ("seg_one_eos", "seg_eos"),
                 ("seg_one_ragged", "seg_ragged")):
        np.testing.assert_array_equal(r[a], r[b], err_msg=f"{kind} {b}")
    assert (r["seg_eos"][0, 4:12] == int(r["seg_one"][0, 4])).all()
    assert r["overlong_refused"], kind


def _same_on_every_rank(ranks, kind):
    for r in ranks[1:]:
        for key, v in ranks[0][kind].items():
            if key in ("wq_local",):
                continue
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(r[kind][key], v,
                                              err_msg=f"{kind} {key}")
            elif isinstance(v, list) and v and isinstance(v[0],
                                                          np.ndarray):
                for x, y in zip(r[kind][key], v):
                    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("world", [2, 4])
def test_generation_over_a_world_matches_jax(world, oracle, tmp_path):
    jff, params, layers = oracle
    want = _jax_cases(jff)
    one = _port_one_device(params, layers)
    sub = str(tmp_path / "bucket4.json")
    plan = _port_plan(world, sub)
    ranks = tw.run_world("generate", world, {
        "params": params, "layers": layers,
        "runs": [("dp", None), ("tp", None), ("plan", sub)],
        "relay": world == 2, "plan": plan}, timeout=240)
    tp_mesh = {"x0": 2} if world == 2 else {"x0": 2, "x1": 2}
    assert ranks[0]["tp"]["mesh"] == tp_mesh
    # tp shards the heads: 2 of 4 a rank; dp keeps them whole
    assert ranks[0]["tp"]["wq_local"] == (32, 2, 8)
    assert ranks[0]["dp"]["wq_local"] == (32, 4, 8)
    for kind in ("dp", "tp", "plan"):
        _check_run(kind, ranks[0][kind], want, one)
        _same_on_every_rank(ranks, kind)
    if world != 2:
        return
    rel = [r["relay"] for r in ranks]
    # rank 0's floor guard decided for both ranks
    assert rel[0]["floor_guard"] == rel[1]["floor_guard"]
    # every relayed call reached every rank, in one order: 3 threads'
    # greedy requests, the sampled one and the scheduler's forwards (its
    # 3 requests in 1 to 3 batches); not the refused one
    batches = rel[0]["batches"]
    assert 1 <= batches <= 3
    assert rel[0]["calls"] == rel[1]["calls"] == rel[1]["followed"] \
        == 4 + batches
    assert rel[0]["log"] == rel[1]["log"]
    assert [op for op, _ in rel[0]["log"]].count("infer") == batches
    assert len(rel[0]["refused"]) == 1 and not rel[0]["errors"] \
        and not rel[1]["errors"]
    # 4 tokens a request: 3 greedy ones and the sampled one
    assert rel[0]["steps"] == rel[1]["steps"] == 4 * 4
    assert rel[0]["fallback"] == rel[1]["fallback"] == 0
    got = rel[0]["got"]
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(jff.generate(tw.gen_prompts(2, 3,
                                                           seed=20 + i),
                                            3, 4, temperature=0.0)))
        batch = {"input_ids": tw.gen_prompts(1, 4, seed=40 + i),
                 "position_ids": np.arange(tw.GEN_SEQ,
                                           dtype=np.int32)[None]}
        np.testing.assert_allclose(
            got[f"infer{i}"][0], np.asarray(jff.executor.make_forward()(
                jff.params, jff.state, {k: np.repeat(v, 4, 0)
                                        for k, v in batch.items()}))[0],
            rtol=0, atol=1e-5)


def test_relay_surfaces_a_dead_rank_as_rank_failure():
    codes, res, logs = tw.run_world_raw(
        "relay_death", 2, {}, timeout=120,
        env={"FF_HB_TIMEOUT_S": "2", "FF_HB_INTERVAL_S": "0.1"})
    assert codes[1] == 3, logs[1][-2000:]
    r = res[0]
    assert r is not None, logs[0][-3000:]
    assert r["first"].shape == (4, tw.GEN_SEQ)
    # not a hang: the coordinator names the dead rank within its bound
    assert r["second"] == ("RankFailure", 1), logs[0][-3000:]
    assert r["run"] == ("RankFailure", 1)
    assert r["detect_s"] < 2 + 2 * 0.1 + 10
    assert "stopped" in r["third"]


def test_plan_with_seq_sharded_kv_is_refused(tmp_path):
    from flexflow_tpu_torch.serving.session import (
        build_serving_plan_session)
    full = _port_plan(2, str(tmp_path / "bucket4.json"))
    with open(full) as f:
        doc = json.load(f)
    kv = doc["serving"]["buckets"][str(tw.GEN_BUCKET)]["kv"]
    next(iter(kv.values()))["seq_shard_degree"] = 2
    path = tmp_path / "seq.json"
    path.write_text(json.dumps(doc))

    def build(sf, buckets=None):
        raise AssertionError("a refused plan builds no model")
    with pytest.raises(NotImplementedError, match="4.6's leftover"):
        build_serving_plan_session(str(path), build)
