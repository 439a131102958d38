"""chip_smoke.py's serve phase rehearsed on the CPU at a tiny size.

The phase as the card runs it (both HTTP fronts over a repository of
per-bucket BERT sessions, shedding against a held queue, POST
``/generate`` and the continuous batcher under both admissions, the
serving-plan search and plan session, the replica fleet with a crash and
a repair), with the models cut to ``BertConfig.tiny()`` / a 2-layer
GPT-2 of 64 positions on the CPU and the replicas started with
``--device cpu``. The flash wrapper's plain-version calls stand in for
its launches, so the phase's own gates (one forward per attention layer
per scheduled batch, per generate call, per batcher iteration; none for
a shed request) are checked here as on the card.
"""
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_serve_phase_on_the_cpu(monkeypatch):
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import (BertConfig, GPTConfig,
                                           build_bert, build_gpt2)
    smoke = _load_smoke()
    assert smoke.PHASES[-1] == "serve"

    def bert(seq, impl, batch=8, **_):
        cfg = FFConfig()
        cfg.batch_size, cfg.device, cfg.seed = batch, "cpu", 0
        cfg.only_data_parallel, cfg.kernel_impls = True, impl
        cfg.use_bf16_compute = False
        ff = FFModel(cfg)
        b = BertConfig.tiny()
        b.max_position, b.dropout = seq, 0.0
        out = build_bert(ff, batch, seq, b)
        ff.compile(SGDOptimizer(0.01), "sparse_categorical_crossentropy",
                   [], output_tensor=out)
        return ff, b

    def gpt2(impl):
        cfg = FFConfig()
        cfg.batch_size, cfg.device, cfg.seed = 8, "cpu", 0
        cfg.only_data_parallel, cfg.kernel_impls = True, impl
        cfg.use_bf16_compute = False
        cfg.serving_floor_guard = "true"    # "auto" skips it on the CPU
        ff = FFModel(cfg)
        g = GPTConfig(vocab_size=512, hidden_size=64, num_layers=2,
                      num_heads=4, max_position=64, dropout=0.0)
        out = build_gpt2(ff, 8, 64, g)
        ff.compile(SGDOptimizer(0.01), "sparse_categorical_crossentropy",
                   [], output_tensor=out)
        return ff, g

    def cpu_batch(ids_np):
        ids = torch.from_numpy(ids_np)
        return {"input_ids": ids,
                "position_ids": torch.arange(ids.shape[1],
                                             dtype=torch.int32)[None]
                .expand(ids.shape[0], -1)}

    fns = smoke.counters()

    class Plain:
        """A wrapper's plain-call count, read as its launches."""

        def __init__(self, fn):
            self.fn, self.base = fn, fn.plain_calls

        @property
        def launches(self):
            return self.fn.plain_calls - self.base

    for name, value in (("build_model", bert), ("gpt2_model", gpt2),
                        ("gpt_batch", cpu_batch), ("LAYERS", 2),
                        ("GPT_SEQ", 64), ("SERVE_PLENS", (5, 30)),
                        ("CB_MAX_SEGMENTS", 3), ("PLAN_PLEN", 20),
                        ("SERVE_REQUESTS", 16), ("SERVE_CLIENTS", 4),
                        ("SERVE_IDLE", 3), ("CB_SEQS", 16),
                        ("FLEET_REQUESTS", 16),
                        ("FLEET_ARGS", ("--model", "gpt2-tiny",
                                        "--device", "cpu")),
                        ("free_cuda", lambda: None),
                        ("zero_counts", lambda: {
                            n: Plain(f) for n, f in fns.items()})):
        monkeypatch.setattr(smoke, name, value)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    res = smoke.phase_serve("cpu")
    for front in ("serve_http", "serve_async"):
        r = res["fronts"][front]
        assert r["launches"] == 2 * r["calls"] > 0
        for m in r["models"].values():
            assert m["server_p50_ms"] > 0 and m["mean_batch_rows"] >= 1
            for q in (m["load"], m["idle"]):
                assert q["batch_ms"] > 0 and q["wait_ms"] >= 0
    assert res["bert128_max_abs_err"] <= smoke.SLICE_TOL
    assert res["shedding"] == {"deadline_1ms": (503, "1"),
                               "malformed": (400, None),
                               "draining": (503, "5")}
    g = res["generate"]
    assert g["post_generate_launches"] == 2
    for adm in ("continuous", "static"):
        assert g[adm]["launches"] == 2 * g[adm]["iterations"]
        assert g[adm]["equal_rows"] == 16       # f32 on the CPU: exact
    assert g["continuous"]["iterations"] <= g["static"]["iterations"]
    assert {"kv", "forward", "gemm_lm_head", "gemm_mlp"} <= set(
        g["row_probe"])
    assert res["plan"]["findings"] == 0
    assert set(res["plan"]["buckets"]) == {1, 4, 8}
    f = res["fleet"]
    assert f["failovers"] >= 1 and len(f["time_to_ready_s"]) == 3
    assert res["launches"]["batcher"] == sum(
        g[a]["launches"] for a in ("continuous", "static"))
