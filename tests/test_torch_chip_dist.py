"""chip_smoke.py's dist phase rehearsed on the CPU at a tiny size.

The phase as the card runs it (a one-rank reference, then two rank
processes of the script joined by the port's rendezvous, each training
BERT under data and tensor parallelism against the reference's forward,
first-step gradients at dropout 0.1 and loss history, with every kernel
launch counted), with BERT cut to ``BertConfig.tiny()`` at 8 x 16 in
f32 on the CPU: the flash and Adam wrappers' plain-version calls stand
in for their launches, so the phase's own gates (one flash forward, dq
and dk/dv per attention layer per step, one Adam a step) are checked
here as on the card. The one-rank NCCL world needs a card and is left
out.
"""
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_dist_phase_on_the_cpu(monkeypatch, tmp_path):
    smoke = _load_smoke()
    assert "dist" in smoke.PHASES
    monkeypatch.setattr(smoke, "free_cuda", lambda: None)
    monkeypatch.setattr(smoke, "DIST_TIMEOUT_S", 90)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = smoke.phase_dist("cpu", {"device": "cpu", "bert": "tiny",
                                   "batch": 8, "seq": 16, "steps": 2,
                                   "timed": 1, "f32": True,
                                   "profile": str(tmp_path)})
    assert res["backend"] == "gloo"
    assert set(res["routes"]) == {"all_reduce", "broadcast", "all_gather",
                                  "reduce_scatter", "all_to_all"}
    for cfg in ("dp2", "tp2"):
        r = res[cfg]
        assert r["launches_per_rank"] == {
            "flash_attention_fwd": 4, "flash_attention_bwd_dq": 4,
            "flash_attention_bwd_dkv": 4, "adam_update": 2}
        # f32 on the CPU: the ranks reproduce the one-rank run closely
        # (the key bias's true gradient is 0, so its relative error is
        # f32 noise over GRAD_FLOOR of the whole gradient)
        assert r["grad_worst"]["f32"] <= smoke.ZOO_GRAD_TOL
        assert r["grad_checked"]["f32"] == r["grad_worst"]["f32"]
        assert r["forward_err"] <= 1e-5 and r["loss_err"] <= 1e-5
        # every rank profiled one more step; its host time is split by
        # layer, the collectives and DTensor among them
        for p in r["profile"]:
            assert {"collectives", "DTensor (sharding rules, redistribute, "
                    "dispatch)"} <= set(p["host_layers_ms"])
            assert p["host_wall_ms"] > 0 and p["device"]["launches"] == 0
            assert p["host_stages_ms"]["step (synchronized)"] > 0
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{run}.{ext}" for run in ("one_rank", "dp2_rank0", "dp2_rank1",
                                   "tp2_rank0", "tp2_rank1")
        for ext in ("txt", "prof"))
    # another draw of every mask fails the first-step check by far
    worst, median = res["control"]["f32"]
    assert worst > 10 * smoke.ZOO_GRAD_TOL
    # data parallelism moves no activation between layouts; tensor
    # parallelism gathers and sums some in every block
    assert res["dp2"]["reshard_bytes"] == [0.0, 0.0]
    assert min(res["tp2"]["reshard_bytes"]) > 0
    # the train step's multi-device branches at dropout 0.1: ZeRO and the
    # overlap schedule under ZeRO are the serial dp-2 run bit for bit, the
    # int8 quantized sync (the serial run's masks) tracks it; each branch
    # launches one flash forward, dq and dk/dv per attention layer per
    # step and one fused Adam a step (the overlap schedule: one a bucket,
    # and BERT-tiny's 0.5 MiB fits one 4 MiB bucket)
    sync = res["sync"]
    base = sync["dp2_serial"]["losses"]
    for name in ("dp2_serial", "zero", "overlap_zero", "qsync_int8"):
        assert sync[name]["launches_per_rank"] == {
            "flash_attention_fwd": 4, "flash_attention_bwd_dq": 4,
            "flash_attention_bwd_dkv": 4, "adam_update": 2}, name
    assert sync["zero"]["losses"] == sync["overlap_zero"]["losses"] == base
    assert sync["overlap_zero"]["buckets"] == 1
    for got, want in zip(sync["qsync_int8"]["losses"], base):
        assert all(smoke.qsync_loss_ok(a, b) for a, b in zip(got, want))
    # ZeRO: one reduce-scatter and one all-gather a step; the quantized
    # sync: four collectives a tensor at about a quarter of the bytes
    assert sync["zero"]["sync_calls"] == [2.0, 2.0]
    assert max(sync["qsync_int8"]["wire_bytes"]) < \
        0.6 * min(sync["dp2_serial"]["wire_bytes"])
    assert all(m["within"] for m in sync["qsync_mass"])
