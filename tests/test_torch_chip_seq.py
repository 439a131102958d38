"""chip_smoke.py's seq phase rehearsed on the CPU at a tiny size.

The phase as the card runs it (the one-rank GPT-2 runs under xla and
flash, then two rank processes of the script joined by the port's
rendezvous, each running (a) ring and Ulysses attention on its half of a
whole sequence against the plain attention of the whole, (b) GPT-2
trained sp 2 under attention:ring against the one-rank xla run's
first-step gradients and loss history, with every kernel launch and the
ring's hops counted, and (c) the long-context MHA at seq 2 under the
measured kernel tier, its ring and hop calibration rows measured over
the two ranks), cut to b2 h4 s32 d16 functions, a GPT-2 of vocab 64,
hidden 32, 4 heads and 2 layers at 2 x 16 and an MHA of B2 S64 E32 H4,
on the CPU: the flash and Adam wrappers' plain-version calls stand in
for their launches, so the phase's own gates (no flash launch and one
Adam a step a rank on the ring path, one flash forward, dq and dk/dv a
Ulysses call, 3 hops a layer a step) are checked here as on the card.
The kernels' timings need a card and are left out.
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


def test_chip_smoke_seq_phase_on_the_cpu(monkeypatch):
    smoke = _load_smoke()
    assert smoke.PHASES.index("seq") == smoke.PHASES.index("pipe") + 1
    monkeypatch.setattr(smoke, "free_cuda", lambda: None)
    monkeypatch.setattr(smoke, "DIST_TIMEOUT_S", 150)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = smoke.phase_seq("cpu", {
        "device": "cpu", "fn_shape": (2, 4, 32, 16), "batch": 2,
        "seq": 16, "steps": 2, "timed": 1,
        "gpt": {"vocab_size": 64, "hidden_size": 32, "num_layers": 2,
                "num_heads": 4, "max_position": 16},
        "long": {"batch": 2, "seq": 64, "embed": 32, "heads": 4,
                 "steps": 1}})
    for k in ("f32", "bf16"):
        r = res["gpt_" + k]
        # each rank: no flash launch on the ring path, one Adam a step,
        # 2 layers x 3 hops a step over the host-free CPU route
        assert r["launches"] == [{
            "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "adam_update": 2}] * 2, k
        assert [h["hops"] for h in r["hops"]] == [6, 6], k
        assert all(h["route"] == "direct" for h in r["hops"]), k
        # both ranks report the same history
        assert r["losses"][0] == r["losses"][1], k
    # f32 on the CPU: the ring reproduces the plain attention closely
    assert res["gpt_f32"]["grad_checked"] <= 1e-4
    assert max(res["gpt_f32"]["loss_err"]) <= 1e-5
    # the one-rank flash run launches its kernels (plain versions here)
    fl = res["one_rank_flash_bf16"]["launches"]
    assert fl["flash_attention_fwd"] == 2 * 2 and fl["adam_update"] == 2
    for key, x in res["fns"].items():
        assert x["launches"] == {n: int(key.startswith("ulysses"))
                                 for n in x["launches"]}, key
        assert max(x["errs"].values()) <= smoke.SEQ_FN_TOL[
            key.split("_")[2]], key
    long = res["long"]
    assert long["tier"]["impl"] in ("xla", "flash", "ring")
    assert long["ring"]["impl"] == "ring"
    assert long["flash"]["impl"] == "flash"
    assert long["ring"]["predicted_ms"] > 0 and long["flash"]["step_ms"] > 0
    assert sorted({k.split("|")[1] for k in long["rows"]}) == [
        "coll_ppermute", "op_attention@ring"]
