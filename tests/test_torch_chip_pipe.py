"""chip_smoke.py's pipe phase rehearsed on the CPU at a tiny size.

The phase as the card runs it (a one-rank reference, then two rank
processes of the script joined by the port's rendezvous, each training
BERT pp 2 under GPipe and the interleaved schedule, and DLRM with its
four tables one bank over the two ranks, against the one-rank runs'
forward, first-step gradients at dropout 0.1 and loss history, with
every kernel launch counted), cut to ``BertConfig.tiny()`` with 4
layers (2 stages x 2 chunks) at 8 x 16 and DLRM to tables of 1,000 rows
of 16, in f32 on the CPU: the flash and Adam wrappers' plain-version
calls stand in for their launches, so the phase's own gates (one flash
forward, dq and dk/dv per block per microbatch, one Adam a step a rank,
2 of 4 tables a rank) are checked here as on the card. The kernels'
timings need a card and are left out.
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


def test_chip_smoke_pipe_phase_on_the_cpu(monkeypatch):
    smoke = _load_smoke()
    assert smoke.PHASES.index("pipe") == smoke.PHASES.index("dist") + 1
    monkeypatch.setattr(smoke, "free_cuda", lambda: None)
    monkeypatch.setattr(smoke, "DIST_TIMEOUT_S", 120)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = smoke.phase_pipe("cpu", {
        "device": "cpu", "bert": "tiny", "batch": 8, "seq": 16,
        "steps": 2, "timed": 1, "f32": True, "layers": 4,
        "dlrm": {"embedding_size": (1000,) * 4, "sparse_feature_size": 16,
                 "mlp_bot": (4, 16, 16), "mlp_top": (16, 16, 2)}})
    # another draw of every mask fails the first-step check by far
    assert res["control"]["f32"] > 10 * smoke.ZOO_GRAD_TOL
    from flexflow_tpu_torch.models import BertConfig
    act = 2 * 16 * BertConfig.tiny().hidden_size * 4   # a microbatch, f32
    for name, sends in (("gpipe", 4), ("interleaved", 12)):
        r = res[name]
        # each rank: its 2 blocks x 4 microbatches a step, no bubble slot
        assert r["launches_per_rank"] == {
            "flash_attention_fwd": 16, "flash_attention_bwd_dq": 16,
            "flash_attention_bwd_dkv": 16, "adam_update": 2}, name
        # f32 on the CPU: the ranks reproduce the one-rank run closely
        assert r["forward_err"] <= 1e-5 and r["loss_err"] <= 1e-5, name
        assert r["grad_checked"]["f32"] <= smoke.ZOO_GRAD_TOL, name
        # GPipe hands each microbatch on once a step and its cotangent
        # back once; the interleaved ring three times each way
        for p in r["p2p"]:
            assert p["route"] == "direct" and p["calls"] == sends, name
            assert p["bytes"] == sends * act, name
    d = res["dlrm"]
    assert d["launches_per_rank"]["adam_update"] == smoke.PIPE_DLRM_STEPS
    assert d["grad_worst"] <= smoke.ZOO_GRAD_TOL
    # each rank holds 2 of the 4 tables (1,000 x 16 each) and the MLPs
    one = 4 * 1000 * 16
    assert d["numel"] == [33682, 33682] == [65682 - one // 2] * 2
