"""chip_smoke.py's world phase rehearsed on the CPU at a tiny size.

The phase as the card runs it (the port's WorldSupervisor over two rank
processes of ``tools/torch_dist_resilience_smoke.py --worker``, each
training under a per-process Supervisor with a two-phase checkpoint every
2 steps, through four drills: (a) clean, (b) ``rank_crash@3:1`` with one
relaunch, bit-equal to (a) on both ranks, (c) the same fault shrunk to
one rank, restored bit-equal to the step it adopted, (d)
``crash_after_stage@2:1`` leaving ``tmp-2`` debris and a fresh world
quorum-restoring step 1), cut to BERT-tiny with 2 layers at 8 x 16 in
f32 and gloo ranks on the CPU, with tighter detector bounds: the flash
and Adam wrappers' plain-version calls stand in for their launches, so
the phase's own gates (2 / 2 / 2 flash calls and one fused Adam in every
executed step of every rank, replays included) are checked here as on
the card. The kernels' timings need a card and are left out.
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


def test_chip_smoke_world_phase_on_the_cpu(monkeypatch, tmp_path):
    smoke = _load_smoke()
    assert smoke.PHASES.index("world") == smoke.PHASES.index("seq") + 1
    assert smoke.PHASES[-1] == "serve"
    monkeypatch.setattr(smoke, "free_cuda", lambda: None)
    monkeypatch.setattr(smoke, "WORLD_TIMEOUT_S", 90)
    monkeypatch.setattr(smoke, "WORLD_ENV", {
        "FF_HB_INTERVAL_S": "0.1", "FF_HB_TIMEOUT_S": "5",
        "FF_BARRIER_TIMEOUT_S": "12", "OMP_NUM_THREADS": "1",
        "JAX_PLATFORMS": "cpu"})
    # the launcher's flight records go to this test's directory
    import flexflow_tpu_torch.obs.flight as flight
    monkeypatch.setattr(flight, "_DEFAULT_DIR", str(tmp_path))
    res = smoke.phase_world("cpu", dict(
        smoke.WORLD_SPEC, device="cpu", bert="tiny", layers=2, seq=16,
        bf16=False))
    # 6 steps a rank clean; (b) steps 0-2 a rank, then 3-5 a rank after
    # the relaunch resumes from the epoch boundary's step 3, or 2-5 where
    # the crash tore that save (it runs on the writer thread while rank 1
    # goes on to die); (c) the same epoch 0, then those steps on one
    # rank; (d) 2 a rank, none after the relaunch (it restores)
    assert res["clean_steps"] == 12
    assert res["faulted_steps"] in (12, 14)
    assert res["shrink_steps"] in (9, 10)
    assert res["torn_steps"] == 4
    # the card's detection gate is FF_HB_TIMEOUT_S and a step, to two
    # beats; here the beat thread shares the CPU with the other test
    # workers' ranks and may run late, so a second more is allowed
    assert res["detect_s"] <= 5.0 + res["step_s"] + 2 * 0.1 + 1.0
    assert res["torn_wait_s"] <= 12.0
    assert len(res["adam_shapes"]) == len(res["adam_shapes_one"])
