"""chip_smoke.py's genworld phase rehearsed on the CPU at a tiny size.

The phase as the card runs it (a one-rank reference run, a serving plan
searched on a described 2-device mesh, then two rank processes of the
script joined by the port's rendezvous, each generating under tp 2 and
dp 2 through InferenceSession and then serving the plan through
build_serving_plan_session behind rank 0's relay), cut to a GPT-2 of
vocab 64, hidden 32, 4 heads and 2 layers at 4 x 16, on the CPU: the
flash wrapper's plain-version calls stand in for its launches, so the
phase's own gates (12 launches a prefill there, 2 here, and none a
decode step; no KV fallback; both ranks' ids and decode steps equal;
the first decode step's scores against the one-rank run; the sampled
runs equal; the relayed calls equal on both ranks) are checked here as
on the card. The kernels' timings need a card and are left out.
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


def test_chip_smoke_genworld_phase_on_the_cpu(monkeypatch):
    smoke = _load_smoke()
    assert smoke.PHASES.index("genworld") == smoke.PHASES.index("seq") + 1
    assert smoke.PHASES.index("world") == smoke.PHASES.index("genworld") + 1
    monkeypatch.setattr(smoke, "free_cuda", lambda: None)
    monkeypatch.setattr(smoke, "DIST_TIMEOUT_S", 240)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = smoke.phase_genworld("cpu", {
        "device": "cpu", "batch": 4, "seq": 16, "plen": 5, "tokens": 6,
        "sample_tokens": 4, "ragged": [2, 5, 9], "beam": [4, 3, 2],
        "buckets": [1, 4], "plan_budget": 8, "plan_plen": 6,
        "relay_tokens": 3, "timed_tokens": 2,
        "gpt": {"vocab_size": 64, "hidden_size": 32, "num_layers": 2,
                "num_heads": 4, "max_position": 16}})
    # tp 2: greedy, ragged, ragged with eos, sampled twice, beam; dp 2:
    # greedy; 2 layers a prefill on each rank, none a decode step
    assert res["tp2"]["prefills"] == 6 and res["dp2"]["prefills"] == 1
    assert res["tp2"]["launches"] == [2 * 6] * 2
    assert res["dp2"]["launches"] == [2] * 2
    for k in ("tp2", "dp2"):
        assert res[k]["steps"][0] == res[k]["steps"][1] > 0, k
        assert res[k]["first_err"] <= smoke.GEN_TOL, k
    # the relay: greedy at 1 and 4 rows and two scheduled forwards, each
    # a prefill of 2 launches on both ranks
    assert res["plan"]["calls"] == 4
    assert res["plan"]["launches"] == [2 * 4] * 2
    assert res["plan"]["steps"] == 2 * 3
    assert set(res["plan"]["floor_guard"]) == {"1", "4"}
    assert "fwd_tp" not in res   # the kernels' times need a card
