"""The port's calibration (``search/calibration.py``) and measured kernel
plan (``FFModel._plan_kernels``) against the JAX package's.

A table written by either package loads in the other, and the lookups
over it (interpolation, nearest degree, marginal, provenance keys)
answer alike. The port's tables and audits live in a directory of their
own (``FF_CACHE_DIR``, else ``.ffcache/torch``) and never touch the JAX
package's ``.ffcache/`` files: every test here points both packages at
its own ``tmp_path``. With the same hand-set rows in both tables, a
one-device compile with ``calibration_v2`` plans the same kernels and
writes the same audit record. A failing microbenchmark raises.
"""
import os
import sys

import numpy as np
import pytest

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.obs import audit as jaudit
from flexflow_tpu.parallel.machine import MachineSpec as JSpec
from flexflow_tpu.search import calibration as jcal
from flexflow_tpu_torch.obs import audit as taudit
from flexflow_tpu_torch.parallel import DeviceMesh, MachineSpec
from flexflow_tpu_torch.search import calibration as tcal
from flexflow_tpu_torch.search import costmodel as tcost

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_graphs as graphs  # noqa: E402

ROWS = [  # (backend, kind, dtype, sclass, axis, value)
    ("cpu", "host_dispatch", "-", 0, 0, 6.0e-6),
    ("cpu", "host_membw", "-", 0, 0, 1.5e10),
    ("cpu", "op_attention@xla", "float32", 1 << 16, 0, 4.0e-4),
    ("cpu", "op_attention@xla", "float32", 1 << 20, 0, 9.0e-3),
    ("cpu", "op_attention@flash", "float32", 1 << 16, 0, 1.0e-4),
    ("cpu", "op_attention@flash", "float32", 1 << 20, 0, 2.0e-3),
    ("cpu", "coll_all_reduce", "float32", 1 << 16, 2, 2.0e-5),
    ("cpu", "coll_all_reduce", "float32", 1 << 20, 2, 5.0e-5),
    ("cpu", "coll_all_reduce", "float32", 1 << 23, 2, 4.0e-4),
    ("cpu", "coll_all_reduce", "float32", 1 << 20, 8, 9.0e-5),
    ("cuda", "op_attention@flash", "float32", 1 << 16, 0, 3.0e-5),
]


def _fill(mod, path):
    tab = mod.CalibrationTable(str(path))
    for row in ROWS:
        tab.put(*row)
    return tab


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tables_cross_packages(writer, tmp_path):
    w, r = (jcal, tcal) if writer == "jax" else (tcal, jcal)
    _fill(w, tmp_path)
    tab = r.CalibrationTable(str(tmp_path))
    for b, kind, dt, sc, ax, v in ROWS:
        assert tab.get(b, kind, dt, sc, ax) == v
    assert tab.entries("cpu", "op_attention@flash", "float32") == \
        [(1 << 16, 1.0e-4), (1 << 20, 2.0e-3)]
    assert tab.measured == 0
    with open(os.path.join(tmp_path, "calibration_v2.json")) as f:
        assert len(f.read()) > 0


def test_lookups_answer_alike(tmp_path):
    jc = jcal.MeshCalibration(backend="cpu",
                              table=_fill(jcal, tmp_path / "j"))
    tc = tcal.MeshCalibration(backend="cpu",
                              table=_fill(tcal, tmp_path / "t"))
    for c in (jc, tc):
        c.parallel_eff = {8: 0.5}
    for nbytes in (1, 1 << 12, 1 << 16, 3 << 17, 1 << 20, 1 << 23, 1 << 26):
        for deg in (2, 3, 4, 8, 16):
            assert tc.collective_time("all_reduce", deg, nbytes) == \
                jc.collective_time("all_reduce", deg, nbytes)
            assert tc.collective_marginal("all_reduce", deg, nbytes) == \
                jc.collective_marginal("all_reduce", deg, nbytes)
            assert tc.row_key("all_reduce", deg, nbytes) == \
                jc.row_key("all_reduce", deg, nbytes)
        for impl in ("xla", "flash", "ring"):
            assert tc.op_time(f"attention@{impl}", nbytes) == \
                jc.op_time(f"attention@{impl}", nbytes)
    for n in (1, 2, 4, 8, 16):
        assert tc.efficiency(n) == jc.efficiency(n)
    for nb in (0, 1, 2, 3, 1000, 1 << 20, 3 << 20):
        assert tcal.shape_class(nb) == jcal.shape_class(nb)
        assert tcal._attn_seq_len(nb) == jcal._attn_seq_len(nb)
    for mode in ("true", "false", "auto", None):
        cfg_t, cfg_j = fft.FFConfig(), ffj.FFConfig()
        cfg_t.calibration_v2 = cfg_j.calibration_v2 = mode
        assert tcal.calibration_enabled(cfg_t) == \
            jcal.calibration_enabled(cfg_j)


def test_the_port_keeps_its_own_cache_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("FF_CACHE_DIR", raising=False)
    own = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".ffcache", "torch")
    assert os.path.dirname(tcal.CalibrationTable().path) == own
    assert os.path.dirname(taudit.audit_path("k")) == own
    assert tcost.OpCostModel(MachineSpec())._cache_dir == own
    assert tcal.CalibrationTable().path != jcal.CalibrationTable().path
    assert taudit.audit_path("k") != jaudit.audit_path("k")
    monkeypatch.setenv("FF_CACHE_DIR", str(tmp_path))
    assert tcal.CalibrationTable().path == \
        str(tmp_path / "calibration_v2.json")
    assert taudit.audit_path("k") == \
        str(tmp_path / "strategy_audit_k.json")


def test_microbenchmarks_measure_once_and_raise_on_failure(tmp_path):
    tab = tcal.CalibrationTable(str(tmp_path))
    mesh = DeviceMesh(MachineSpec(), devices=["cpu"])
    tcal.calibrate_kernel_impls(mesh, tab)
    assert tab.measured == 4        # xla and flash at s 128 and 512
    assert all(v > 0 for _, v in tab.entries(
        "cpu", "op_attention@flash", "float32"))
    again = tcal.CalibrationTable(str(tmp_path))
    tcal.calibrate_kernel_impls(mesh, again)
    assert again.measured == 0      # a warm table measures nothing
    assert tcal._bench_dispatch("cpu") > 0
    assert tcal._bench_membw(1 << 22, "cpu") > 0

    def broken():
        raise RuntimeError("a kernel failed to launch")

    with pytest.raises(RuntimeError, match="failed to launch"):
        tab.get_or_measure("cpu", "host_dispatch", "-", 7, 0, broken)
    assert tab.get("cpu", "host_dispatch", "-", 7, 0) is None


def _planned(pkg, tmp, monkeypatch, trace=False):
    """A tiny BERT compiled on one device with calibration_v2 over a
    table holding ROWS (both packages' tables and audits in ``tmp``)."""
    jff, tff = graphs.bert(batch=4, seq=16, dropout=0.0,
                           calibration_v2="true", only_data_parallel=True,
                           use_bf16_compute=False)
    ff = jff if pkg == "jax" else tff
    mod = jcal if pkg == "jax" else tcal
    monkeypatch.setattr(mod, "_DEFAULT_DIR", str(tmp))
    monkeypatch.setattr(jaudit if pkg == "jax" else taudit,
                        "_DEFAULT_DIR", str(tmp))
    _fill(mod, tmp)
    kw = {"machine_spec": JSpec(num_devices=1, generation="cpu-sim")} \
        if pkg == "jax" else {}
    p = ffj if pkg == "jax" else fft
    ff.compile(p.AdamOptimizer(alpha=1e-3, epsilon=1e-4),
               "sparse_categorical_crossentropy", ["accuracy"], **kw)
    return ff


def test_measured_kernel_plan_matches_jax(tmp_path, monkeypatch):
    j = _planned("jax", tmp_path / "jax", monkeypatch)
    t = _planned("port", tmp_path / "port", monkeypatch)
    jr, tr = j._kernel_record, t._kernel_record
    assert {k: v for k, v in tr.items() if k != "ops"} == \
        {k: v for k, v in jr.items() if k != "ops"}
    assert tr["measured"] and tr["backend"] == "cpu"
    assert len(tr["ops"]) == len(jr["ops"]) == 3   # 2 attention + update
    for a, b in zip(tr["ops"], jr["ops"]):
        assert {k: a[k] for k in ("name", "op", "impl", "forced")} == \
            {k: b[k] for k in ("name", "op", "impl", "forced")}
        for k in ("predicted_s", "forced_xla_s", "delta_s"):
            assert np.isclose(a[k], b[k], rtol=1e-9, atol=1e-15), (a, b)
    assert dict(t.strategy.kernel_impls) == dict(j.strategy.kernel_impls)
    assert set(t.executor._kernel_impls.values()) == {"flash"}
    # each package wrote its table where it was pointed, nowhere else
    assert os.path.exists(tmp_path / "port" / "calibration_v2.json")
    assert os.path.exists(tmp_path / "jax" / "calibration_v2.json")
