"""The port's cost model (``search/costmodel.py``) against the JAX
package's, op by op.

Small BERT, GPT-2, ResNet-50 and DLRM graphs are built the same way in
both packages; every layer is priced on described 1- and 8-device
machines under several output shard-degree maps and weight shard
degrees: ``op_cost`` (forward, backward, memories), ``kernel_impl_cost``
for the attention impls and the optimizer update, and the collective
terms (``xfer_cost``, ``resharding_cost``, ``weight_sync_cost``), bare
and with the same hand-set calibration rows attached. Agreement is to
1e-9 relative. Nothing is measured: the ports' on-card paths
(``calibrate``, ``measure``) are covered by ``chip_smoke.py``.
"""
import math
import sys
import os

import pytest

from flexflow_tpu.parallel.machine import DeviceMesh as JMesh
from flexflow_tpu.parallel.machine import MachineSpec as JSpec
from flexflow_tpu.search import calibration as jcal
from flexflow_tpu.search.costmodel import OpCostModel as JCost
from flexflow_tpu_torch.parallel.machine import DeviceMesh as TMesh
from flexflow_tpu_torch.parallel.machine import MachineSpec as TSpec
from flexflow_tpu_torch.search import calibration as tcal
from flexflow_tpu_torch.search.costmodel import OpCostModel as TCost

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_graphs as graphs  # noqa: E402

REL = 1e-9
MACHINES = {
    "1dev": dict(num_devices=1, generation="v5e"),
    "8dev": dict(num_devices=8, generation="v5e"),
    "2slice": dict(num_devices=8, generation="v5e", num_slices=2,
                   num_hosts=2),
}


def close(a, b):
    return math.isclose(a, b, rel_tol=REL, abs_tol=1e-30)


def _models(machine, tmp_path=None, calibrated=False):
    kw = MACHINES[machine]
    j = JCost(JSpec(**kw), cache_dir=str(tmp_path or "/nonexistent"))
    t = TCost(TSpec(**kw), cache_dir=str(tmp_path or "/nonexistent"))
    if calibrated:
        j.attach_calibration(_calib(jcal, tmp_path / "jax"))
        t.attach_calibration(_calib(tcal, tmp_path / "port"))
    return j, t


ROWS = {  # (kind, dtype, sclass, axis) -> seconds / bytes per s
    ("host_dispatch", "-", 0, 0): 7.5e-6,
    ("host_membw", "-", 0, 0): 2.1e12,
    ("op_attention@xla", "float32", 1 << 16, 0): 3.1e-5,
    ("op_attention@xla", "float32", 1 << 20, 0): 4.2e-4,
    ("op_attention@flash", "float32", 1 << 16, 0): 3.4e-5,
    ("op_attention@flash", "float32", 1 << 20, 0): 2.2e-4,
    ("coll_all_reduce", "float32", 1 << 16, 2): 2.0e-5,
    ("coll_all_reduce", "float32", 1 << 20, 2): 6.0e-5,
    ("coll_all_reduce", "float32", 1 << 23, 8): 9.0e-4,
    ("coll_all_gather", "float32", 1 << 20, 8): 1.0e-4,
    ("coll_all_to_all", "float32", 1 << 20, 4): 1.5e-4,
}


def _calib(mod, cache):
    """A table with ROWS, written through the package's own API."""
    tab = mod.CalibrationTable(str(cache))
    for (kind, dt, sc, ax), v in ROWS.items():
        tab.put("cpu", kind, dt, sc, ax, v)
    c = mod.MeshCalibration(backend="cpu", table=tab)
    c.dispatch_s = tab.get("cpu", "host_dispatch")
    c.mem_bw = tab.get("cpu", "host_membw")
    return c


def _degree_maps(layer, n_dev):
    rank = len(layer.outputs[0].shape) if layer.outputs else 0
    maps = [({}, 1)]
    if n_dev > 1 and rank:
        maps += [({0: 2}, 1), ({0: n_dev}, 1), ({0: 2}, 4)]
        if rank > 1:
            maps += [({rank - 1: 4}, 1), ({0: 2, rank - 1: 4}, 2)]
    return maps


def _cm_eq(a, b, what):
    for f in ("forward_time", "backward_time", "sync_time"):
        assert close(getattr(a, f), getattr(b, f)), (what, f, a, b)
    for f in ("inputs_memory", "outputs_memory", "weights_memory"):
        assert getattr(a, f) == getattr(b, f), (what, f, a, b)


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("machine", ["1dev", "8dev"])
@pytest.mark.parametrize("graph", sorted(graphs.GRAPHS))
def test_op_and_kernel_impl_costs_agree(graph, machine, calibrated,
                                        tmp_path):
    jff, tff = graphs.GRAPHS[graph]()
    jc, tc = _models(machine, tmp_path, calibrated)
    n_dev = MACHINES[machine]["num_devices"]
    priced = 0
    for jl, tl in zip(jff.layers, tff.layers):
        for sd, wdeg in _degree_maps(jl, n_dev):
            _cm_eq(jc.op_cost(jl, sd, wdeg), tc.op_cost(tl, sd, wdeg),
                   (jl.name, sd, wdeg))
            priced += 1
            if jl.op_type.name == "OP_MULTIHEAD_ATTENTION":
                for impl, deg in (("xla", 0), ("flash", 0), ("ring", 2)):
                    _cm_eq(jc.kernel_impl_cost(jl, "attention", impl, sd,
                                               wdeg, seq_degree=deg),
                           tc.kernel_impl_cost(tl, "attention", impl, sd,
                                               wdeg, seq_degree=deg),
                           (jl.name, impl, sd))
    assert priced >= len(jff.layers)
    pbytes = sum(4.0 * math.prod(w.shape) for l in jff.layers
                 for w in l.weights)
    for impl in ("fused", "unfused"):
        _cm_eq(jc.kernel_impl_cost(None, "opt_update", impl,
                                   param_bytes=pbytes),
               tc.kernel_impl_cost(None, "opt_update", impl,
                                   param_bytes=pbytes), impl)


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("machine", ["8dev", "2slice"])
def test_collective_terms_agree(machine, calibrated, tmp_path):
    jc, tc = _models(machine, tmp_path, calibrated)
    for vol in (0, 1 << 10, 3 << 16, 1 << 20, 5 << 21, 1 << 26):
        for deg in (1, 2, 3, 4, 8):
            for coll in ("all_reduce", "all_gather", "reduce_scatter",
                         "all_to_all", "permute"):
                assert close(jc.xfer_cost(vol, coll, deg),
                             tc.xfer_cost(vol, coll, deg)), (vol, coll, deg)
            assert close(jc.weight_sync_cost(vol, deg),
                         tc.weight_sync_cost(vol, deg)), (vol, deg)
        for src, dst in (({}, {0: 2}), ({0: 2}, {}), ({0: 2}, {0: 4}),
                         ({0: 2}, {1: 2}), ({0: 8}, {0: 2, 1: 4})):
            assert close(jc.resharding_cost(vol, src, dst),
                         tc.resharding_cost(vol, src, dst)), (src, dst)


def test_kernel_tier_prices_attention_at_its_cheapest_impl(tmp_path):
    jff, tff = graphs.bert()
    jc, tc = _models("8dev", tmp_path, calibrated=True)
    jd = JMesh(JSpec(**MACHINES["8dev"]))
    td = TMesh(TSpec(**MACHINES["8dev"]))
    jc.attach_kernel_tier(jd)
    tc.attach_kernel_tier(td)
    for jl, tl in zip(jff.layers, tff.layers):
        for sd, wdeg in _degree_maps(jl, 8):
            _cm_eq(jc.op_cost_with_impl(jl, sd, wdeg),
                   tc.op_cost_with_impl(tl, sd, wdeg), (jl.name, sd))
            assert jc.last_kernel_impl == tc.last_kernel_impl
    assert jc.kernel_choice == tc.kernel_choice
    assert set(tc.kernel_choice.values()) <= {"xla", "flash"}


def test_unported_pricing_is_refused():
    tc = TCost(TSpec(num_devices=8))
    tc.attach_placement(None)
    tc.attach_quantization("off")
    with pytest.raises(NotImplementedError, match="item 5"):
        tc.attach_placement(object())
    # quantized sync pricing is ported: a policy attaches, a wrong mode
    # is an error as in the JAX package
    tc.attach_quantization("auto")
    assert tc.quantization == {"mode": "auto", "wire": "int8"}
    with pytest.raises(ValueError, match="quantization mode"):
        tc.attach_quantization("sometimes")
    # a described mesh has nothing to time; a live single device neither
    tc.calibrate_collectives(TMesh(TSpec(num_devices=8)))
    tc.calibrate_collectives(TMesh(TSpec(num_devices=1), devices=["cpu"]))


def test_measure_runs_the_ops_emit_and_keeps_the_launch_counts():
    """measure() on the CPU (the card's path with host timing): a
    positive forward and backward time for a Linear and an attention
    layer, the kernels' counters put back afterwards."""
    from flexflow_tpu_torch.kernels.flash_attention import flash_attention
    _, tff = graphs.bert()
    tc = TCost(TSpec(num_devices=1, generation="cpu-sim"))
    tc.device = "cpu"
    before = (flash_attention.launches, flash_attention.plain_calls)
    for l in tff.layers:
        if l.op_type.name in ("OP_LINEAR", "OP_MULTIHEAD_ATTENTION"):
            cm = tc.measure(l, {}, 1, warmup=1, repeats=2)
            assert cm.forward_time > 0 and cm.backward_time >= 0, l.name
    assert (flash_attention.launches, flash_attention.plain_calls) \
        == before
    assert tc._measure_spent_s > 0
