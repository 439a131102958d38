"""The port's machine model (``parallel/machine.py``, ``parallel/
topology.py``) against the JAX package's on the same descriptions.

Every file in ``machine_configs/`` and a reference-style INI of a GPU
node (``nvlink_bandwidth``) load to equal ``MachineSpec`` fields, equal
derived constants, equal tier ladders and equal fabrics (shapes, link
tables, routes); meshes over the same specs factorize alike (axes,
degrees, axis allocation, tiers). Floats compare exactly: both packages
compute them from the same text by the same arithmetic.
"""
import dataclasses
import glob
import os

import pytest
import torch

from flexflow_tpu.parallel import machine as jmachine
from flexflow_tpu.parallel import topology as jtopo
from flexflow_tpu_torch.parallel import machine as tmachine
from flexflow_tpu_torch.parallel import topology as ttopo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "machine_configs", "*")))

GPU_INI = """# two DGX-style nodes of 8 GPUs (reference machine_config_example)
num_nodes = 2
num_sockets_per_node = 2
num_gpus_per_socket = 4
nvlink_bandwidth = 450
nvlink_latency = 0.001
nic_bandwidth = 50
nic_latency = 0.005
"""

JAX_FIELDS = [f.name for f in dataclasses.fields(jmachine.MachineSpec)
              if f.name != "topology_override"]


def _machine_files(tmp_path):
    ini = tmp_path / "dgx-2node.ini"
    ini.write_text(GPU_INI)
    return CONFIGS + [str(ini)]


def _fabric(topo):
    """A comparable description of a fabric."""
    if topo is None:
        return None
    if hasattr(topo, "conn"):
        return ("graph", topo.num_devices, sorted(topo.conn.items()),
                [topo.route(0, d) for d in range(topo.num_devices)])
    return ("torus", tuple(topo.shape),
            [topo.route(0, d) for d in range(topo.num_devices)])


def _ladder(spec):
    return [(t.name, t.bandwidth, t.latency_s, t.span)
            for t in spec.tier_graph.tiers]


def _derived(spec):
    return (spec.peak_flops, spec.hbm_bytes, spec.hbm_bandwidth,
            spec.ici_bandwidth, spec.dcn_bandwidth, spec.devices_per_slice)


@pytest.mark.parametrize("idx", range(len(CONFIGS) + 1))
def test_machine_files_load_alike(idx, tmp_path):
    path = _machine_files(tmp_path)[idx]
    j = jtopo.load_machine_file(path)
    t = ttopo.load_machine_file(path)
    for name in JAX_FIELDS:
        assert getattr(t, name) == getattr(j, name), (path, name)
    assert t.hbm_bytes_override is None
    assert _derived(t) == _derived(j)
    assert _ladder(t) == _ladder(j)
    assert t.tier_graph.multi_tier == j.tier_graph.multi_tier
    assert _fabric(t.topology) == _fabric(j.topology)
    assert _fabric(tmachine.MachineSpec.from_file(path).topology) \
        == _fabric(j.topology)


def test_gpu_ini_describes_nvlink_nodes(tmp_path):
    spec = ttopo.load_machine_file(_machine_files(tmp_path)[-1])
    assert spec.num_devices == 16 and spec.num_slices == 2
    assert spec.ici_bandwidth == 450e9 and spec.dcn_bandwidth == 50e9
    assert [t.name for t in spec.tier_graph.tiers] == ["ici", "dcn"]


@pytest.mark.parametrize("kind", ["big_switch", "degraded", "matrix",
                                  "multi_slice_torus"])
def test_topology_blocks_build_alike(kind):
    doc = {"big_switch": {"kind": "big_switch", "n": 8},
           "degraded": {"kind": "degraded",
                        "base": {"kind": "torus", "shape": [2, 4]},
                        "slow_links": [[0, 1], [2, 3]], "factor": 4},
           "matrix": {"kind": "matrix", "n": 3,
                      "links": [[0, 1, 10], [1, 2, 20], [2, 0, 5]]},
           "multi_slice_torus": {"kind": "multi_slice_torus",
                                 "shape": [2, 2], "n_slices": 2,
                                 "hosts_per_slice": 2}}[kind]
    j = jtopo.topology_from_json(doc, jmachine.MachineSpec(num_devices=8))
    t = ttopo.topology_from_json(doc, tmachine.MachineSpec(num_devices=8))
    assert _fabric(t) == _fabric(j)
    assert t.ring_links(list(range(t.num_devices))) \
        == j.ring_links(list(range(j.num_devices)))


def test_link_degradation_factor_follows_the_drill():
    from flexflow_tpu_torch.resilience import faults
    assert ttopo.link_degradation_factor("dcn") == 1.0
    faults.set_link_degradation("dcn", 3.0)
    try:
        assert ttopo.link_degradation_factor("dcn") == 3.0
        tier = ttopo.Tier("dcn", 30e9, 1e-5, 16)
        assert ttopo.effective_tier_bandwidth(tier) == 10e9
    finally:
        faults.clear()
    assert ttopo.link_degradation_factor("dcn") == 1.0


MESHES = [  # (spec kwargs, mesh_shape, seq)
    (dict(num_devices=1), None, 0),
    (dict(num_devices=8), None, 0),
    (dict(num_devices=8), (2, 4), 0),
    (dict(num_devices=8), None, 2),
    (dict(num_devices=8, num_slices=2, num_hosts=4), None, 0),
    (dict(num_devices=6), None, 0),
]


@pytest.mark.parametrize("i", range(len(MESHES)))
def test_meshes_factorize_alike(i):
    kw, shape, seq = MESHES[i]
    j = jmachine.DeviceMesh(jmachine.MachineSpec(**kw), mesh_shape=shape,
                            seq=seq)
    t = tmachine.DeviceMesh(tmachine.MachineSpec(**kw), mesh_shape=shape,
                            seq=seq)
    assert t.axis_sizes == j.axis_sizes
    assert (t.seq_axis, t.dcn_axis, t.seq_degree) == \
        (j.seq_axis, j.dcn_axis, j.seq_degree)
    assert t.valid_degrees() == j.valid_degrees()
    assert t.axis_tiers == j.axis_tiers
    assert t.axes_by_tier() == j.axes_by_tier()
    assert (t.sharding_axes, t.sharding_devices) == \
        (j.sharding_axes, j.sharding_devices)
    for d in (1, 2, 3, 4, 8):
        for prefer in (None, "inner", "outer"):
            assert t.allocate_axes(d, [], prefer=prefer) == \
                j.allocate_axes(d, [], prefer=prefer)
            assert t.allocate_axes(d, ["x0"], prefer=prefer) == \
                j.allocate_axes(d, ["x0"], prefer=prefer)
    # a mesh over more devices than the process has is a described one
    assert t.described == (kw["num_devices"] > 0)
    live = tmachine.DeviceMesh(tmachine.MachineSpec(num_devices=1),
                               devices=["cpu"])
    assert not live.described and live.devices == [torch.device("cpu")]


def test_mesh_shape_must_cover_the_devices():
    with pytest.raises(ValueError, match="does not cover"):
        tmachine.DeviceMesh(tmachine.MachineSpec(num_devices=1),
                            devices=["cpu"], mesh_shape=(2, 4))


def test_detect_names_the_card(monkeypatch):
    assert tmachine.MachineSpec.detect("cpu").generation == "cpu-sim"

    class Props:
        name = "NVIDIA H100 80GB HBM3"
        total_memory = 85_045_231_616

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    spec = tmachine.MachineSpec.detect("cuda")
    assert (spec.generation, spec.num_devices) == ("h100", 1)
    assert spec.hbm_bytes == Props.total_memory
    # NVIDIA's published H100 SXM figures
    assert spec.peak_flops == 989.4e12
    assert spec.hbm_bandwidth == 3350e9
    assert spec.ici_bandwidth == 450e9
    # the TPU generations are the JAX package's table, unchanged
    assert tmachine.TPU_GENERATIONS == jmachine.TPU_GENERATIONS


def test_partition_specs_and_parallel_shapes_alike():
    from flexflow_tpu.parallel.ptensor import \
        ParallelTensorShape as JShape
    from flexflow_tpu_torch.parallel.ptensor import \
        ParallelTensorShape as TShape
    args = ((8, 16, 32), None, (2, 1, 4), [("x0",), (), ("x1", "x2")])
    j, t = JShape.from_shape(*args), TShape.from_shape(*args)
    assert tuple(j.partition_spec()) == t.partition_spec() == \
        ("x0", None, ("x1", "x2"))
    assert (t.global_shape(), t.shard_shape(), t.total_degree()) == \
        (j.global_shape(), j.shard_shape(), j.total_degree())
