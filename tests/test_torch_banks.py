"""Op banks and place groups over a world of ranks, held against the JAX
package (``parallel/banks.py``).

Grouping (``find_bank_groups``, ``group_is_padded``, ``choose_bank_axes``,
the members' machine views) runs on graphs built the same way in both
packages. Execution runs through the port's ``FFModel.compile`` on one
gloo launch of 4 CPU ranks (``tests/_torch_world.py``; the port's mesh is
2 x 2, the JAX package's the conftest's 2 x 2 x 2 of 8 devices, dp 4 x pp
2 under the pipeline), each model recompiled with the grouping attached
to its data-parallel (or pipeline) strategy and loaded with the JAX
banked model's weights (its stacked ``__bank0__EMB`` leaf) through
``interop``:
- DLRM at small widths (four tables of 100 rows, 16 features; batch 32),
  its tables one bank over the whole mesh;
- the same with tables of 100 / 200 / 300 / 400 rows: a padded bank;
- four tables before a 4-block MLP pipeline region (pp 2), banked over
  the dp axes beside it;
- an embedding and a linear, one place group over the first mesh axis,
  whose gradients the JAX test asks to be exact.
Tolerances (f32): forward and 3-step SGD losses within 1e-5, first-step
gradients within 1e-6 + 1e-5 relative (place groups: 1e-6 + 1e-5, the
JAX test's exactness bound). Strategy files with banks and place groups
round-trip between the packages, and the legacy text format names the
banked rows in its sidecar, whose import both packages refuse.
"""
import json

import jax
import numpy as np
import pytest

import flexflow_tpu as ffj
from flexflow_tpu.ffconst import AggrMode
from flexflow_tpu.models import DLRMConfig, build_dlrm
from flexflow_tpu.parallel import banks as jbanks
from flexflow_tpu.parallel.machine import DeviceMesh as JMesh
from flexflow_tpu.parallel.machine import MachineSpec as JSpec
from flexflow_tpu.parallel.strategy import ShardingStrategy as JStrategy
from flexflow_tpu.search import serialization as jser

import _torch_graphs as graphs
from _torch_world import run_world
from flexflow_tpu_torch.parallel import banks as tbanks
from flexflow_tpu_torch.parallel.machine import DeviceMesh as TMesh
from flexflow_tpu_torch.parallel.machine import MachineSpec as TSpec
from flexflow_tpu_torch.parallel.strategy import ShardingStrategy as TStrategy
from flexflow_tpu_torch.search import serialization as tser

FWD_TOL, LOSS_TOL = 1e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5
STEPS = 3
VOCABS = {"bank": (100,) * 4, "padded": (100, 200, 300, 400),
          "bank_pipe": (100, 200, 300, 400)}


# ----------------------------------------------------------------------
# grouping, on described meshes
# ----------------------------------------------------------------------

def _meshes():
    return (JMesh(JSpec(num_devices=8, generation="cpu-sim")),
            TMesh(TSpec(num_devices=8, generation="cpu-sim"),
                  mesh_shape=(2, 2, 2)))


@pytest.mark.parametrize("padded", [False, True])
def test_bank_groups_axes_and_views_match_jax(padded):
    sizes = (1000, 2000) if padded else (1000, 1000)
    jff, tff = graphs.dlrm(batch=8)
    if not padded:
        jff, tff = (ff for ff in _dlrm_pair(sizes))
    got = []
    for mod, ff, mesh in ((jbanks, jff, _meshes()[0]),
                          (tbanks, tff, _meshes()[1])):
        groups = mod.find_bank_groups(ff.layers)
        emb = [g for g in groups if g[0].op_type.name == "OP_EMBEDDING"]
        strict = [g for g in mod.find_bank_groups(ff.layers,
                                                  allow_padded=False)
                  if g[0].op_type.name == "OP_EMBEDDING"]
        members = [l.name for l in emb[0]]
        axes = mod.choose_bank_axes(mesh, len(members))
        bk = mod.BankSpec(members, axes[0], batch_axes=axes[1],
                          padded=mod.group_is_padded(emb[0]))
        views = {m: (v.start_device_id, v.num_parts, v.stride,
                     v.explicit_ids)
                 for m, v in bk.machine_views(mesh).items()}
        got.append((len(groups), members, bool(strict),
                    mod.group_is_padded(emb[0]), axes, views))
    assert got[0] == got[1]
    assert got[1][3] == padded and got[1][2] == (not padded)


def _dlrm_pair(sizes, batch=8):
    out = []
    import flexflow_tpu_torch as fft
    import flexflow_tpu_torch.models as tmodels
    for pkg, models, kw in ((ffj, None, {}), (fft, tmodels, {"device": "cpu"})):
        cfg = pkg.FFConfig()
        cfg.batch_size = batch
        ff = pkg.FFModel(cfg, **kw)
        m = models or __import__("flexflow_tpu.models", fromlist=["x"])
        m.build_dlrm(ff, batch, m.DLRMConfig(
            embedding_size=sizes, sparse_feature_size=16,
            mlp_bot=(4, 16, 16), mlp_top=(16, 16, 2)))
        out.append(ff)
    return out


def test_place_group_views_match_jax():
    meshes = _meshes()
    views = []
    for mod, mesh in ((jbanks, meshes[0]), (tbanks, meshes[1])):
        pg = mod.PlaceGroup(["emb", "proj"], "x0")
        views.append({m: (v.start_device_id, v.num_parts, v.stride,
                          v.explicit_ids)
                      for m, v in pg.machine_views(mesh).items()})
    assert views[0] == views[1]
    flat = [i for v in views[1].values() for i in
            range(v[0], v[0] + v[1] * v[2], v[2])] if all(
        v[3] is None for v in views[1].values()) else None
    assert flat is None or len(set(flat)) == 8


# ----------------------------------------------------------------------
# strategy files
# ----------------------------------------------------------------------

def _grouped_strategies():
    """The same data-parallel strategy with a padded bank and a place
    group in each package, over the described 8-device mesh."""
    jff, tff = _dlrm_pair((1000, 2000, 3000, 4000))
    out = []
    for mod, st_cls, ff, mesh in ((jbanks, JStrategy, jff, _meshes()[0]),
                                  (tbanks, TStrategy, tff, _meshes()[1])):
        st = st_cls.data_parallel(ff.layers, ff.input_tensors, mesh)
        emb = [g for g in mod.find_bank_groups(ff.layers)
               if g[0].op_type.name == "OP_EMBEDDING"][0]
        axes = mod.choose_bank_axes(mesh, len(emb))
        st.banks = [mod.BankSpec([l.name for l in emb], axes[0],
                                 batch_axes=axes[1], param_name="__bank0__EMB",
                                 padded=True)]
        lin = [l.name for l in ff.layers if l.op_type.name == "OP_LINEAR"]
        st.place_groups = [mod.PlaceGroup([lin[0], lin[-1]], "x0")]
        out.append((ff, st, mesh))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bank_and_place_group_files_cross_packages(writer, tmp_path):
    (jff, jst, jm), (tff, tst, tm) = _grouped_strategies()
    path = str(tmp_path / "s.json")
    (jser if writer == "jax" else tser).save_strategy(
        path, jst if writer == "jax" else tst, None, {})
    for ser, ff, mesh in ((jser, jff, jm), (tser, tff, tm)):
        st = ser.load_strategy(path, ff.layers, mesh)
        bk = st.banks[0]
        assert bk.members == tst.banks[0].members and bk.padded
        assert tuple(bk.axes) == tuple(tst.banks[0].axes)
        assert tuple(bk.batch_axes) == tuple(tst.banks[0].batch_axes)
        assert bk.param_name == "__bank0__EMB"
        assert st.place_groups[0].members == tst.place_groups[0].members
        assert st.place_groups[0].axis == "x0"
    # the two packages write the same file
    j2, t2 = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jser.save_strategy(j2, jser.load_strategy(path, jff.layers, jm), None,
                       {})
    tser.save_strategy(t2, tser.load_strategy(path, tff.layers, tm), None,
                       {})
    assert json.load(open(j2)) == json.load(open(t2))


def test_legacy_format_names_banked_rows_and_import_refuses(tmp_path):
    (jff, jst, jm), (tff, tst, tm) = _grouped_strategies()
    for st in (jst, tst):
        # the bank places its members: they leave the batch sharding, and
        # each row folds its subset into the batch dim
        for m in st.banks[0].members:
            st.set_op(m, [None], {})
    rows = []
    for ser, ff, st, tag in ((jser, jff, jst, "j"), (tser, tff, tst, "t")):
        path = str(tmp_path / f"{tag}.txt")
        ser.save_legacy_strategies(path, st, ff.layers)
        rows.append((open(path).read(),
                     json.load(open(path + ".banks.json"))))
        for loader, lff, mesh in ((jser, jff, jm), (tser, tff, tm)):
            with pytest.raises(ValueError, match="device-subset"):
                loader.load_legacy_strategies(path, lff.layers, mesh)
    assert rows[0][1] == rows[1][1]
    assert rows[0][0] == rows[1][0]


# ----------------------------------------------------------------------
# execution over a world, against the JAX package
# ----------------------------------------------------------------------

def _dlrm_batches(ff, vocabs, batch=32):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        b = {}
        for t in ff.graph_inputs:
            if "sparse" in t.name:
                i = int(t.name.split("_")[-1])
                b[t.name] = rng.integers(0, vocabs[i], size=t.shape).astype(
                    np.int32)
            else:
                b[t.name] = rng.normal(size=t.shape).astype(np.float32)
        b["label"] = rng.integers(0, 2, (batch, 1)).astype(np.int32)
        out.append(b)
    return out


def _jax_grouped(model):
    """The JAX package's model, recompiled with its grouping attached as
    the JAX tests attach it: weights, layers, batches, the forward, the
    first-step gradients and an SGD loss history."""
    cfg = ffj.FFConfig()
    cfg.use_bf16_compute = False
    if model == "place":
        cfg.batch_size, cfg.only_data_parallel = 8, True
        ff = ffj.FFModel(cfg)
        ids = ff.create_tensor((8, 4), name="ids", dtype="int32")
        x = ff.create_tensor((8, 32), name="x")
        e = ff.embedding(ids, 50, 16, aggr=AggrMode.AGGR_MODE_SUM,
                         name="emb")
        d = ff.dense(x, 24, name="proj")
        out = ff.softmax(ff.dense(ff.concat([e, d], axis=1), 4))
        rng = np.random.default_rng(5)
        batches = [{"ids": rng.integers(0, 50, (8, 4)).astype(np.int32),
                    "x": rng.normal(size=(8, 32)).astype(np.float32),
                    "label": rng.integers(0, 4, (8, 1)).astype(np.int32)}
                   for _ in range(2)]
    elif model == "bank_pipe":
        cfg.batch_size = 32
        cfg.pipeline_stages, cfg.pipeline_microbatches = 2, 4
        ff = ffj.FFModel(cfg)
        embs = []
        for i, v in enumerate(VOCABS[model]):
            s = ff.create_tensor((32, 1), name=f"sparse_{i}", dtype="int32")
            embs.append(ff.embedding(s, v, 16, aggr=AggrMode.AGGR_MODE_SUM,
                                     name=f"emb_{i}"))
        x = ff.concat(embs, axis=1)
        h = x
        for _ in range(4):
            h = ff.dense(h, 64, activation="relu")
        out = ff.softmax(ff.dense(ff.concat([h, x], axis=1), 2))
    else:
        cfg.batch_size, cfg.only_data_parallel = 32, True
        ff = ffj.FFModel(cfg)
        out = build_dlrm(ff, 32, DLRMConfig(
            embedding_size=VOCABS[model], sparse_feature_size=16,
            mlp_bot=(4, 16, 16), mlp_top=(16, 16, 2)))
    opt = ffj.SGDOptimizer(0.05)
    loss = "sparse_categorical_crossentropy"
    ff.compile(opt, loss, [], output_tensor=out)
    if model == "place":
        st = JStrategy.data_parallel(ff.layers, ff.graph_inputs, ff.dmesh)
        st.place_groups = [jbanks.PlaceGroup(["emb", "proj"],
                                             list(ff.dmesh.axis_sizes)[0])]
    else:
        batches = _dlrm_batches(ff, VOCABS[model])
        if model == "bank_pipe":
            st = ff.strategy
            reserved = (st.pipeline.pp_axis,)
        else:
            st = JStrategy.data_parallel(ff.layers, ff.graph_inputs,
                                         ff.dmesh)
            reserved = ()
        emb = [g for g in jbanks.find_bank_groups(ff.layers)
               if g[0].op_type.name == "OP_EMBEDDING"][0]
        axes = jbanks.choose_bank_axes(ff.dmesh, len(emb), reserved)
        st.banks = [jbanks.BankSpec([l.name for l in emb], axes[0],
                                    batch_axes=axes[1],
                                    param_name="__bank0__EMB",
                                    padded=jbanks.group_is_padded(emb))]
    ff.compile(opt, loss, [], output_tensor=out, strategy=st)
    ex = ff.executor
    b0 = batches[0]

    def loss_fn(p):
        outs, _, aux, capture = ex._forward(p, ff.state, b0, True, 0)
        return ex._loss_and_metrics(outs, capture, b0["label"], aux)[0]

    ref = {"params": jax.device_get(ff.params),
           "layers": [(l.name, int(l.op_type)) for l in ff.layers],
           "batches": batches,
           "forward": np.asarray(ex.make_forward()(ff.params, ff.state, {
               k: v for k, v in b0.items() if k != "label"})),
           "grads": jax.device_get(jax.jit(jax.grad(loss_fn))(ff.params))}
    step = ex.make_train_step()
    ref["losses"] = [float(np.asarray(ff._run_train_step(
        step, batches[i % 2])["loss"])) for i in range(STEPS)]
    ref["banks"] = [(list(b.members), len(b.axes)) for b in st.banks]
    return ref


RUNS = [("bank", "dlrm"), ("padded", "dlrm"), ("bank_pipe", "bank_pipe"),
        ("place", "place")]


@pytest.fixture(scope="module")
def refs():
    return {name: _jax_grouped(name) for name, _ in RUNS}


@pytest.fixture(scope="module")
def world(refs):
    return run_world("banks", 4, {
        "runs": [(n, m, n) for n, m in RUNS],
        "refs": {n: {k: refs[n][k] for k in ("params", "layers", "batches")}
                 for n, _ in RUNS},
        "vocabs": VOCABS, "steps": STEPS}, timeout=150)


@pytest.mark.parametrize("name", [n for n, _ in RUNS])
def test_grouped_step_matches_jax(name, refs, world):
    run, ref = world[0][name], refs[name]
    np.testing.assert_allclose(run["forward"], ref["forward"],
                               atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(run["losses"], ref["losses"],
                               atol=LOSS_TOL, rtol=0)
    # both packages name these layers alike; the stacked leaves keep
    # their keys (the bank's param name, ``pp::<template layer>``)
    assert set(run["grads"]) == set(ref["grads"])
    for key, ws in ref["grads"].items():
        for wn, g in ws.items():
            np.testing.assert_allclose(run["grads"][key][wn], np.asarray(g),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"{key}/{wn}")


def test_banked_weights_are_distributed(world):
    """Each rank holds its own members' block of the stacked tables: the
    bank over the 4 ranks puts one table on each; padded to the largest
    vocabulary; beside a pipeline the bank spans the dp axis (2 tables a
    rank)."""
    for r, res in enumerate(world):
        assert res["bank"]["local"] == {"__bank0__EMB": (1, 100, 16)}
        assert res["padded"]["local"] == {"__bank0__EMB": (1, 400, 16)}
        assert res["padded"]["banks"][0][3] is True
        assert res["bank_pipe"]["local"] == {"__bank0__EMB": (2, 400, 16)}
        assert res["bank_pipe"]["region"]["stages"] == 2
        assert res["place"]["local"] == {}
