"""The port's path-rule specs and mesh geometry, held against
``repro.sharding.specs`` and ``repro.core.feature_store`` on the CPU, and
the mesh's refusals.  No rank is spawned here.

The reference's spec functions read only ``mesh.shape``, so both sides
get a stand-in mesh with that dict.  Shapes come from ``jax.eval_shape``
on the reference side and from the ``meta`` device on the port's (full
configs, grok-1-314b included, never touch memory).  Specs must be
equal, leaf by leaf.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.api.phases import init_train_state as j_init_train_state
from repro.api.tasks import build_task as j_build_task
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import list_archs as j_list_archs
from repro.core.feature_store import shard_slice_indices as j_slice
from repro.models.encdec import EncDec as JEncDec
from repro.models.transformer import Transformer as JTransformer
from repro.optim import adam as j_adam
from repro.sharding import specs as js
from repro.utils.tree import path_str
from repro_torch.api import Engine, ExperimentConfig
from repro_torch.api.phases import init_train_state
from repro_torch.api.tasks import build_task
from repro_torch.configs import get_config, list_archs
from repro_torch.core.feature_store import shard_slice_indices
from repro_torch.core.protocol import init_entity
from repro_torch.models import module as tmodule
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adam
from repro_torch.sharding import specs as ts
from repro_torch.utils.tree import tree_leaves, tree_map


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this process, as in every spawned rank: the
    port's small ops gain nothing from more, and beside the suite's other
    workers more threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class FakeMesh:
    """A stand-in mesh: axis sizes, and a rank's coordinates."""

    def __init__(self, shape, coords=None):
        self.shape = shape
        self.coords = coords or {a: 0 for a in shape}


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          **{f"{n}x1": {"data": n, "model": 1} for n in (1, 2, 4, 8)}}


class MetaGen:
    """A generator stand-in whose draws land on the ``meta`` device."""
    device = torch.device("meta")


@pytest.fixture
def meta_init(monkeypatch):
    """The port's random draws made shape-only, on the meta device, in
    every model module that holds them."""
    import sys
    empty = lambda gen, shape, scale, dtype=torch.float32: torch.empty(
        tuple(shape), dtype=dtype, device="meta")
    draws = {fn: getattr(tmodule, fn) for fn in ("truncated_normal",
                                                 "normal")}
    for name, mod in list(sys.modules.items()):
        if name.startswith("repro_torch.models"):
            for fn, orig in draws.items():
                if getattr(mod, fn, None) is orig:
                    monkeypatch.setattr(mod, fn, empty)


def j_spec_map(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {path_str(kp): tuple(s) for kp, s in flat}


def _t_flat(specs, path=()) -> dict:
    """Spec tuples are leaves here (a plain tuple of axis names)."""
    if isinstance(specs, dict):
        out = {}
        for k in specs:
            out.update(_t_flat(specs[k], path + (k,)))
        return out
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        out = {}
        for k, v in zip(specs._fields, specs):
            out.update(_t_flat(v, path + (k,)))
        return out
    if isinstance(specs, list):
        out = {}
        for i, v in enumerate(specs):
            out.update(_t_flat(v, path + (i,)))
        return out
    if specs is None:
        return {}
    return {"/".join(str(k) for k in path): specs}


def _arch_params(arch):
    jcfg = j_get_config(arch)
    jm = JEncDec if jcfg.family == "audio" else JTransformer
    jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jcfg))
    cfg = get_config(arch)
    tm = EncDec if cfg.family == "audio" else Transformer
    return jp, tm.init(MetaGen(), cfg)


def _stack(jp, tp, n):
    """Both trees with a leading stacked dim of n (the client role)."""
    jst = jax.tree.map(
        lambda l: jax.ShapeDtypeStruct((n,) + l.shape, l.dtype), jp)
    tst = tree_map(lambda t: torch.empty((n,) + tuple(t.shape),
                                         dtype=t.dtype, device="meta"), tp)
    return jst, tst


def _assert_specs_equal(jp, tp, mesh_shape, role, mode="expert"):
    mesh = FakeMesh(mesh_shape)
    want = j_spec_map(js.param_specs(jp, mesh, role, moe_shard_mode=mode))
    got = _t_flat(ts.param_specs(tp, mesh, role, moe_shard_mode=mode))
    assert got == want


def test_arch_registries_match():
    assert sorted(list_archs()) == sorted(j_list_archs())


@pytest.mark.parametrize("arch", sorted(j_list_archs()))
def test_param_specs_match_reference_for_every_arch(arch, meta_init):
    """Roles full/server/client and both MoE modes on every mesh, at the
    published widths."""
    jp, tp = _arch_params(arch)
    jst, tst = _stack(jp, tp, 16)
    for name, shape in MESHES.items():
        for role in ("full", "server"):
            for mode in ("expert", "ffn"):
                _assert_specs_equal(jp, tp, shape, role, mode)
        _assert_specs_equal(jst, tst, shape, "client")


TASK_CUTS = {"image": 2, "cifar": 3, "charlm": 1, "gaze": 2}


@pytest.mark.parametrize("name", sorted(TASK_CUTS))
def test_train_state_shardings_match_reference_for_every_task(name):
    """The TrainState spec tree of each task (server, the [N, ...]
    per-client store, the shared client) on every mesh, with the cohort
    sharded and not."""
    cut, n = TASK_CUTS[name], 16
    jtask = j_build_task(name, 4, 0.5, 0, 32, cut)[0]
    task = build_task(name, 4, 0.5, 0, 32, cut)[0]
    for global_client in (False, True):
        jstate = jax.eval_shape(lambda: j_init_train_state(
            jax.random.PRNGKey(0), n, jtask, j_adam(1e-3), j_adam(1e-3),
            global_client))
        state = init_train_state(0, n, task, adam(1e-3), adam(1e-3),
                                 global_client)
        for shape in MESHES.values():
            mesh = FakeMesh(shape)
            for shard in (True, False):
                want = j_spec_map(_j_state_specs(jstate, mesh, shard))
                got = _t_flat(ts.train_state_shardings(
                    state, mesh, shard_cohort=shard))
                assert got == want


def _j_state_specs(jstate, mesh, shard):
    """The reference's ``train_state_shardings`` as PartitionSpecs (it
    returns NamedShardings, which need a real mesh)."""
    def field(sub, role):
        return None if sub is None else js.param_specs(sub, mesh, role)
    return type(jstate)(field(jstate.server, "server"),
                        field(jstate.clients,
                              "client" if shard else "full"),
                        field(jstate.client_global, "full"))


def test_optimizer_state_inherits_param_specs(meta_init):
    cfg = get_config("phi3-mini-3.8b")
    ent = init_entity(Transformer.init(MetaGen(), cfg), adam(1e-3))
    m = _t_flat(ts.param_specs(ent, FakeMesh(MESHES["16x16"]), "server"))
    assert m["opt_state/m/blocks/attn/wq"] == m["params/blocks/attn/wq"]
    assert m["params/blocks/attn/wq"] == (None, "data", "model")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_geometry_matches_reference(name):
    """shard_if_divisible, batch_spec, pool_shard_info, pool_slice_spec,
    cohort_shard_axes and shard_aligned_capacity on every mesh over a
    sweep of sizes."""
    mesh = FakeMesh(MESHES[name])
    for n in list(range(1, 70)) + [96, 128, 256, 512, 1000, 1024]:
        for axis in (None, "data", "model", "pod", ("pod", "data")):
            assert ts.shard_if_divisible(n, axis, mesh) == \
                js.shard_if_divisible(n, axis, mesh)
        for extra in (0, 1, 3):
            assert ts.batch_spec(mesh, n, extra) == \
                tuple(js.batch_spec(mesh, n, extra))
        assert ts.pool_shard_info(mesh, n) == js.pool_shard_info(mesh, n)
        for ndim in (1, 2, 4):
            want = js.pool_slice_spec(mesh, n, ndim)
            assert ts.pool_slice_spec(mesh, n, ndim) == (
                None if want is None else tuple(want))
        assert ts.cohort_shard_axes(mesh, n) == js.cohort_shard_axes(mesh, n)
        assert ts.shard_aligned_capacity(mesh, n) == \
            js.shard_aligned_capacity(mesh, n)
    assert ts.pool_shard_info(None, 8) is None
    assert ts.shard_aligned_capacity(None, 5) == 5


@pytest.mark.parametrize("name", ["2x16x16", "4x1", "8x1"])
def test_local_slots_partition_the_cohort(name):
    """Over every rank's coordinates the slot ranges tile [0, C) in rank
    order, or are whole where ``cohort_shard_axes`` says the dim does
    not shard; the store's rows follow the client role's spec."""
    shape = MESHES[name]
    axes = [a for a in ("pod", "data") if a in shape]
    coords = [dict(zip(axes, c)) for c in np.ndindex(*[shape[a]
                                                       for a in axes])]
    for n in (1, 5, 8, 12, 32, 48, 64, 100, 128):
        got = [ts.local_slots(FakeMesh(shape, {**c, "model": 0}), n)
               for c in coords]
        spec = js.cohort_shard_axes(FakeMesh(shape), n)
        if spec is None:
            assert all(r == (0, n) for r in got)
        else:
            size = int(np.prod([shape[a] for a in spec]))
            assert len(set(got)) == size
            assert sorted(set(got)) == [(i * n // size, (i + 1) * n // size)
                                        for i in range(size)]
        lead = js.param_specs(
            {"step": jax.ShapeDtypeStruct((n,), np.int32)},
            FakeMesh(shape), "client")["step"][0]
        rows = [ts.store_rows(FakeMesh(shape, {**c, "model": 0}), n)
                for c in coords]
        if lead is None:
            assert all(r == (0, n) for r in rows)
        else:
            lead = lead if isinstance(lead, tuple) else (lead,)
            size = int(np.prod([shape[a] for a in lead]))
            assert sorted(set(rows)) == [(i * n // size, (i + 1) * n // size)
                                         for i in range(size)]
        assert ts.store_rows(FakeMesh(shape), n, shard_cohort=False) == (0, n)


def test_shard_slice_indices_match_reference():
    rng = np.random.default_rng(3)
    for T, n in ((64, 4), (96, 8), (10, 1), (48, 2)):
        rows = T // n
        idx = rng.integers(0, T, size=37).astype(np.int32)
        oks = []
        for s in range(n):
            jl, jok = j_slice(jax.numpy.asarray(idx), s, rows)
            tl, tok = shard_slice_indices(torch.from_numpy(idx), s, rows)
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
            assert tl.dtype == torch.int32
            oks.append(tok.numpy())
        # the masks partition the gather: one owner a row
        np.testing.assert_array_equal(np.sum(oks, axis=0), 1)


# ------------------------------------------------------------ refusals
def test_mesh_engine_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = ExperimentConfig(mesh_shape=(1, 1), n_clients=10, attendance=0.3)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg)


def test_cuda_mesh_wider_than_the_cards_raises(monkeypatch):
    from repro_torch.launch import mesh as lmesh
    monkeypatch.setattr(lmesh, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL refuses"):
        lmesh.make_engine_mesh((2, 1), ("data", "model"), "cuda")


@pytest.mark.parametrize("shape,axes", [((1, 2), ("data", "model")),
                                        ((1, 1, 4), ("pod", "data",
                                                     "model"))])
def test_model_axis_raises_naming_9b(shape, axes):
    """The mesh takes a model axis (here it asks for the world of ranks it
    needs), and the Engine's config takes one too: item 9b's first
    two parts (the model axis, FSDP over data) are ported."""
    from repro_torch.launch.mesh import make_engine_mesh
    with pytest.raises(RuntimeError, match="torchrun"):
        make_engine_mesh(shape, axes, "cpu")
    cfg = ExperimentConfig(mesh_shape=shape, mesh_axes=axes)
    assert cfg.validate() is cfg


MESH_WITH = {"pipeline": dict(pipeline_depth=1),
             "resilience": dict(resilience={"guard": True}),
             "ckpt": dict(ckpt_dir="ckpt"),
             "scenario": dict(scenario={"kind": "diurnal-churn"}),
             "serve": dict(serve={"slots": 4})}


@pytest.mark.parametrize("kw", list(MESH_WITH.values()), ids=list(MESH_WITH))
def test_mesh_with_an_unported_path_raises_naming_9b(kw, tmp_path):
    """Each path item 9b had left runs on a mesh now: the Engine builds on
    a (1, 1) mesh and runs one round (a serve config, which training
    ignores, only builds)."""
    d = {**ExperimentConfig().to_dict(), "mesh_shape": (1, 1),
         "n_clients": 10, "attendance": 0.3, "batch": 8, "width": 4,
         "rounds": 1, "eval_every": 1}
    for k, v in kw.items():
        d[k] = {**d[k], **v} if isinstance(v, dict) else v
    if "ckpt_dir" in kw:
        d["ckpt_dir"] = str(tmp_path / "ckpt")
    eng = Engine(ExperimentConfig.from_dict(d), device="cpu",
                 log=lambda *a: None)
    try:
        assert eng.mesh.shape == {"data": 1, "model": 1}
        if "serve" in kw:
            assert eng.cfg.serve.slots == 4
            return
        res = eng.run()
    finally:
        eng.close()
    assert res["history"][-1]["round"] == 1
    if "ckpt_dir" in kw:
        assert os.path.isdir(os.path.join(d["ckpt_dir"], "step_1"))


def test_mesh_shape_must_be_the_world_size():
    """A world of one started by the first mesh; a (2, 1) mesh over it
    raises, and no mesh starts a world of two on its own."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (cohort_size, make_engine_mesh,
                                         make_local_mesh)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_engine_mesh((2, 1), ("data", "model"), "cpu")
    assert not dist.is_initialized()
    mesh = make_local_mesh("cpu")
    try:
        assert mesh.shape == {"data": 1, "model": 1} and cohort_size(mesh) == 1
        with pytest.raises(ValueError, match="process group 1"):
            make_engine_mesh((2, 1), ("data", "model"), "cpu")
    finally:
        mesh.close()
    assert not dist.is_initialized()


def test_shard_local_resample_off_mesh_is_inert():
    """The knob runs off the mesh and changes nothing, bit for bit."""
    base = dict(rounds=2, eval_every=2, n_clients=10, attendance=0.3,
                batch=8, width=4, variable_attendance=True, seed=1)
    out = []
    for on in (False, True):
        rows, fin = [], []

        class Rec:
            def on_round(self, engine, rnd, state, metrics):
                rows.append({k: float(v) for k, v in metrics.items()})
                fin[:] = [state]

        cfg = ExperimentConfig(**base).with_cycle(shard_local_resample=on)
        Engine(cfg, device="cpu", callbacks=[Rec()],
               log=lambda *a: None).run()
        out.append((rows, fin[0]))
    assert out[0][0] == out[1][0]
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("axes", [("x", "y"), ("model", "pod")])
def test_mesh_without_a_data_axis_raises(axes):
    from repro_torch.launch.mesh import make_engine_mesh
    with pytest.raises(ValueError, match="expected 'data'"):
        make_engine_mesh((1, 1), axes, "cpu")
