"""The placement of both mesh axes, ``sharding.specs.shard_plan``,
against the reference's ``param_specs`` and ``train_state_shardings``,
and the round trip whole -> blocks -> whole, on the CPU without a
process group.

The reference places every weight by one rule, "FSDP over 'data' +
tensor-parallel over 'model'" (``repro/sharding/specs.py``); the port's
plan gives each leaf the dimension its spec puts on ``data`` (roles
'server' and 'full'; 'client', a [C, ...] stack, drops it) and on
``model`` where its unit splits: a stage model's ``lin/w`` wherever its
columns divide the axis (``shard_if_divisible`` exactly), a
transformer's unit only on whole heads, experts, hidden columns or
vocab rows (else whole, as ``tests/test_torch_tp.py`` holds), an
attention block's ``wk``/``wv`` with fewer kv heads than ranks on its
group's whole kv head (``kv_replicas``).  Held for
every Engine task (femnist at each cut, resnet9, the LSTM, the MLP) and
every arch (whisper's encoder and decoder halves, the Mamba blocks'
packed leaves cut on whole heads) at its published widths (shapes only: the
reference's ``jax.eval_shape``, the port's shape-only draw), at (1, 2),
(2, 2), (4, 1) and (1, 4), for every rank's coordinates.  The round
trip cuts each rank's blocks from whole weights (femnist width 4, the
archs' smoke configs) and puts them back: exact, every block contiguous.
The gathers over real process groups are held in
``tests/test_torch_engine_tp.py``.
"""
import functools

import jax
import pytest
import torch

from repro.api.phases import init_train_state as j_init_train_state
from repro.api.tasks import build_task as j_build_task
from repro.configs.registry import get_config as j_get_config
from repro.core.split import make_transformer_task as j_make_task
from repro.launch.steps import make_whisper_task as j_make_whisper_task
from repro.optim import adam as j_adam
from repro.sharding import specs as js
from repro.utils.tree import path_str
from repro_torch.api.phases import init_train_state
from repro_torch.api.tasks import build_task
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.core.split import make_transformer_task
from repro_torch.models.module import SHAPES
from repro_torch.optim import adam
from repro_torch.launch.steps import make_whisper_task
from repro_torch.sharding.parallel import (kv_replicas, packed_segments,
                                           rank_segments, sharded_units,
                                           unit_of)
from repro_torch.sharding.specs import Shard, shard_params, shard_plan
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_map)

MESHES = {"(1, 2)": (1, 2), "(2, 2)": (2, 2), "(4, 1)": (4, 1),
          "(1, 4)": (1, 4)}
# the Engine's tasks at each cut the reference places differently
TASK_CUTS = {"image cut 1": ("image", 1), "image cut 2": ("image", 2),
             "image cut 3": ("image", 3), "cifar cut 3": ("cifar", 3),
             "cifar cut 6": ("cifar", 6), "charlm": ("charlm", 2),
             "gaze": ("gaze", 1)}
ARCHS = list_archs()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _sizes(shape):
    return {"data": shape[0], "model": shape[1]}


def _coords(sizes):
    return [{"data": d, "model": m} for d in range(sizes["data"])
            for m in range(sizes["model"])]


def j_spec_map(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {path_str(kp): tuple(s) for kp, s in flat}


def _check(specs: dict, tree, sizes, role, cfg=None):
    """Every rank's plan of ``tree`` against the reference's ``specs``
    (path -> spec tuple).  Returns how many leaves split over each
    axis."""
    units = sharded_units(cfg, sizes)
    lead = 1 if role == "client" else 0
    n = {"model": 0, "data": 0}
    for coords in _coords(sizes):
        plan = shard_plan(tree, sizes, coords, role, cfg)
        for (path, leaf), s in zip(tree_leaves_with_path(tree),
                                   tree_leaves(plan)):
            name = "/".join(str(k) for k in path)
            spec = list(specs[name])[lead:]
            # an axis of one rank splits nothing (the spec keeps its
            # name: every dim divides 1)
            want_d = (spec.index("data") + lead
                      if "data" in spec and sizes["data"] > 1 else None)
            assert s.ddim == want_d, (name, spec, s.ddim)
            want_m = (spec.index("model") + lead
                      if "model" in spec and sizes["model"] > 1 else None)
            unit = unit_of(name)
            if cfg is None or s.dim is not None:
                assert s.dim == want_m, (name, spec, s.dim)
            else:   # a transformer unit that does not split stays whole
                assert want_m is None or not units[unit], (name, spec)
            for dim, lo, hi, ax in ((s.dim, s.lo, s.hi, "model"),
                                    (s.ddim, s.dlo, s.dhi, "data")):
                if dim is None:
                    continue
                per = leaf.shape[dim] // sizes[ax]
                if ax == "model" and s.segs is not None:
                    # a packed Mamba leaf: the rank's whole heads of each
                    # segment, its block their concatenation
                    assert s.segs == rank_segments(packed_segments(
                        cfg, name), sizes[ax], coords[ax]), name
                    per = sum(h - l for l, h, _ in s.segs)
                rep = s.rep if ax == "model" else 1
                if rep > 1:
                    # a kv head held by the rank's group of ``rep``
                    assert rep == kv_replicas(cfg, sizes[ax]), name
                    assert name.endswith(("attn/wk", "attn/wv")), name
                    per = leaf.shape[dim] // (sizes[ax] // rep)
                assert (lo, hi) == (coords[ax] // rep * per,
                                    (coords[ax] // rep + 1) * per), name
                if coords == {"data": 0, "model": 0}:
                    n[ax] += 1
    return n


def _j_state_specs(jstate, mesh):
    """The reference's ``train_state_shardings`` as PartitionSpecs (it
    returns NamedShardings, which need a real mesh)."""
    def field(sub, role):
        return None if sub is None else js.param_specs(sub, mesh, role)
    return type(jstate)(field(jstate.server, "server"),
                        field(jstate.clients, "client"),
                        field(jstate.client_global, "full"))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(TASK_CUTS))
def test_plan_matches_train_state_shardings_for_every_task(name, mesh):
    """The Engine's TrainState (server role 'server', the per-client
    store role 'client', the shared client role 'full'), each leaf of
    the params and the Adam moments, for every rank."""
    task_name, cut = TASK_CUTS[name]
    sizes = _sizes(MESHES[mesh])
    jtask = j_build_task(task_name, 4, 0.5, 0, 4, cut)[0]
    task = build_task(task_name, 4, 0.5, 0, 4, cut)[0]
    splits = {"model": 0, "data": 0}
    for global_client in (False, True):
        jstate = jax.eval_shape(lambda: j_init_train_state(
            jax.random.PRNGKey(0), 4, jtask, j_adam(1e-3), j_adam(1e-3),
            global_client))
        state = init_train_state(0, 4, task, adam(1e-3), adam(1e-3),
                                 global_client)
        want = _j_state_specs(jstate, FakeMesh(sizes))
        for field, role in (("server", "server"), ("clients", "client"),
                            ("client_global", "full")):
            sub = getattr(state, field)
            if sub is None:
                continue
            got = _check(j_spec_map(getattr(want, field)), sub, sizes,
                         role)
            splits = {k: splits[k] + got[k] for k in splits}
    # femnist's lin/w leaves split wherever their dims divide the axes
    if task_name == "image":
        assert (splits["data"] > 0) == (sizes["data"] > 1)
        assert (splits["model"] > 0) == (sizes["model"] > 1)


@functools.lru_cache(maxsize=None)
def _arch_halves(arch):
    """Both packages' halves of the transformer train step at published
    widths, shapes only: {role: (reference tree, port tree)} for the
    server (role 'server'), the client ('full') and a [2, ...] stack of
    clients ('client')."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    if cfg.family == "audio":
        jtask, task = j_make_whisper_task(jcfg), make_whisper_task(cfg)
    else:
        jtask, task = j_make_task(jcfg), make_transformer_task(cfg)
    key = jax.random.PRNGKey(0)
    halves = {"server": (jax.eval_shape(lambda: jtask.init_server(key)),
                         task.init_server(SHAPES)),
              "full": (jax.eval_shape(lambda: jtask.init_client(key)),
                       task.init_client(SHAPES))}
    jc, tc = halves["full"]
    halves["client"] = (
        jax.tree.map(lambda l: jax.ShapeDtypeStruct((2,) + l.shape,
                                                    l.dtype), jc),
        tree_map(lambda t: t.new_empty((2,) + tuple(t.shape)), tc))
    return halves


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_matches_param_specs_for_every_arch(arch, mesh):
    """The transformer train step's halves at published widths: the
    server (role 'server'), the client (role 'full') and a [2, ...]
    stack of clients (role 'client'), for every rank."""
    sizes = _sizes(MESHES[mesh])
    cfg = get_config(arch)
    mode = cfg.moe.shard_mode if cfg.moe is not None else "expert"
    halves = _arch_halves(arch)
    mesh_ = FakeMesh(sizes)
    for role, (jtree, ttree) in halves.items():
        specs = j_spec_map(js.param_specs(jtree, mesh_, role,
                                          moe_shard_mode=mode))
        got = _check(specs, ttree, sizes, role, cfg)
        assert (got["data"] > 0) == (sizes["data"] > 1 and role != "client")


def _round_trip(tree, sizes, role, cfg=None):
    """Every rank's blocks of ``tree`` put back in place: the whole tree,
    exactly; each block contiguous."""
    plans = [shard_plan(tree, sizes, c, role, cfg) for c in _coords(sizes)]
    out = tree_map(torch.full_like, tree, tree_map(lambda t: float("nan"),
                                                   tree))
    for plan in plans:
        blocks = shard_params(tree, plan)
        for o, b, s in zip(tree_leaves(out), tree_leaves(blocks),
                           tree_leaves(plan)):
            assert b.is_contiguous()
            views = [o] if s.dim is None else _model_view(o, s)
            pieces = torch.split(b, [v.shape[s.dim] for v in views],
                                 s.dim) if s.dim is not None else [b]
            for view, piece in zip(views, pieces):
                if s.ddim is not None:
                    view = view.narrow(s.ddim, s.dlo, s.dhi - s.dlo)
                view.copy_(piece)
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def whole_trees():
    """Whole weights of every task's halves (and a [2, ...] stack of the
    client) and of every arch's smoke halves, drawn once: (tree, role,
    cfg) each."""
    gen = torch.Generator().manual_seed(0)
    out = []
    for task_name, cut in TASK_CUTS.values():
        task = build_task(task_name, 4, 0.5, 0, 4, cut)[0]
        out += [(task.init_server(gen), "server", None),
                (task.init_client(gen), "full", None),
                (tree_map(lambda t: torch.stack([t, t + 1]),
                          task.init_client(gen)), "client", None)]
    for arch in ARCHS:
        cfg = smoke_config(arch)
        task = (make_whisper_task(cfg) if cfg.family == "audio"
                else make_transformer_task(cfg))
        out += [(task.init_server(gen), "server", cfg),
                (task.init_client(gen), "full", cfg)]
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_round_trip_is_exact_for_every_task_and_arch(mesh, whole_trees):
    sizes = _sizes(MESHES[mesh])
    for tree, role, cfg in whole_trees:
        _round_trip(tree, sizes, role, cfg)


def _model_view(o, s):
    """The places in whole leaf ``o`` of a block's ``model`` cut: one
    view, or a packed leaf's one a segment."""
    if s.segs is None:
        return [o.narrow(s.dim, s.lo, s.hi - s.lo)]
    return [o.narrow(s.dim, lo, hi - lo) for lo, hi, _ in s.segs]


def test_stacked_shard_is_the_client_roles():
    """A slot's copy of the shared client (role 'full') in a [C, ...]
    stack: the model split one dim on, nothing over ``data``, which is
    the plan of role 'client'."""
    task = build_task("image", 4, 0.5, 0, 4, 3)[0]
    half = task.init_client(SHAPES)
    sizes, coords = {"data": 2, "model": 2}, {"data": 1, "model": 1}
    full = shard_plan(half, sizes, coords, "full")
    stack = shard_plan(tree_map(lambda t: t.new_empty((3,) + t.shape),
                                half), sizes, coords, "client")
    for a, b in zip(tree_leaves(tree_map(Shard.stacked, full)),
                    tree_leaves(stack)):
        assert (a.dim, a.lo, a.hi, a.ddim) == (b.dim, b.lo, b.hi, b.ddim)
    assert any(s.ddim is not None for s in tree_leaves(full))
