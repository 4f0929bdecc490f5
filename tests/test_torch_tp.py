"""The transformer train and prefill steps on a mesh's ``model`` axis, on
the CPU over gloo.

The reference's model axis is GSPMD's (``param_specs`` shardings, XLA's
collectives), and its mesh path does not run in this JAX (its meshes
build Explicit axes, which ``with_sharding_constraint`` refuses).  So
the port's tensor- and expert-parallel steps are held to the port's
unsharded steps, and one of them also directly to the reference's
unsharded ``cyclesl_round`` on carried weights and plans:

- the whole-unit rule and the shard plans for every registry config at
  its published shapes (shape-only, on the meta device), and the
  shard/gather round trip at each config's smoke width, without a
  process group;
- a (1, 1) mesh in this process: bit for bit the unsharded train round
  and prefill;
- one spawned world of 2 on (1, 2) (olmoe smoke): loss and every
  gathered leaf gradient within 1e-5 of the leaf's scale, the f32
  prefill logits likewise, the round's metrics within rtol 1e-5 and its
  state under the Adam near-sign rule, the same on every rank, the
  census exactly as counted below, and metrics and state against the
  reference's round (rtol 1e-4, the same Adam rule);
- one spawned world of 4: olmoe on (2, 2), the cohort split over
  ``data`` too, and glm4 on (1, 4), whose ``n_kv_heads`` 2 < 4 splits
  the attention over kv head groups (one query head a rank, each kv
  head held by a group of 2; ``tests/test_torch_kv_groups.py`` holds
  the groups' own checks) while the FFN and the vocab split.

Adam's near-sign rule (``tests/test_torch_steps.py``, ``chip_smoke.py``
``compare_runs``): a first Adam step moves a weight by about lr *
sign(g), so a weight whose gradient is tiny may move by another
fraction of lr when the sums run in another order; all but 0.1% of a
leaf is held to 1e-6 and every weight to the 2 * lr * steps that such
steps can move it at most.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import cyclesl as jc
from repro.core import protocol as jp
from repro.core.feature_store import resample_plan as j_plan
from repro.core.split import make_transformer_task as j_make_task
from repro.optim import adam as j_adam
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.core.cyclesl import _value_and_grad
from repro_torch.core.split import make_transformer_task
from repro_torch.launch import inputs as t_inputs
from repro_torch.launch.mesh import make_engine_mesh, make_local_mesh
from repro_torch.launch.meshcheck import spawn_ranks
from repro_torch.launch.steps import build_prefill_step, build_train_step
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import Transformer
from repro_torch.sharding.parallel import (kv_replicas, packed_segments,
                                           sharded_units, unit_of)
from repro_torch.sharding.specs import (gather_params, param_specs,
                                        shard_params, shard_plan)
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_map)
from repro_torch.utils.weights import (entity_from_reference, from_shards,
                                       to_numpy, to_shards)

import torch_tp_ranks as ranks

LR, C, ROUNDS = 3e-4, ranks.C, 1
SHAPE, PREFILL = ranks.SHAPE, ranks.PREFILL
GRAD_SEED, PREFILL_SEED = 7, 3
# arch, depth; gemma2 is not among them (its smoke cut leaves the
# server no block at depth 2), glm4 is the dense family's case
OLMOE, GLM4 = ("olmoe-1b-7b", 2), ("glm4-9b", 2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here, as in every spawned rank."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------- the whole-unit rule
class MetaGen:
    """A generator stand-in whose draws land on the ``meta`` device."""
    device = torch.device("meta")


@pytest.fixture
def meta_init(monkeypatch):
    """The port's random draws made shape-only, on the meta device."""
    from repro_torch.models import module as tmodule
    empty = lambda gen, shape, scale, dtype=torch.float32: torch.empty(
        tuple(shape), dtype=dtype, device="meta")
    draws = {fn: getattr(tmodule, fn) for fn in ("truncated_normal",
                                                 "normal")}
    for name, mod in list(sys.modules.items()):
        if name.startswith("repro_torch.models"):
            for fn, orig in draws.items():
                if getattr(mod, fn, None) is orig:
                    monkeypatch.setattr(mod, fn, empty)


class _Sizes:
    def __init__(self, m):
        self.shape = {"data": 1, "model": m}


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("arch", list_archs())
def test_whole_unit_rule_and_plan_at_published_shapes(arch, m, meta_init):
    """Every leaf a plan splits belongs to a unit the rule splits, sits
    where the reference's spec puts the ``model`` axis, and gives the
    rank (the last one here) its 1/m on whole heads, experts, columns or
    vocab rows, or, where the attention splits over kv head groups
    (``kv_replicas``), its group's whole kv head of ``wk`` and ``wv``;
    every other leaf stays whole.  A Mamba block's packed
    ``w_in`` and ``conv_w`` give the rank whole heads of ``z``, ``x``
    and ``dt`` and all of ``B`` and ``C`` (one group), in that order."""
    cfg = get_config(arch)
    sizes = {"data": 1, "model": m}
    units = sharded_units(cfg, sizes)
    params = (EncDec if cfg.family == "audio" else Transformer).init(
        MetaGen(), cfg)
    plan = shard_plan(params, sizes, {"data": 0, "model": m - 1}, "full",
                      cfg)
    specs = param_specs(params, _Sizes(m), "full", cfg.moe.shard_mode
                        if cfg.moe is not None else "expert")
    n_split = 0
    for (path, leaf), s, spec in zip(
            tree_leaves_with_path(params), tree_leaves(plan),
            _spec_leaves(specs)):
        name = "/".join(str(k) for k in path)
        unit = unit_of(name)
        if s.dim is None:
            assert unit is None or not units[unit], name
            continue
        n_split += 1
        assert units[unit] and spec[s.dim] == "model", (name, spec)
        if s.segs is not None:
            _assert_whole_heads(cfg, name, s, m)
            continue
        assert packed_segments(cfg, name) is None, name
        rep = kv_replicas(cfg, m) if name.endswith(("attn/wk", "attn/wv")) \
            else 1
        per = leaf.shape[s.dim] // (m // rep)
        g = (m - 1) // rep
        assert s.rep == rep and (s.lo, s.hi) == (g * per, (g + 1) * per), \
            name
        if rep > 1:                      # the group's one whole kv head
            assert per == cfg.hd, name
    assert (n_split > 0) == (m > 1 and any(units.values()))
    if arch == "glm4-9b" and m == 4:
        assert units["attn"] and units["ffn"] and units["vocab"]
    if arch == "olmoe-1b-7b" and m == 4:
        assert units["attn"] and units["moe"] and units["vocab"]
        assert cfg.n_heads // m == 4 and cfg.moe.n_experts // m == 16
    if cfg.family in ("ssm", "hybrid") and m > 1:
        assert units["mamba"] and units["vocab"]
        assert units["attn"] == units["ffn"] == (cfg.family == "hybrid")
    if cfg.family == "audio" and m > 1:
        assert units["attn"] and units["ffn"] and units["vocab"]


def _assert_whole_heads(cfg, name, s, m):
    """A packed Mamba leaf's shard on the last of ``m`` ranks: ``w_in``'s
    ``z``, ``x`` and ``dt`` and ``conv_w``'s ``x`` the rank's whole SSD
    heads, ``B`` and ``C`` (one group) whole, each segment in place."""
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    H, gn = d_inner // ssm.head_dim, ssm.n_groups * ssm.d_state
    r = m - 1
    heads = (r * d_inner // m, (r + 1) * d_inner // m, True)
    bc = ((2 * d_inner, 2 * d_inner + gn, False),
          (2 * d_inner + gn, 2 * d_inner + 2 * gn, False))
    if name.endswith("w_in"):
        want = ((heads[0], heads[1], True),
                (d_inner + heads[0], d_inner + heads[1], True)) + bc + (
            (2 * d_inner + 2 * gn + r * H // m,
             2 * d_inner + 2 * gn + (r + 1) * H // m, True),)
    else:
        want = (heads,) + tuple((lo - d_inner, hi - d_inner, f)
                                for lo, hi, f in bc)
    assert ssm.n_groups == 1 and s.segs == want, (name, s.segs)
    assert (heads[1] - heads[0]) % ssm.head_dim == 0
    local = sum(hi - lo for lo, hi, _ in want)
    assert (s.lo, s.hi) == (r * local, (r + 1) * local), name


def _spec_leaves(specs) -> list:
    """A spec tree's leaves (each spec is a tuple, so walk dicts only)."""
    if isinstance(specs, dict):
        return [l for k in sorted(specs) for l in _spec_leaves(specs[k])]
    return [specs]


class FakeModelComm:
    """``all_gather`` over every rank's shards at once, in one process:
    the leaf is found by storage among this rank's shards."""

    def __init__(self, shards, plans, rank):
        self.shards, self.plans, self.rank = shards, plans, rank
        self.size = len(shards)

    def all_gather(self, t, what):
        mine = tree_leaves(self.shards[self.rank])
        i = next(i for i, x in enumerate(mine)
                 if x.data_ptr() == t.data_ptr())
        dim = tree_leaves(self.plans[self.rank])[i].dim
        return torch.cat([tree_leaves(s)[i].movedim(dim, 0)
                          for s in self.shards])


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", list_archs())
def test_shard_and_gather_round_trip_at_smoke_width(arch, m):
    cfg = smoke_config(arch)
    sizes = {"data": 1, "model": m}
    full = (EncDec if cfg.family == "audio" else Transformer).init(
        torch.Generator().manual_seed(0), cfg)
    stacked = tree_map(lambda t: torch.stack([t, t + 1]), full)
    for tree, role in ((full, "full"), (stacked, "client")):
        plans = [shard_plan(tree, sizes, {"model": r}, role, cfg)
                 for r in range(m)]
        shards = [shard_params(tree, p) for p in plans]
        for r, s in enumerate(shards):
            assert all(t.is_contiguous() for t in tree_leaves(s))
            # the plan read back from the shards themselves
            again = shard_plan(s, sizes, {"model": r}, role, cfg,
                               local=True)
            assert [(p.dim, p.lo, p.hi) for p in tree_leaves(again)] == [
                (p.dim, p.lo, p.hi) for p in tree_leaves(plans[r])]
        for r in range(m):
            back = gather_params(shards[r], plans[r],
                                 FakeModelComm(shards, plans, r))
            for a, b in zip(tree_leaves(tree), tree_leaves(back)):
                assert torch.equal(a, b)
        # the same through the carry helpers, numpy in and out
        carried = [to_shards(to_numpy(tree), p) for p in plans]
        back = from_shards(carried[0], plans[0],
                           FakeModelComm(carried, plans, 0))
        for a, b in zip(tree_leaves(tree), tree_leaves(back)):
            np.testing.assert_array_equal(a.numpy(), b)


# ------------------------------------------------------ carried states
def _reference_init(arch, depth):
    """The reference's init (both halves, carried) and its plans, and a
    function that runs its ROUNDS rounds from them: (port state0, plans,
    rounds() -> (JAX rows, JAX final state))."""
    jcfg = j_smoke(arch).with_(n_layers=depth)
    jtask, jopt = j_make_task(jcfg), j_adam(LR)
    jserver = jp.init_entity(jtask.init_server(jax.random.PRNGKey(0)), jopt)
    jclients = jp.broadcast_entity(
        jp.init_entity(jtask.init_client(jax.random.PRNGKey(1)), jopt), C)
    state0 = (entity_from_reference(jax.device_get(jserver)),
              entity_from_reference(jax.device_get(jclients)))
    jkeys = [jax.random.PRNGKey(10 + r) for r in range(ROUNDS)]
    plans = {r: (torch.from_numpy(np.array(j_plan(jkeys[r], C * 2, 1, 2))),
                 None) for r in range(ROUNDS)}

    def rounds():
        step = jax.jit(lambda s, c, xs, ys, key: jc.cyclesl_round(
            jtask, s, c, jopt, jopt, xs, ys, key, jc.CycleConfig()))
        tcfg = ranks.config(arch, depth)
        srv, cl, rows = jserver, jclients, []
        for r in range(ROUNDS):
            xs, ys = t_inputs.make_train_batch(tcfg, SHAPE, C, r)
            srv, cl, jm = step(srv, cl, {"tokens": jnp.asarray(xs["tokens"])},
                               jnp.asarray(ys), jkeys[r])
            rows.append({k: float(v) for k, v in jm.items()})
        return rows, jax.device_get((srv, cl))
    return state0, plans, rounds


def _reference_round(arch, depth):
    """The reference's init (both halves, carried), its plans and its
    ROUNDS rounds: (port state0, plans, JAX rows, JAX final state)."""
    state0, plans, rounds = _reference_init(arch, depth)
    return (state0, plans, *rounds())


def _port_init(arch, depth):
    """The port's own init and plan for a case held to the port only."""
    cfg = ranks.config(arch, depth)
    from repro_torch.core.feature_store import resample_plan
    state0 = build_train_step(cfg, SHAPE, cohort=C, device="cpu"
                              ).init_state(0)
    plans = {r: (resample_plan(r, C * 2, 1, 2), None) for r in range(ROUNDS)}
    return state0, plans


def _unsharded(arch, depth, state0, plans):
    """The port's unsharded steps on the same inputs as the ranks'."""
    cfg = ranks.config(arch, depth)
    bundle = build_train_step(cfg, SHAPE, cohort=C, device="cpu",
                              plan_fn=ranks.FixedPlans(plans))
    s, c = state0
    rows = []
    for r in range(ROUNDS):
        xs, ys = bundle.make_batch(r)
        s, c, m = bundle.fn(s, c, xs, ys, r)
        rows.append({k: float(v) for k, v in m.items()})
    task = make_transformer_task(cfg)
    client = tree_map(lambda t: t[0], state0[1].params)
    xs, ys = bundle.make_batch(GRAD_SEED)
    loss, gr = _value_and_grad(lambda p: task.e2e_loss(
        p[0], p[1], {"tokens": xs["tokens"][0]}, ys[0]),
        (client, state0[0].params))
    pf = build_prefill_step(cfg, PREFILL, device="cpu")
    (params,), (batch,) = pf.init_state(PREFILL_SEED), pf.make_batch(
        PREFILL_SEED)
    with torch.no_grad():
        logits, _ = Transformer.forward(params, cfg, batch["tokens"])
    return {"rows": rows, "state": to_numpy((s, c)), "loss": float(loss),
            "grads": to_numpy(gr),
            "prefill": {"step": pf.fn(params, batch).float(),
                        "f32": logits[:, -1]}}


@pytest.fixture(scope="module")
def olmoe_carried():
    return _reference_round(*OLMOE)


@pytest.fixture(scope="module")
def world2(olmoe_carried, tmp_path_factory):
    state0, plans, _, _ = olmoe_carried
    return spawn_ranks(2, ranks.world, ({"olmoe (1, 2)": (None, (
        *OLMOE, state0, plans, ROUNDS, GRAD_SEED, PREFILL_SEED))},),
        workdir=tmp_path_factory.mktemp("tp2"), shape=(1, 2))


@pytest.fixture(scope="module")
def world4(olmoe_carried, tmp_path_factory):
    state0, plans, _, _ = olmoe_carried
    g_state0, g_plans = _port_init(*GLM4)
    return spawn_ranks(4, ranks.world, ({
        "olmoe (2, 2)": (None, (*OLMOE, state0, plans, ROUNDS, GRAD_SEED,
                                PREFILL_SEED)),
        "glm4 (1, 4)": ((1, 4), (*GLM4, g_state0, g_plans, ROUNDS,
                                 GRAD_SEED, PREFILL_SEED))},),
        workdir=tmp_path_factory.mktemp("tp4"), shape=(2, 2))


@pytest.fixture(scope="module")
def unsharded(olmoe_carried):
    state0, plans, _, _ = olmoe_carried
    return {"olmoe": _unsharded(*OLMOE, state0, plans),
            "glm4": _unsharded(*GLM4, *_port_init(*GLM4))}


# name: (spawned world, arch, model axis, cohort slots a rank)
CASES = {"olmoe (1, 2)": ("world2", "olmoe", 2, C),
         "olmoe (2, 2)": ("world4", "olmoe", 2, 1),
         "glm4 (1, 4)": ("world4", "glm4", 4, C)}


def _case(request, name):
    world, arch, _, _ = CASES[name]
    return request.getfixturevalue(world), arch


def _assert_adam_close(want, got, steps):
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
        if not d.size:
            continue
        assert d.max() <= 2 * LR * steps + 1e-6, d.max()
        assert (d > 1e-6).mean() <= 1e-3, (d > 1e-6).mean()


def _assert_rows_close(want_rows, got_rows, rtol):
    for want, got in zip(want_rows, got_rows):
        assert set(want) == set(got)
        for k in want:
            # the std of C = 2 near-equal norms is their half difference:
            # its error is the norms', measured against their mean
            scale = max(abs(want[k]), want["feat_grad_norm_mean"]
                        if k == "feat_grad_norm_std" else 0.0)
            assert abs(got[k] - want[k]) <= rtol * scale, (k, got[k], want[k])


# ------------------------------------------------------------- (1, 1)
def test_one_by_one_mesh_is_bit_for_bit_unsharded():
    """A (1, 1) mesh through the model-axis code: the train round and the
    prefill give the unsharded bits, and no collective runs."""
    cfg = ranks.config(*OLMOE)
    mesh = make_local_mesh("cpu")
    try:
        runs = {}
        for name, kw in (("unsharded", {}), ("mesh", {"mesh": mesh})):
            bundle = build_train_step(cfg, SHAPE, cohort=C, device="cpu",
                                      **kw)
            s, c = bundle.init_state(0)
            for r in range(2):
                s, c, m = bundle.fn(s, c, *bundle.make_batch(r), r)
            pf = build_prefill_step(cfg, PREFILL, device="cpu", **kw)
            logits = pf.fn(*pf.init_state(1), *pf.make_batch(1))
            runs[name] = tree_leaves((s, c, m, logits))
        assert all(torch.equal(a, b) for a, b in zip(*runs.values()))
        assert mesh.model_comm.take_census() == {}
        assert mesh.comm.take_census() == {}
    finally:
        mesh.close()


def test_mesh_without_a_model_axis_has_no_model_group():
    """A ('data',) mesh builds no model group (``model_comm`` None) and
    its train round and prefill give the unsharded bits."""
    cfg = ranks.config(*OLMOE)
    mesh = make_engine_mesh((1,), ("data",), "cpu")
    try:
        assert mesh.model_comm is None
        runs = {}
        for name, kw in (("unsharded", {}), ("mesh", {"mesh": mesh})):
            bundle = build_train_step(cfg, SHAPE, cohort=C, device="cpu",
                                      **kw)
            s, c, m = bundle.fn(*bundle.init_state(0), *bundle.make_batch(0),
                                0)
            pf = build_prefill_step(cfg, PREFILL, device="cpu", **kw)
            logits = pf.fn(*pf.init_state(1), *pf.make_batch(1))
            runs[name] = tree_leaves((s, c, m, logits))
        assert all(torch.equal(a, b) for a, b in zip(*runs.values()))
        assert mesh.comm.take_census() == {}
    finally:
        mesh.close()


# ------------------------------------------------------- spawned worlds
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_unsharded(name, request, unsharded):
    """Loss, and every leaf's gradient gathered whole (the router, the
    norms, the embedding and ``lm_head`` included), within 1e-5 of the
    unsharded port's (relative to the leaf's largest entry)."""
    world, arch = _case(request, name)
    got, want = world[0][name], unsharded[arch]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    for (path, a), b in zip(tree_leaves_with_path(want["grads"]),
                            tree_leaves(got["grads"])):
        assert a.shape == b.shape, path
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), path


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_logits_match_unsharded(name, request, unsharded):
    """The f32 forward's last-position logits within 1e-5 of their
    scale; the step's bf16 logits within one bf16 rounding."""
    world, arch = _case(request, name)
    got, want = world[0][name]["prefill"], unsharded[arch]["prefill"]
    scale = float(want["f32"].abs().max())
    assert float((got["f32"] - want["f32"]).abs().max()) <= 1e-5 * scale
    torch.testing.assert_close(got["step"], want["step"], rtol=8e-3,
                               atol=1e-3)


@pytest.mark.parametrize("name", list(CASES))
def test_round_matches_unsharded(name, request, unsharded):
    """Metrics within rtol 1e-5, the state gathered whole under the Adam
    near-sign rule (server: 2 steps a round; clients: 1)."""
    world, arch = _case(request, name)
    got, want = world[0][name], unsharded[arch]
    _assert_rows_close(want["rows"], got["rows"], 1e-5)
    _assert_adam_close(want["state"][0], got["state"][0], 2 * ROUNDS)
    _assert_adam_close(want["state"][1], got["state"][1], 2 * ROUNDS)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_holds_the_same_round(name, request):
    world, _ = _case(request, name)
    first = world[0][name]
    for other in world[1:]:
        assert other[name]["rows"] == first["rows"]
        assert other[name]["digest"] == first["digest"]


def _model_calls(cfg, units, c_local, steps=2, chunks=1) -> dict:
    """The ``model`` axis' calls in one round, by census key.  A block
    pass forward reduces its split attention and FFN or MoE once each;
    backward, each split unit's input gradient (``copy_to_model``) once.
    The client blocks run forward in the extract and in each slot's VJP
    (backward there), the server blocks forward and backward in each
    server step and each slot's feature gradient.  Each block is a group
    under ``module.remat``, so each backward pass first runs its forward
    again, up to its last op that saves a tensor: the attention's reduce
    and the MoE's (its router losses follow it) are issued again, a
    dense FFN's closing reduce is not (only the residual add follows it,
    unless a sandwich norm does).  A split vocab adds the embedding's
    reduce to each client forward and, to each server forward, a logits
    gather (again in each chunk's recompute) and (backward) the head
    input's reduce per 512-position chunk; a split client half adds one
    norm reduce a slot."""
    calls: dict = {}

    def add(key, n):
        if n:
            calls[f"model/{key}"] = calls.get(f"model/{key}", 0) + n
    cut, L = cfg.cut_layers, cfg.n_layers
    ffn = "moe" if cfg.moe is not None else "ffn"
    fwd = 2 * c_local * cut + (steps + c_local) * (L - cut)
    bwd = c_local * cut + (steps + c_local) * (L - cut)
    again = {"attn": True, "moe": True, "ffn": cfg.sandwich_norm}
    for unit, grad in (("attn", "act_grad"), (ffn, "moe_grad"
                                              if ffn == "moe"
                                              else "act_grad")):
        if units[unit]:
            add(f"all_reduce/{unit}", fwd + (bwd if again[unit] else 0))
            add(f"all_reduce/{grad}", bwd)
    if units["vocab"]:
        add("all_reduce/embed", 2 * c_local)
        add("all_gather/logits", 2 * chunks * (steps + c_local))
        add("all_reduce/act_grad", chunks * (steps + c_local))
    if any(units.values()):
        add("all_reduce/grad_norm", c_local)
    return calls


@pytest.mark.parametrize("name", list(CASES))
def test_census_of_a_round_is_as_counted(name, request):
    """The model axis' calls in every round as :func:`_model_calls`
    counts them, and on (1, 2) the bytes too: each reduce or gather of
    a [b, S, d] or [b, S, vocab / 2] float32 activation is 2 * 32 * 256
    * 4 = 65536 bytes; an attention block's input gradient also carries
    the q and k norms' two 64-wide scales (66048), the MoE's the
    combine weights [1, 64 * 2] (66048); a norm is one float.  The
    attention and MoE reduces and the logits gathers count their
    recomputes' too (8 forward, 6 again in a backward)."""
    world, arch = _case(request, name)
    _, _, m, c_local = CASES[name]
    cfg = ranks.config(*(OLMOE if arch == "olmoe" else GLM4))
    units = sharded_units(cfg, {"model": m})
    for rank in world:
        for census in rank[name]["census"]:
            got = {k: v["calls"] for k, v in census.items()
                   if k.startswith("model/")}
            assert got == _model_calls(cfg, units, c_local)
    if name == "olmoe (1, 2)":
        act = 65536
        want = {"embed": 4 * act, "attn": 14 * act, "moe": 14 * act,
                "act_grad": 6 * (act + 512) + 4 * act,
                "moe_grad": 6 * (act + 512), "grad_norm": 2 * 4}
        got = world[0][name]["census"][0]
        assert got["model/all_gather/logits"]["bytes"] == 8 * act
        assert {k.split("/")[-1]: v["bytes"] for k, v in got.items()
                if k.startswith("model/all_reduce")} == want
        # the batch axes hold one rank: no batch collective runs
        assert not any(not k.startswith("model/") for k in got)


def test_mesh_groups_on_four_ranks(world4):
    """On (2, 2) and on ('pod', 'data', 'model') = (2, 1, 2) the batch
    group holds the ranks of one model coordinate and the model group
    the ranks of one batch coordinate (row-major: rank = batch * 2 +
    model); with the model axis first, ('model', 'pod', 'data') = (2,
    2, 1), rank = model * 2 + pod, and the groups follow the axes, not
    the rank order: sums of the world ranks in each."""
    last = {0: (2, 1), 1: (4, 1), 2: (2, 5), 3: (4, 5)}
    first = {0: (1, 2), 1: (1, 4), 2: (5, 2), 3: (5, 4)}
    for r, res in enumerate(world4):
        assert sorted(res["groups"]) == ["data,model", "model,pod,data",
                                         "pod,data,model"]
        for name, got in res["groups"].items():
            want, (b, mr) = ((first[r], (r % 2, r // 2))
                             if name.startswith("model") else
                             (last[r], (r // 2, r % 2)))
            assert (got["batch"][0], got["model"][0]) == want, name
            assert got["batch"][1:] == (b, 2), name
            assert got["model"][1:] == (mr, 2), name


def test_one_by_two_round_matches_reference(world2, olmoe_carried):
    """The (1, 2) round against the reference's unsharded round on the
    carried weights and plan: metrics within rtol 1e-4, the state
    gathered whole under the Adam near-sign rule."""
    _, _, j_rows, (jserver, jclients) = olmoe_carried
    got = world2[0]["olmoe (1, 2)"]
    _assert_rows_close(j_rows, got["rows"], 1e-4)
    srv, cl = got["state"]
    for j_e, t_e, steps in ((jserver, srv, 2 * ROUNDS),
                            (jclients, cl, ROUNDS)):
        np.testing.assert_array_equal(np.asarray(t_e.step),
                                      np.asarray(j_e.step))
        _assert_adam_close(jax.tree.leaves(j_e.params),
                           tree_leaves(t_e.params), steps)
        _assert_adam_close(jax.tree.leaves(j_e.opt_state),
                           tree_leaves(t_e.opt_state), steps)
