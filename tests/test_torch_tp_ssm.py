"""The Mamba-2, hybrid and whisper train and prefill steps on a mesh's
``model`` axis (and whisper's FSDP over ``data``), on the CPU over gloo.

As in ``tests/test_torch_tp.py`` the reference's own mesh path does not
run in this JAX (its meshes build Explicit axes), so the port's
head-parallel steps are held to the port's unsharded steps, and at
(1, 2) also to the reference's unsharded ``cyclesl_round`` on carried
weights and plans.  The smoke configs: zamba2-1.2b at depth 2 (a client
block, a server block and the shared attention block after it, 16 SSD
heads of 32), mamba2-2.7b at depth 2 (16 heads) and whisper-base (2 + 2
blocks, 4 heads of 32); whisper's encoder reads the first 64 frames
(``torch_tp_ssm_ranks.FRAMES``) on every side.

- the segmented shard of the packed Mamba leaves (``w_in``'s ``[z | x |
  B | C | dt]``, ``conv_w``'s ``[x | B | C]``): a rank's block holds
  whole heads of ``z``, ``x`` and ``dt`` and all of ``B`` and ``C`` (one
  group) or its groups' (two), and shard then gather is the whole leaf;
- a (1, 1) mesh in this process: bit for bit the unsharded train round
  and prefill, no collective;
- one spawned world of 2 on (1, 2) and one of 4 on (2, 2) and (1, 4),
  each running all three families: loss and every gathered gradient
  within 1e-5 of the leaf's scale, the f32 prefill logits likewise,
  two rounds' metrics within rtol 1e-5 and their state under Adam's
  near-sign rule (``tests/test_torch_tp.py``), the same on every rank,
  the census exactly as counted below; at (1, 2) zamba2 and whisper
  also against the reference's round (rtol 1e-4);
- the gate norm over a split last dimension against the whole one, and
  the ``B``/``C`` branch's gradient sum: a block at m = 2 matches the
  whole block in every gradient and the block input's, and the same
  check refuses the block with that sum dropped or doubled.
"""
import dataclasses

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
from repro.launch.steps import make_whisper_task as j_make_whisper_task
from repro.optim import adam as j_adam
from repro_torch.core.cyclesl import _value_and_grad
from repro_torch.core.feature_store import resample_plan
from repro_torch.launch import inputs as t_inputs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.meshcheck import spawn_ranks
from repro_torch.launch.steps import build_prefill_step, build_train_step
from repro_torch.models import mamba2
from repro_torch.models.layers import rmsnorm
from repro_torch.sharding.parallel import sharded_units
from repro_torch.sharding.specs import gather_params, shard_params, shard_plan
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_map)
from repro_torch.utils.weights import entity_from_reference, to_numpy

import torch_tp_ssm_ranks as ranks
from test_torch_tp import FakeModelComm

LR, C, ROUNDS = 3e-4, ranks.C, 2
SHAPE, PREFILL = ranks.SHAPE, ranks.PREFILL
GRAD_SEED, PREFILL_SEED = 7, 3
ZAMBA, MAMBA, WHISPER = "zamba2-1.2b", "mamba2-2.7b", "whisper-base"
ARCHS = (ZAMBA, MAMBA, WHISPER)
# the reference's round is held at (1, 2) for these
REFERENCE = (ZAMBA, WHISPER)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here, as in every spawned rank."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _groups(cfg, n):
    """``cfg`` with ``n`` B/C groups (each SSD head reads its own
    group's)."""
    return cfg.with_(ssm=dataclasses.replace(cfg.ssm, n_groups=n))


# ------------------------------------------------- the segmented shard
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", [ZAMBA, MAMBA])
def test_segmented_shard_holds_whole_heads_and_round_trips(arch, m, groups):
    """Each rank's block of ``w_in`` and ``conv_w`` (role 'client', a
    [2, ...] stack, too) is its heads' ``z``, ``x`` and ``dt`` columns
    and ``B``/``C`` whole (one group) or its groups' (groups dividing
    m), in that order; with groups that do not divide m every Mamba
    leaf stays whole.  Every rank's blocks put back by
    ``gather_params`` are the whole leaf, and the plan read back from a
    block is the plan."""
    cfg = _groups(ranks.config(arch), groups)
    s = cfg.ssm
    split = sharded_units(cfg, {"model": m})["mamba"]
    assert split == (groups == 1 or groups % m == 0)
    d_inner, gn = s.expand * cfg.d_model, s.n_groups * s.d_state
    H = d_inner // s.head_dim
    full = ranks.model_of(cfg).init(torch.Generator().manual_seed(0), cfg)
    sizes = {"data": 1, "model": m}
    for tree, role in ((full, "full"),
                       (tree_map(lambda t: torch.stack([t, t + 1]), full),
                        "client")):
        plans = [shard_plan(tree, sizes, {"model": r}, role, cfg)
                 for r in range(m)]
        shards = [shard_params(tree, p) for p in plans]
        for r in range(m):
            blk = shards[r]["blocks"]["mamba"]
            whole = tree["blocks"]["mamba"]
            if not split:
                assert all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(blk), tree_leaves(whole)))
                continue
            hd, gd = d_inner // m, gn // (m if groups > 1 else 1)
            g0 = 0 if groups == 1 else r * gd
            cols = torch.cat([torch.arange(r * hd, (r + 1) * hd),
                              d_inner + torch.arange(r * hd, (r + 1) * hd),
                              2 * d_inner + g0 + torch.arange(gd),
                              2 * d_inner + gn + g0 + torch.arange(gd),
                              2 * d_inner + 2 * gn
                              + torch.arange(r * H // m, (r + 1) * H // m)])
            assert torch.equal(blk["w_in"], whole["w_in"][..., cols])
            assert torch.equal(blk["conv_w"], whole["conv_w"][
                ..., cols[hd:2 * hd + 2 * gd] - d_inner])
            assert blk["w_in"].is_contiguous()
            assert torch.equal(blk["conv_b"], whole["conv_b"])
            for name, width in (("a_log", H), ("D", H),
                                ("w_out", d_inner)):
                dim = -2 if name == "w_out" else -1
                per = width // m
                assert torch.equal(blk[name], whole[name].narrow(
                    dim, r * per, per))
        for r in range(m):
            again = shard_plan(shards[r], sizes, {"model": r}, role, cfg,
                               local=True)
            assert [(p.dim, p.lo, p.hi, p.segs)
                    for p in tree_leaves(again)] == [
                (p.dim, p.lo, p.hi, p.segs) for p in tree_leaves(plans[r])]
        for r in range(m):
            back = gather_params(shards[r], plans[r],
                                 FakeModelComm(shards, plans, r))
            for a, b in zip(tree_leaves(tree), tree_leaves(back)):
                assert torch.equal(a, b)


class _PlanMesh:
    """What a task's placement reads of a mesh, without process groups:
    its sizes and this rank's coordinates (the last model rank)."""

    def __init__(self, d, m):
        self.shape = {"data": d, "model": m}
        self.coords = {"data": 0, "model": m - 1}
        self.model_comm = self.data_comm = None


@pytest.mark.parametrize("arch", ARCHS)
def test_task_plans_place_both_halves(arch):
    """The train step's task on a (2, 2) mesh: the client half (role
    'full') and the server half (role 'server') each hold their Mamba
    blocks' packed leaves cut on heads (zamba2's shared attention block
    and its FFN on the server, head- and column-parallel) or whisper's
    encoder and decoder attention and MLP; the server's leaves split
    over ``data`` where their spec has it (the round cuts those
    blocks), the client's keep their leaves whole there."""
    from repro_torch.models.module import SHAPES
    cfg = ranks.config(arch)
    task = ranks.make_task(cfg, mesh=_PlanMesh(2, 2))
    client = task.init_client(SHAPES)
    for (path, leaf), s in zip(tree_leaves_with_path(client),
                               tree_leaves(task.plans["client"])):
        if s.ddim is not None:
            assert leaf.shape[s.ddim] == 2 * (s.dhi - s.dlo), path
    for half in ("client", "server"):
        plan = task.plans[half]
        named = {"/".join(str(k) for k in path): s for (path, _), s in zip(
            tree_leaves_with_path(plan), tree_leaves(plan))}
        split = {n for n, s in named.items() if s.dim is not None}
        if arch == WHISPER:
            block = "blocks/attn/" if half == "client" else \
                "blocks/cross_attn/"
            assert {block + "wq", "blocks/ffn/w_in",
                    "blocks/ffn/b_in"} <= split
        else:
            assert named["blocks/mamba/w_in"].segs is not None
            assert named["blocks/mamba/conv_w"].segs is not None
            assert {"blocks/mamba/a_log", "blocks/mamba/w_out",
                    "blocks/mamba/gate_norm/scale"} <= split
            assert "blocks/mamba/conv_b" not in split
        if arch == ZAMBA and half == "server":
            assert {"shared_attn/attn/wq", "shared_attn/attn/wo",
                    "shared_attn/ffn/w_gate", "shared_attn/ffn/w_down"
                    } <= split
        assert any(s.ddim is not None for s in named.values())


# ------------------------------------------------------ carried states
def _reference_round(arch):
    """The reference's init (both halves, carried), its plans and its
    ROUNDS rounds: (port state0, plans, JAX rows, JAX final state)."""
    jcfg = ranks.config(arch)
    jcfg = j_smoke(arch).with_(n_layers=jcfg.n_layers)
    jtask = (j_make_whisper_task(jcfg) if arch == WHISPER
             else j_make_task(jcfg))
    jopt = j_adam(LR)
    jserver = jp.init_entity(jtask.init_server(jax.random.PRNGKey(0)), jopt)
    jclients = jp.broadcast_entity(
        jp.init_entity(jtask.init_client(jax.random.PRNGKey(1)), jopt), C)
    state0 = (entity_from_reference(jax.device_get(jserver)),
              entity_from_reference(jax.device_get(jclients)))
    jkeys = [jax.random.PRNGKey(10 + r) for r in range(ROUNDS)]
    plans = {r: (torch.from_numpy(np.array(j_plan(jkeys[r], C * 2, 1, 2))),
                 None) for r in range(ROUNDS)}
    step = jax.jit(lambda s, c, xs, ys, key: jc.cyclesl_round(
        jtask, s, c, jopt, jopt, xs, ys, key, jc.CycleConfig()))
    tcfg = ranks.config(arch)
    rows = []
    for r in range(ROUNDS):
        xs, ys = t_inputs.make_train_batch(tcfg, SHAPE, C, r)
        xs = {k: jnp.asarray(v) for k, v in ranks.cut_frames(xs).items()}
        ys = (tree_map(jnp.asarray, ys) if isinstance(ys, dict)
              else jnp.asarray(ys))
        jserver, jclients, jm = step(jserver, jclients, xs, ys, jkeys[r])
        rows.append({k: float(v) for k, v in jm.items()})
    return state0, plans, rows, jax.device_get((jserver, jclients))


def _port_init(arch):
    """The port's own init and plans for a case held to the port only."""
    state0 = build_train_step(ranks.config(arch), SHAPE, cohort=C,
                              device="cpu").init_state(0)
    plans = {r: (resample_plan(r, C * 2, 1, 2), None) for r in range(ROUNDS)}
    return state0, plans


def _unsharded(arch, state0, plans):
    """The port's unsharded steps on the same inputs as the ranks'."""
    cfg = ranks.config(arch)
    bundle = build_train_step(cfg, SHAPE, cohort=C, device="cpu",
                              plan_fn=ranks.FixedPlans(plans))
    s, c = state0
    rows = []
    for r in range(ROUNDS):
        xs, ys = bundle.make_batch(r)
        s, c, m = bundle.fn(s, c, ranks.cut_frames(xs), ys, r)
        rows.append({k: float(v) for k, v in m.items()})
    task = ranks.make_task(cfg)
    client = tree_map(lambda t: t[0], state0[1].params)
    x, y = ranks.slot_batch(cfg, GRAD_SEED)
    loss, gr = _value_and_grad(lambda p: task.e2e_loss(p[0], p[1], x, y),
                               (client, state0[0].params))
    _, gr64 = _value_and_grad(lambda p: task.e2e_loss(p[0], p[1], x, y),
                              tree_map(lambda t: t.double(),
                                       (client, state0[0].params)))
    pf = build_prefill_step(cfg, PREFILL, device="cpu")
    (params,), (batch,) = pf.init_state(PREFILL_SEED), pf.make_batch(
        PREFILL_SEED)
    batch = ranks.cut_frames(batch)
    return {"rows": rows, "state": to_numpy((s, c)), "loss": float(loss),
            "grads": to_numpy(gr), "grads64": to_numpy(gr64),
            "prefill": {"step": pf.fn(params, batch).float(),
                        "f32": ranks.forward_last(params, cfg, batch)}}


@pytest.fixture(scope="module")
def carried():
    """{arch: (state0, plans, reference rows or None, reference state or
    None)}: the reference's init for the archs held to it, the port's
    for the rest."""
    out = {a: _reference_round(a) for a in REFERENCE}
    out.update({a: (*_port_init(a), None, None) for a in ARCHS
                if a not in REFERENCE})
    return out


def _block_inputs():
    """A zamba2 smoke block's whole params (one group, and two) and a
    [2, 32, 256] input, drawn once."""
    gen = torch.Generator().manual_seed(5)
    out = {}
    for groups in (1, 2):
        cfg = _groups(ranks.config(ZAMBA), groups)
        params = mamba2.mamba_init(gen, cfg, torch.float32)
        # a nonzero conv bias, so its gradient sum shows too
        params["conv_b"] = torch.randn(params["conv_b"].shape,
                                       generator=gen) * 0.1
        out[groups] = (cfg, params)
    x = torch.randn(2, 32, 256, generator=gen)
    return out, x


def _args(carried, arch):
    state0, plans, _, _ = carried[arch]
    return (arch, state0, plans, ROUNDS, GRAD_SEED, PREFILL_SEED)


@pytest.fixture(scope="module")
def world2(carried, tmp_path_factory):
    blocks, x = _block_inputs()
    norm_x = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(6))
    norm_s = 1.0 + 0.1 * torch.arange(64.0)
    extras = {
        "block": ("block_grads", None, (*blocks[1], x,
                                        ("sound", "dropped", "doubled"))),
        "block groups 2": ("block_grads", None, (*blocks[2], x,
                                                 ("sound",))),
        "rmsnorm": ("split_rmsnorm", None, (norm_x, norm_s))}
    return spawn_ranks(2, ranks.world, (
        {f"{a} (1, 2)": (None, _args(carried, a)) for a in ARCHS}, extras),
        workdir=tmp_path_factory.mktemp("tpssm2"), shape=(1, 2))


@pytest.fixture(scope="module")
def world4(carried, tmp_path_factory):
    cases = {f"{a} (2, 2)": (None, _args(carried, a)) for a in ARCHS}
    cases.update({f"{a} (1, 4)": ((1, 4), _args(carried, a))
                  for a in ARCHS})
    return spawn_ranks(4, ranks.world, (cases, {}),
                       workdir=tmp_path_factory.mktemp("tpssm4"),
                       shape=(2, 2))


@pytest.fixture(scope="module")
def unsharded(carried):
    return {a: _unsharded(a, *carried[a][:2]) for a in ARCHS}


# name: (spawned world, arch, (d, m))
CASES = {f"{a} {lab}": (w, a, dm) for lab, w, dm in (
    ("(1, 2)", "world2", (1, 2)), ("(2, 2)", "world4", (2, 2)),
    ("(1, 4)", "world4", (1, 4))) for a in ARCHS}


def _case(request, name):
    world, arch, _ = CASES[name]
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
@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_is_bit_for_bit_unsharded(arch):
    """A (1, 1) mesh through the model-axis code: two train rounds and
    the prefill give the unsharded bits, and no collective runs."""
    cfg = ranks.config(arch)
    mesh = make_local_mesh("cpu")
    try:
        runs = {}
        for name, kw in (("unsharded", {}), ("mesh", {"mesh": mesh})):
            bundle = build_train_step(cfg, SHAPE, cohort=C, device="cpu",
                                      **kw)
            s, c = bundle.init_state(0)
            for r in range(2):
                xs, ys = bundle.make_batch(r)
                s, c, m = bundle.fn(s, c, ranks.cut_frames(xs), ys, r)
            pf = build_prefill_step(cfg, PREFILL, device="cpu", **kw)
            (batch,) = pf.make_batch(1)
            logits = pf.fn(*pf.init_state(1), ranks.cut_frames(batch))
            runs[name] = tree_leaves((s, c, m, logits))
        assert all(torch.equal(a, b) for a, b in zip(*runs.values()))
        assert mesh.model_comm.take_census() == {}
        assert mesh.comm.take_census() == {}
    finally:
        mesh.close()


# ------------------------------------------------------- spawned worlds
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_unsharded(name, request, unsharded):
    """Loss, and every leaf's gradient gathered whole (the packed Mamba
    leaves, ``conv_b``, the norms, the shared block, whisper's biases
    and tables included), within 1e-5 of the unsharded port's (relative
    to the leaf's largest entry).  Where float32 cannot resolve that
    (the unsharded float32 gradient itself lies farther than 1e-5 / 2
    of the leaf's scale from its float64 value: the SSD heads' ``a_log``
    and ``dt_bias``, sums over every position with much cancellation,
    read 1.6e-5), the bound is twice float32's own error there."""
    world, arch = _case(request, name)
    got, want = world[0][name], unsharded[arch]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    for (path, a), b, a64 in zip(tree_leaves_with_path(want["grads"]),
                                 tree_leaves(got["grads"]),
                                 tree_leaves(want["grads64"])):
        assert a.shape == b.shape, path
        bound = max(1e-5 * np.abs(a).max(), 2 * np.abs(a - a64).max())
        assert np.abs(a - b).max() <= bound, path


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
    """Two rounds: metrics within rtol 1e-5, the state gathered whole
    under the Adam near-sign rule (server: 2 steps a round; clients:
    1)."""
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


def _model_calls(cfg, units, c_local, steps=2) -> dict:
    """The ``model`` axis' calls in one round, by census key.  Each block
    pass forward reduces its split units' outputs once each (a Mamba
    block also its gate norm's sum of squares); backward, each split
    unit's input gradient once (``copy_to_model``: ``act_grad``, a
    Mamba block's ``mamba_grad`` with its B/C weights and ``conv_b``,
    and its gate norm's ``norm_grad``).  The client blocks run forward
    in the extract and in each slot's VJP (backward there), the server
    blocks forward and backward in each server step and each slot's
    feature gradient.  A split vocab adds the embedding's reduce to each
    forward of the half that embeds, and to each server forward a
    logits gather and (backward) the head input's reduce (one chunk
    here).  Whisper's decoder blocks take a self- and a
    cross-attention; in a slot's feature gradient the first
    self-attention reads only frozen weights, so its input gradient is
    never asked.  A split client half adds one norm reduce a slot.
    Each Mamba block and each whisper block is a group under
    ``module.remat`` (the hybrid's shared block is not), so each backward
    pass first runs the block's forward again, up to its last op that
    saves a tensor: the gate norm's and the attentions' reduces are
    issued again, the closing reduce of a Mamba block's output or of an
    MLP is not (only the residual add follows it); each loss chunk's
    recompute gathers its logits again (whisper's loss is no chunk)."""
    calls: dict = {}

    def add(key, n):
        if n:
            calls[f"model/{key}"] = calls.get(f"model/{key}", 0) + n
    srv = steps + c_local
    if cfg.family == "audio":
        E, D = cfg.enc_layers, cfg.n_layers
        cfwd, cbwd = 2 * c_local * E, c_local * E
        if units["attn"]:
            add("all_reduce/attn", cfwd + 2 * srv * D + cbwd + 2 * srv * D)
            add("all_reduce/act_grad", cbwd + 2 * srv * D - c_local)
        if units["ffn"]:
            add("all_reduce/ffn", cfwd + srv * D)
            add("all_reduce/act_grad", cbwd + srv * D)
        if units["vocab"]:
            add("all_reduce/embed", srv)
            add("all_gather/logits", srv)
            add("all_reduce/act_grad", srv)
    else:
        cut, L = cfg.cut_layers, cfg.n_layers
        fwd = 2 * c_local * cut + srv * (L - cut)
        bwd = c_local * cut + srv * (L - cut)
        if units["mamba"]:
            for key, n in (("norm", fwd + bwd), ("mamba", fwd),
                           ("norm_grad", bwd), ("mamba_grad", bwd)):
                add(f"all_reduce/{key}", n)
        shared = sum(cut <= p < L for p in cfg.ssm.shared_attn_positions) \
            if cfg.family == "hybrid" else 0
        for unit in ("attn", "ffn"):
            if units[unit]:
                add(f"all_reduce/{unit}", srv * shared)
                add("all_reduce/act_grad", srv * shared)
        if units["vocab"]:
            add("all_reduce/embed", 2 * c_local)
            add("all_gather/logits", 2 * srv)
            add("all_reduce/act_grad", srv)
    if any(units.values()):
        add("all_reduce/grad_norm", c_local)
    return calls


@pytest.mark.parametrize("name", list(CASES))
def test_census_of_a_round_is_as_counted(name, request):
    """The model axis' calls in every round of every rank as
    :func:`_model_calls` counts them; at zamba2 (1, 2) the bytes too:
    a [b, S, d] float32 activation is 2 * 32 * 256 * 4 = 65536 bytes,
    the gate norm's [b, S, 1] 256, a Mamba block's input gradient
    65536 + conv_b's 576 + the B/C weights' 256 x 64 and 4 x 64, as
    float32: 134400.  The gate norm's reduces and the logits gathers
    count their recomputes' too (8 forward, 6 again in a backward; 4
    gathers, 4 again)."""
    world, arch = _case(request, name)
    _, _, (d, m) = CASES[name]
    cfg = ranks.config(arch)
    units = sharded_units(cfg, {"model": m})
    for rank in world:
        for census in rank[name]["census"]:
            got = {k: v["calls"] for k, v in census.items()
                   if k.startswith("model/")}
            assert got == _model_calls(cfg, units, C // d)
    if name == f"{ZAMBA} (1, 2)":
        act = 65536
        want = {"embed": 4 * act, "norm": 14 * 256, "mamba": 8 * act,
                "attn": 4 * act, "ffn": 4 * act, "act_grad": 12 * act,
                "norm_grad": 6 * 256, "mamba_grad": 6 * 134400,
                "grad_norm": 2 * 4}
        got = world[0][name]["census"][0]
        assert got["model/all_gather/logits"]["bytes"] == 8 * act
        assert {k.split("/")[-1]: v["bytes"] for k, v in got.items()
                if k.startswith("model/all_reduce")} == want
        assert not any(not k.startswith("model/") for k in got)


def test_whisper_server_holds_fsdp_blocks(world4):
    """On (2, 2) whisper's server (the decoder) gathers its FSDP blocks
    at use: each of the 2 server steps and the frozen server of the
    feature gradients gather the 11 leaves the plan splits over
    ``data`` (the table, the eight attention projections, the MLP's two
    weights), a call each."""
    census = world4[0][f"{WHISPER} (2, 2)"]["census"][0]
    assert census["all_gather/weights"]["calls"] == 3 * 11


def test_one_by_two_round_matches_reference(world2, carried):
    """The (1, 2) rounds of zamba2 and whisper against the reference's
    unsharded rounds on the carried weights and plans: metrics within
    rtol 1e-4, the state gathered whole under the Adam near-sign
    rule."""
    for arch in REFERENCE:
        _, _, j_rows, (jserver, jclients) = carried[arch]
        got = world2[0][f"{arch} (1, 2)"]
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


# ------------------------------------------------------- unit checks
def test_split_rmsnorm_matches_whole(world2):
    """The gate norm over 64 columns split over 2 ranks: its output and
    the gradients of a fixed projection in x and the scale within 1e-6
    of the whole norm's, on every rank."""
    x = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(6))
    scale = 1.0 + 0.1 * torch.arange(64.0)
    probe = torch.linspace(-1.0, 1.0, x.numel()).reshape(x.shape)
    _, (gx, gs) = _value_and_grad(
        lambda p: torch.sum(rmsnorm({"scale": p[1]}, p[0]) * probe),
        (x, scale))
    y = rmsnorm({"scale": scale}, x)
    for rank in world2:
        got = rank["rmsnorm"]
        torch.testing.assert_close(got["y"], y, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got["gx"], gx, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got["gs"], gs, rtol=1e-6, atol=1e-6)


def _block_matches(got, want) -> bool:
    """Every gradient of the block (its input's and each leaf's) within
    1e-5 of the whole block's, relative to its largest entry."""
    pairs = [(got["x"], want["x"])] + list(zip(
        tree_leaves(got["params"]), tree_leaves(to_numpy(want["params"]))))
    return all(np.abs(np.asarray(a) - np.asarray(b)).max()
               <= 1e-5 * np.abs(np.asarray(b)).max() for a, b in pairs)


def _whole_block_grads(cfg, params, x):
    probe = torch.linspace(-1.0, 1.0, x.numel()).reshape(x.shape)
    _, (gx, gp) = _value_and_grad(
        lambda p: torch.sum(mamba2.mamba_forward(p[1], cfg, p[0])[0]
                            * probe), (x, params))
    return {"x": gx, "params": {"mamba": gp}}


def test_bc_gradient_sum_is_taken_once(world2):
    """A zamba2 block on 2 ranks: the gradients of its input and of
    every leaf (``w_in``'s and ``conv_w``'s B/C parts, ``conv_b``) match
    the whole block's; with the B/C branch's sum over the axis dropped,
    or every sum of the block taken twice, the same check refuses it.
    With two groups (B and C split with their heads) it matches too."""
    blocks, x = _block_inputs()
    wants = {g: _whole_block_grads(*blocks[g], x) for g in (1, 2)}
    for groups, name, modes in ((1, "block", ("sound", "dropped",
                                              "doubled")),
                                (2, "block groups 2", ("sound",))):
        for rank in world2:
            got = rank[name]
            assert _block_matches(got["sound"], wants[groups]), groups
            for mode in modes[1:]:
                assert not _block_matches(got[mode], wants[groups]), mode
    # doubled: the block input's gradient counts the whole block twice
    torch.testing.assert_close(world2[0]["block"]["doubled"]["x"],
                               2 * wants[1]["x"], rtol=1e-4, atol=1e-6)
