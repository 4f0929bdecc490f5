"""The attention split over kv head groups: a block with fewer kv heads
than ``model`` ranks (``sharding.parallel.kv_replicas``), on the CPU.

Rank ``r`` of a model axis of ``m`` holds its ``n_heads / m`` query heads
and the one kv head they read, ``g = r // (m / n_kv_heads)``, whole; each
kv head is held alike by the ``m / n_kv_heads`` ranks of its group, which
sum its weights' gradients (``kv_group_sum``, census ``kv/...``).

- the plan at published widths (shapes only): glm4-9b at m = 4 and 8,
  gemma2-2b at m = 8 (and at m = 4, where its kv heads split evenly):
  every rank's ``wk``/``wv`` block is its group's whole kv head, its
  ``wq`` block the query heads that read it, its cache block
  (``decode_state_plan``) the group's head; ``TensorParallel.heads``
  agrees;
- ``shard_params``/``gather_params`` at smoke width on (1, m) and, with
  FSDP over ``data``, on (2, m), every rank in a thread of this process:
  the gathered tree is the whole tree on every rank, and cutting it
  again gives the rank's blocks;
- one spawned world of 4 on (1, 4), glm4's smoke config (4 query heads,
  2 kv heads: one query head a rank, kv groups of 2) at depth 2 from the
  reference's init carried over: two train rounds against the port's
  unsharded rounds (metrics within rtol 1e-5, the state under the Adam
  near-sign rule of ``tests/test_torch_tp.py``), the unsharded first
  round against the reference's (rtol 1e-4, the same rule); each
  group's ``wk``/``wv`` copies (params and moments) bit-equal on both
  of its ranks; the kv groups' census as counted; the same run with the
  group sum dropped refused by both checks, and its gradients off;
  teacher-forced decode and a ``ServeRuntime(mesh=)`` wave giving the
  unsharded tokens; the state saved on (1, 4) after round 1, restored
  into each rank's blocks bit for bit, and restored unsharded to run
  round 2 as the mesh did.

The loss, every gradient and the prefill of the same split are held
within 1e-5 of the unsharded port by ``tests/test_torch_tp.py``'s glm4
(1, 4) case.
"""
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.cyclesl import _value_and_grad
from repro_torch.core.feature_store import resample_plan
from repro_torch.core.split import make_transformer_task
from repro_torch.launch.meshcheck import spawn_ranks
from repro_torch.launch.steps import build_train_step
from repro_torch.models.module import SHAPES
from repro_torch.models.transformer import Transformer
from repro_torch.sharding.collectives import Collectives
from repro_torch.sharding.parallel import (TensorParallel, kv_replicas,
                                           sharded_units)
from repro_torch.sharding.specs import (decode_state_plan, gather_params,
                                        shard_params, shard_plan)
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_map)
from repro_torch.utils.weights import to_numpy
from torch_threads import one_thread  # noqa: F401

import torch_kv_groups_ranks as ranks
import torch_serve_mesh_ranks as serve_ranks
import torch_tp_ranks as tp_ranks
from test_torch_tp import (C, _assert_adam_close, _assert_rows_close,
                           _reference_init)

GRAD_SEED = 7
# (arch, m) at published widths
PUBLISHED = (("glm4-9b", 4), ("glm4-9b", 8), ("gemma2-2b", 8),
             ("gemma2-2b", 4))
# name: (arch, m, heads and kv heads set at smoke width)
SMOKE = {"glm4 m4": ("glm4-9b", 4, {}),
         "glm4 m8": ("glm4-9b", 8, {"n_heads": 8}),
         "gemma2 m8": ("gemma2-2b", 8, {"n_heads": 8, "n_kv_heads": 4})}


def _paths(tree) -> dict:
    return {"/".join(map(str, p)): x for p, x in tree_leaves_with_path(tree)}


# ----------------------------------------------------------- the plan
@pytest.mark.parametrize("arch,m", PUBLISHED)
def test_plan_gives_each_rank_its_groups_whole_kv_head(arch, m):
    cfg = get_config(arch)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rep = kv_replicas(cfg, m)
    assert rep == (m // Hkv if Hkv < m else 1)
    assert sharded_units(cfg, {"model": m})["attn"]
    whole = Transformer.init(SHAPES, cfg)
    state = Transformer.init_decode_state(cfg, 4, 32, device="meta")
    for r in range(m):
        g = r * Hkv // m if rep > 1 else None
        plan = _paths(shard_plan(whole, {"model": m}, {"model": r}, "full",
                                 cfg))
        q0, nq = r * H // m, H // m
        assert (plan["blocks/attn/wq"].lo, plan["blocks/attn/wq"].hi) == (
            q0 * hd, (q0 + nq) * hd)
        tp = TensorParallel(SimpleNamespace(size=m, rank=r),
                            sharded_units(cfg, {"model": m}), kv_rep=rep)
        heads = tp.heads(cfg)
        assert tp.kv_group == (g if rep > 1 else r)
        for leaf in ("wk", "wv"):
            s = plan[f"blocks/attn/{leaf}"]
            assert s.dim == 2 and s.rep == rep, (leaf, r)
            if rep > 1:
                # the group's one kv head, whole, and the one its query
                # heads read (head h reads kv head h // (H / Hkv))
                assert (s.lo, s.hi) == (g * hd, (g + 1) * hd), (leaf, r)
                assert {h // (H // Hkv) for h in range(q0, q0 + nq)} == {g}
            else:
                per = Hkv // m
                assert (s.lo, s.hi) == (r * per * hd, (r + 1) * per * hd)
        assert heads == (nq, 1 if rep > 1 else Hkv // m)
        cache = _paths(decode_state_plan(state, {"data": 1, "model": m},
                                         {"data": 0, "model": r}, cfg))
        for leaf in ("kv/k", "kv/v"):
            s = cache[leaf]
            want = (g, g + 1) if rep > 1 else (r * (Hkv // m),
                                               (r + 1) * (Hkv // m))
            assert (s.dim, s.lo, s.hi, s.rep) == (3, *want, rep), leaf


def test_rule_outside_the_groups_keeps_attention_whole():
    """Query heads that do not divide the axis, or kv heads that neither
    divide nor are divided by it, keep the unit whole."""
    cfg = smoke_config("glm4-9b")
    for heads, kv, m in ((4, 2, 8), (6, 3, 4), (8, 3, 4)):
        c = cfg.with_(n_heads=heads, n_kv_heads=kv)
        assert not sharded_units(c, {"model": m})["attn"], (heads, kv, m)
        assert kv_replicas(c, m) == 1


class ThreadedComm:
    """The collectives of one group of ranks that run in threads of this
    process: an all-gather is every rank's tensor concatenated in group
    order at a barrier (the tree form is ``Collectives``' own)."""

    _by_dtype = Collectives._by_dtype
    all_gather_tree = Collectives.all_gather_tree

    def __init__(self, shared, rank):
        self.shared, self.rank = shared, rank
        self.size = len(shared["slots"])

    def all_gather(self, t, what):
        sh = self.shared
        sh["slots"][self.rank] = t.contiguous().clone()
        sh["barrier"].wait()
        out = torch.cat(sh["slots"])
        sh["barrier"].wait()
        return out


def _group(n):
    return {"slots": [None] * n, "barrier": threading.Barrier(n)}


def _on_threads(d, m, fn):
    """``fn(q, r, model_comm, data_comm)`` for each rank of a (d, m)
    grid, one thread each; the results by (q, r)."""
    models = [_group(m) for _ in range(d)]
    datas = [_group(d) for _ in range(m)]
    out, errs = {}, []

    def run(q, r):
        try:
            out[(q, r)] = fn(q, r, ThreadedComm(models[q], r),
                             ThreadedComm(datas[r], q) if d > 1 else None)
        except BaseException as e:       # noqa: BLE001 — re-raised below
            errs.append(e)
            for g in models + datas:
                g["barrier"].abort()
    threads = [threading.Thread(target=run, args=(q, r))
               for q in range(d) for r in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("case", list(SMOKE))
def test_shard_and_gather_round_trip_on_every_rank(case, d):
    arch, m, over = SMOKE[case]
    cfg = smoke_config(arch).with_(**over)
    assert kv_replicas(cfg, m) > 1
    gen = torch.Generator().manual_seed(0)
    full = Transformer.init(gen, cfg)
    stacked = tree_map(lambda t: torch.stack([t, t + 1]), full)
    for tree, role in ((full, "server"), (full, "full"),
                       (stacked, "client")):
        sizes = {"data": d, "model": m}

        def rank(q, r, mc, dc):
            plan = shard_plan(tree, sizes, {"data": q, "model": r}, role,
                              cfg)
            local = shard_params(tree, plan)
            back = gather_params(local, plan, mc, dc)
            again = shard_params(back, plan)
            heads = {p: (x, s) for (p, x), s in zip(
                _paths(local).items(), tree_leaves(plan))
                if p.endswith(("attn/wk", "attn/wv"))}
            return back, again, local, heads
        got = _on_threads(d, m, rank)
        for (q, r), (back, again, local, heads) in got.items():
            for a, b in zip(tree_leaves(tree), tree_leaves(back)):
                assert torch.equal(a, b), (case, role, q, r)
            for a, b in zip(tree_leaves(again), tree_leaves(local)):
                assert torch.equal(a, b), (case, role, q, r)
            g = r // kv_replicas(cfg, m)
            for path, (x, s) in heads.items():
                # model split first, then the rows over data (FSDP)
                want = _paths(tree)[path].narrow(s.dim, g * cfg.hd, cfg.hd)
                if s.ddim is not None:
                    want = want.narrow(s.ddim, s.dlo, s.dhi - s.dlo)
                assert torch.equal(x, want), (case, role, path, q, r)


# ------------------------------------------------- the spawned world
@pytest.fixture(scope="module")
def carried():
    """The reference's init of glm4's smoke config at depth 2 carried
    over, its plan for round 0 and the port's for round 1, and the
    reference's first round (its rows and state)."""
    state0, plans, rounds = _reference_init(ranks.ARCH, ranks.DEPTH)
    plans[1] = (resample_plan(1, C * 2, 1, 2), None)
    j_rows, j_state = rounds()
    return state0, plans, j_rows, j_state


@pytest.fixture(scope="module")
def served():
    return Transformer.init(torch.Generator().manual_seed(0),
                            smoke_config(ranks.ARCH))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("kv_ckpt"))


@pytest.fixture(scope="module")
def world(carried, served, ckpt_dir, tmp_path_factory):
    state0, plans, _, _ = carried
    return spawn_ranks(4, ranks.world, (state0, plans, ckpt_dir, GRAD_SEED,
                                        served),
                       workdir=tmp_path_factory.mktemp("kv4"), shape=(1, 4))


def _bundle(plans):
    return build_train_step(tp_ranks.config(ranks.ARCH, ranks.DEPTH),
                            tp_ranks.SHAPE, cohort=C, device="cpu",
                            plan_fn=tp_ranks.FixedPlans(plans))


def _rounds(bundle, state, first, n):
    s, c = state
    rows = []
    for r in range(first, first + n):
        s, c, m = bundle.fn(s, c, *bundle.make_batch(r), r)
        rows.append({k: float(v) for k, v in m.items()})
    return rows, (s, c)


@pytest.fixture(scope="module")
def unsharded(carried, served):
    """The port's unsharded runs on the same inputs as the ranks'."""
    state0, plans, _, _ = carried
    cfg = tp_ranks.config(ranks.ARCH, ranks.DEPTH)
    bundle = _bundle(plans)
    rows1, state1 = _rounds(bundle, state0, 0, 1)
    rows2, state2 = _rounds(bundle, state1, 1, 1)
    task = make_transformer_task(cfg)
    client = tree_map(lambda t: t[0], state0[1].params)
    xs, ys = bundle.make_batch(GRAD_SEED)
    _, grads = _value_and_grad(lambda p: task.e2e_loss(
        p[0], p[1], {"tokens": xs["tokens"][0]}, ys[0]),
        (client, state0[0].params))
    return {"rows": rows1 + rows2, "state1": to_numpy(state1),
            "state": to_numpy(state2), "grads": to_numpy(grads),
            "decode": serve_ranks.teacher_forced(None, ranks.ARCH),
            "serve": serve_ranks.serve(None, ranks.ARCH, served)}


def test_unsharded_first_round_matches_reference(carried, unsharded):
    _, _, j_rows, (jserver, jclients) = carried
    _assert_rows_close(j_rows, unsharded["rows"][:1], 1e-4)
    srv, cl = unsharded["state1"]
    for j_e, t_e, steps in ((jserver, srv, 2), (jclients, cl, 1)):
        _assert_adam_close(jax.tree.leaves(j_e.params),
                           tree_leaves(t_e.params), steps)


def test_rounds_match_unsharded(world, unsharded):
    got = world[0]["sound"]
    _assert_rows_close(unsharded["rows"], got["rows"], 1e-5)
    for want, have in zip(unsharded["state"], got["state"]):
        _assert_adam_close(want, have, 2 * ranks.ROUNDS)
    for rank in world[1:]:
        assert rank["sound"]["rows"] == got["rows"]


def test_group_copies_are_bit_equal(world):
    """Ranks 0 and 1 hold kv head 0, ranks 2 and 3 kv head 1: each
    group's copies (params and moments) the same bits after two rounds,
    the two groups' different."""
    d = [rank["sound"]["group_digest"] for rank in world]
    assert d[0] == d[1] and d[2] == d[3] and d[0] != d[2]


def test_kv_group_census_is_as_counted(world):
    """A weight-gradient pass of a block sums ``wk``'s and ``wv``'s
    float32 gradients [d, hd] each over the group once: the server's
    blocks in each of its ``steps`` steps, the client's in each slot's
    VJP (the feature gradients' pass holds the server frozen, so no sum
    runs there)."""
    cfg = tp_ranks.config(ranks.ARCH, ranks.DEPTH)
    steps = 2        # the server's steps a round, as test_torch_tp counts
    calls = steps * (cfg.n_layers - cfg.cut_layers) + C * cfg.cut_layers
    want = {"calls": calls, "bytes": calls * 2 * cfg.d_model * cfg.hd * 4}
    for rank in world:
        for census in rank["sound"]["census"]:
            kv = {k: v for k, v in census.items() if k.startswith("kv/")}
            assert kv == {"kv/all_reduce/kv_grad": want}


def test_dropped_group_sum_is_refused(world, unsharded):
    """With the group sum dropped each rank steps its copy of the kv head
    by its own query heads' part of the gradient: the copies part, the
    state leaves the Adam near-sign rule and ``wk``/``wv``'s gradients
    leave 1e-5 of the unsharded ones."""
    d = [rank["planted"]["group_digest"] for rank in world]
    assert d[0] != d[1] and d[2] != d[3]
    with pytest.raises(AssertionError):
        for want, have in zip(unsharded["state"],
                              world[0]["planted"]["state"]):
            _assert_adam_close(want, have, 2 * ranks.ROUNDS)
    off = {}
    for (path, a), b in zip(tree_leaves_with_path(unsharded["grads"]),
                            tree_leaves(world[0]["planted_grads"])):
        name = "/".join(map(str, path))
        off[name] = np.abs(a - b).max() > 1e-5 * np.abs(a).max()
    kv = {k: v for k, v in off.items() if k.endswith(("attn/wk",
                                                        "attn/wv"))}
    assert kv and all(kv.values())


def test_decode_and_serving_match_unsharded(world, unsharded):
    want = unsharded["decode"]["logits"]
    scale = float(want.abs().max())
    for rank in world:
        got = rank["decode"]["logits"]
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        assert float((got - want).abs().max()) <= 1e-5 * scale
        s, w = rank["serve"], unsharded["serve"]
        assert s["tokens"] == w["tokens"]
        assert s["records"] == w["records"] and s["stats"] == w["stats"]


def test_checkpoint_saved_on_the_mesh_restores(world, unsharded, carried,
                                               ckpt_dir):
    """Each rank cut its blocks from the restored whole state bit for bit;
    restored unsharded, the state is the unsharded first round's (the
    Adam rule) and its second round the mesh's second round."""
    assert all(rank["sound"]["restored_is_live"] for rank in world)
    state0, plans, _, _ = carried
    bundle = _bundle(plans)
    template = bundle.init_state(0)
    restored, step = load_checkpoint(ckpt_dir, template)
    assert step == 1
    for want, have in zip(unsharded["state1"], to_numpy(restored)):
        _assert_adam_close(want, have, 2)
    rows, state = _rounds(bundle, restored, 1, 1)
    _assert_rows_close(world[0]["sound"]["rows"][1:], rows, 1e-5)
    for want, have in zip(world[0]["sound"]["state"], to_numpy(state)):
        _assert_adam_close(want, have, 2 * ranks.ROUNDS)
