"""Decode and the serving slot table on a mesh, in this process (no
spawned ranks): the decode state's plan, a (1, 1) mesh, and the decode
halves at m = 2.

- each decode-state leaf of the five smoke families (gemma2-2b,
  olmoe-1b-7b, zamba2-1.2b, mamba2-2.7b, whisper-base) in the serving
  runtime's form (one position a row) gets the block
  ``sharding.specs.decode_state_plan`` gives it on (d, m) = (1, 2),
  (2, 2), (1, 4) and (4, 1): its rows of the batch, its heads of the KV
  cache where the attention unit splits (gemma2's 2 kv heads at m = 4
  over kv head groups: the group's one head), its ``H / m`` SSD heads,
  its ``[x_r | B | C]``
  conv channels, ``enc_out`` whole over ``model``; the blocks, put back
  by the test's own placement, are the whole state, and each block has
  the shape of the empty state the program allocates
  (``decode_state_zeros``);
- a (1, 1) mesh: ``build_decode_step(mesh=)`` for every family and
  ``ServeRuntime(mesh=)`` for olmoe and zamba2 give the unsharded
  results bit for bit, with no collective;
- ``attention.attend_decode`` and ``mamba2.mamba_decode`` (one group,
  and two) at m = 2, each rank in a thread of this process over
  ``test_torch_tp.FakeModelComm`` given an all-reduce: the output within
  1e-5 of its scale of the whole function's, each rank's new cache and
  state the whole one's block.
"""
import dataclasses
import threading

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention, mamba2
from repro_torch.models.transformer import Transformer
from repro_torch.sharding.parallel import (TensorParallel, packed_segments,
                                           rank_segments, sharded_units,
                                           take_segments)
from repro_torch.sharding.specs import (decode_state_plan,
                                        decode_state_zeros, shard_params,
                                        shard_plan)
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_map)

import torch_serve_mesh_ranks as ranks
from test_torch_tp import FakeModelComm

ARCHS = ranks.ARCHS
B, CAP, FRAMES = 4, 8, 6
MESHES = ((1, 2), (2, 2), (1, 4), (4, 1))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here, as in every spawned rank."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def local_mesh():
    mesh = make_local_mesh("cpu")
    yield mesh
    mesh.close()


class _Grid:
    """A mesh's shape and this rank's coordinates, as the placement reads
    them."""

    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords


def _tp(cfg, m, comm):
    return TensorParallel(comm, sharded_units(cfg, {"model": m}))


# ------------------------------------------------------------ the plan
def _whole_state(cfg):
    """The slot table's form of a whole decode state at batch B (one
    position a row), every leaf filled with distinct values."""
    if cfg.family == "audio":
        state = {"enc_out": torch.zeros(B, FRAMES, cfg.d_model),
                 "kv": attention.kv_cache_init(cfg, cfg.n_layers, B, CAP,
                                               torch.float32),
                 "pos": torch.zeros((), dtype=torch.int32)}
    else:
        state = Transformer.init_decode_state(cfg, B, CAP)
    state = tree_map(lambda t: t.new_zeros((B,)) if t.dim() == 0 else t,
                     state)
    gen = torch.Generator().manual_seed(2)
    return tree_map(lambda t: (torch.randint(0, 1000, t.shape, generator=gen,
                                             dtype=t.dtype)
                               if not t.is_floating_point() else
                               torch.randn(t.shape, generator=gen
                                           ).to(t.dtype)), state)


def _columns(cfg, path, m, r):
    """The test's own placement over ``model``: (dim, [(lo, hi), ...] of
    the whole leaf this rank holds, in order), or None for whole."""
    if m == 1:
        return None
    if path.startswith("kv/") and path != "kv/idx":
        if cfg.n_heads % m:
            return None
        if cfg.n_kv_heads % m == 0:
            per = cfg.n_kv_heads // m
            return 3, [(r * per, (r + 1) * per)]
        if m % cfg.n_kv_heads == 0:       # the group's one kv head
            g = r // (m // cfg.n_kv_heads)
            return 3, [(g, g + 1)]
        return None
    s = cfg.ssm
    if path == "mamba/h":
        per = s.expand * cfg.d_model // s.head_dim // m
        return 2, [(r * per, (r + 1) * per)]
    if path == "mamba/conv":
        d_in, gn = s.expand * cfg.d_model, s.n_groups * s.d_state
        per = d_in // m
        return 3, [(r * per, (r + 1) * per), (d_in, d_in + gn),
                   (d_in + gn, d_in + 2 * gn)]
    return None


def _rows(path, d, q):
    """(dim, lo, hi) of the batch rows this rank holds: B divides every d
    here, so they always split where d > 1."""
    dim = 0 if path in ("enc_out", "pos", "kv/idx") else 1
    per = B // d
    return dim, q * per, (q + 1) * per


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_blocks_and_round_trip(arch):
    cfg = smoke_config(arch)
    whole = _whole_state(cfg)
    paths = ["/".join(map(str, p)) for p, _ in tree_leaves_with_path(whole)]
    for d, m in MESHES:
        sizes = {"data": d, "model": m}
        back = tree_map(torch.zeros_like, whole)
        covered = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.int),
                           whole)
        for q in range(d):
            for r in range(m):
                plan = decode_state_plan(whole, sizes,
                                         {"data": q, "model": r}, cfg)
                block = shard_params(whole, plan)
                mesh = _Grid(sizes, {"data": q, "model": r})
                empty = decode_state_zeros(whole, mesh, cfg, "cpu")
                assert [tuple(t.shape) for t in tree_leaves(block)] == \
                    [tuple(t.shape) for t in tree_leaves(empty)], (d, m)
                assert all(not t.any() for t in tree_leaves(empty))
                for path, x, y, c in zip(paths, tree_leaves(block),
                                         tree_leaves(back),
                                         tree_leaves(covered)):
                    rdim, lo, hi = _rows(path, d, q)
                    cols = _columns(cfg, path, m, r)
                    idx = [slice(None)] * y.dim()
                    idx[rdim] = slice(lo, hi)
                    if cols is None:
                        spans = [(None, None)]
                    else:
                        spans = cols[1]
                    off = 0
                    for a, b in spans:
                        at = list(idx)
                        if a is not None:
                            at[cols[0]] = slice(a, b)
                        n = 0 if a is None else b - a
                        piece = x if a is None else x.narrow(cols[0], off, n)
                        assert tuple(piece.shape) == tuple(y[tuple(at)].shape)
                        y[tuple(at)] = piece
                        c[tuple(at)] += 1
                        off += n
                    if cols is not None:
                        assert off == x.shape[cols[0]], path
        for path, w, y, c in zip(paths, tree_leaves(whole), tree_leaves(back),
                                 tree_leaves(covered)):
            assert torch.equal(w, y), (path, d, m)
            # every entry placed; whole leaves and the B/C channels once
            # a model rank, split ones once
            assert int(c.min()) >= 1, (path, d, m)


def test_plan_of_the_full_configs_splits_heads_and_keeps_whole_units():
    """At full width: olmoe-1b-7b's 16 kv heads and zamba2-1.2b's 32 split
    at m = 4, gemma2-2b's 4 kv heads at m = 4 too, mamba2-2.7b's 80 SSD
    heads split and its conv channels keep B and C whole."""
    from repro_torch.configs import get_config
    for arch, m, leaf, dim, per in (
            ("olmoe-1b-7b", 4, "kv/k", 3, 4),
            ("zamba2-1.2b", 4, "kv/k", 3, 8),
            ("gemma2-2b", 4, "kv/k", 3, 1),
            ("mamba2-2.7b", 4, "mamba/h", 2, 20),
            ("mamba2-2.7b", 4, "mamba/conv", 3, 1280 + 2 * 128)):
        cfg = get_config(arch)
        st = Transformer.init_decode_state(cfg, 8, 128, device="meta")
        plan = {"/".join(map(str, p)): x for p, x in tree_leaves_with_path(
            decode_state_plan(st, {"data": 2, "model": m},
                              {"data": 1, "model": 1}, cfg))}
        s = plan[leaf]
        assert s.dim == dim and s.hi - s.lo == per, (arch, leaf)
        assert (s.ddim, s.dlo, s.dhi) == (1, 4, 8), (arch, leaf)
        assert plan["pos"].ddim is None            # a scalar: whole


# ----------------------------------------------------------- (1, 1) mesh
@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_decode_is_bit_for_bit(arch, local_mesh):
    want = ranks.teacher_forced(None, arch)
    got = ranks.teacher_forced(local_mesh, arch)
    assert torch.equal(want["logits"], got["logits"])
    for a, b in zip(tree_leaves(want["state"]), tree_leaves(got["state"])):
        assert torch.equal(a, b)
    assert all(c == {} for c in got["census"])


@pytest.mark.parametrize("arch", ranks.SERVE_ARCHS)
def test_one_by_one_mesh_serving_is_bit_for_bit(arch, local_mesh):
    whole = Transformer.init(torch.Generator().manual_seed(0),
                             smoke_config(arch))
    want = ranks.serve(None, arch, whole)
    got = ranks.serve(local_mesh, arch, whole)
    assert got["tokens"] == want["tokens"]
    assert got["records"] == want["records"]
    assert got["stats"] == want["stats"]
    assert got["stats"]["traces"] == {"prefill": 1, "admit": 1, "decode": 1}
    assert got["census"] == {}


# ------------------------------------------------- the halves at m = 2
class ThreadedModelComm(FakeModelComm):
    """``FakeModelComm`` for ranks that run in threads of this process,
    with an all-reduce: every rank's tensor summed in rank order at a
    barrier."""

    def __init__(self, shared, rank):
        super().__init__(shared["shards"], None, rank)
        self.shared = shared

    def _all_reduce_(self, t, what):
        sh = self.shared
        sh["slots"][self.rank] = t.clone()
        sh["barrier"].wait()
        total = sh["slots"][0].clone()
        for x in sh["slots"][1:]:
            total += x
        sh["barrier"].wait()
        return t.copy_(total)


def _run_ranks(m, shards, fn):
    """``fn(rank, comm)`` in ``m`` threads; their results in rank order."""
    shared = {"shards": shards, "slots": [None] * m,
              "barrier": threading.Barrier(m)}
    out, errs = [None] * m, []

    def run(r):
        try:
            with torch.no_grad():
                out[r] = fn(r, ThreadedModelComm(shared, r))
        except BaseException as e:       # noqa: BLE001 — re-raised below
            errs.append(e)
            shared["barrier"].abort()
    threads = [threading.Thread(target=run, args=(r,)) for r in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def _close(got, want):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma2-2b"])
def test_attend_decode_at_m2_matches_whole(arch):
    cfg = smoke_config(arch)
    m, C = 2, CAP
    gen = torch.Generator().manual_seed(3)
    params = {"attn": tree_map(lambda t: t[0], Transformer.init(
        gen, cfg)["blocks"]["attn"])}
    x = torch.randn(B, 1, cfg.d_model, generator=gen)
    k = torch.randn(B, C, cfg.n_kv_heads, cfg.hd, generator=gen)
    v = torch.randn(B, C, cfg.n_kv_heads, cfg.hd, generator=gen)
    # rows at different positions, some past the ring's capacity
    pos = torch.tensor([0, 3, C + 2, 2 * C + 5], dtype=torch.int32)
    window = cfg.attn.window
    with torch.no_grad():
        want, wk, wv = attention.attend_decode(params["attn"], cfg, x, k, v,
                                               pos, window)
    plans = [shard_plan(params, {"model": m}, {"model": r}, "full", cfg)
             for r in range(m)]
    shards = [shard_params(params, p) for p in plans]
    per = cfg.n_kv_heads // m

    def rank(r, comm):
        sl = slice(r * per, (r + 1) * per)
        return attention.attend_decode(
            shards[r]["attn"], cfg, x, k[:, :, sl].contiguous(),
            v[:, :, sl].contiguous(), pos, window, _tp(cfg, m, comm))
    for r, (out, nk, nv) in enumerate(_run_ranks(m, shards, rank)):
        _close(out, want)
        sl = slice(r * per, (r + 1) * per)
        _close(nk, wk[:, :, sl])
        _close(nv, wv[:, :, sl])


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_decode_at_m2_matches_whole(groups):
    cfg = smoke_config("zamba2-1.2b")
    cfg = cfg.with_(ssm=dataclasses.replace(cfg.ssm, n_groups=groups))
    s, m = cfg.ssm, 2
    gen = torch.Generator().manual_seed(4)
    params = mamba2.mamba_init(gen, cfg, torch.float32)
    params["conv_b"] = torch.randn(params["conv_b"].shape, generator=gen)
    params["dt_bias"] = torch.randn(params["dt_bias"].shape, generator=gen)
    params["D"] = torch.randn(params["D"].shape, generator=gen)
    H = s.expand * cfg.d_model // s.head_dim
    x = torch.randn(B, 1, cfg.d_model, generator=gen)
    h = torch.randn(B, H, s.d_state, s.head_dim, generator=gen)
    conv = torch.randn(B, s.d_conv - 1, mamba2._conv_channels(cfg),
                       generator=gen)
    with torch.no_grad():
        want, wh, wconv = mamba2.mamba_decode(params, cfg, x, h, conv)
    plans = [shard_plan({"mamba": params}, {"model": m}, {"model": r},
                        "full", cfg) for r in range(m)]
    shards = [shard_params({"mamba": params}, p) for p in plans]
    segs = [rank_segments(packed_segments(cfg, "mamba/conv_w"), m, r)
            for r in range(m)]
    per = H // m

    def rank(r, comm):
        return mamba2.mamba_decode(
            shards[r]["mamba"], cfg, x, h[:, r * per:(r + 1) * per],
            take_segments(conv, segs[r]), _tp(cfg, m, comm))
    # the plan's block of an empty state is what the decode reads and
    # writes
    whole = {"mamba": mamba2.mamba_state_init(cfg, 1, B, torch.float32)}
    for r, (out, hr, cr) in enumerate(_run_ranks(m, shards, rank)):
        _close(out, want)
        _close(hr, wh[:, r * per:(r + 1) * per])
        _close(cr, take_segments(wconv, segs[r]))
        block = decode_state_zeros(whole, _Grid({"data": 1, "model": m},
                                                {"data": 0, "model": r}),
                                   cfg, "cpu")["mamba"]
        assert tuple(block.h.shape[1:]) == tuple(hr.shape)
        assert tuple(block.conv.shape[1:]) == tuple(cr.shape)
