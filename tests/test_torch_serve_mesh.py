"""Decode and the serving slot table on a mesh of four ranks, on the CPU
over gloo: one spawned world of 4 on (2, 2), with a second mesh of
(1, 4) over the same ranks (rank jobs in ``tests/torch_serve_mesh_ranks.py``).

The reference's own mesh test (``tests/test_serving.py``, a (4, 2)
mesh) needs 8 devices and its mesh path does not run in this JAX (its
meshes build Explicit axes), so the port's mesh decode and serving are
held to the port's unsharded ones, which ``tests/test_torch_decode.py``
and ``tests/test_torch_serving.py`` hold to the reference, and at
(1, 4) also to the reference's unsharded ``Transformer.decode_step`` on
the port's init (seed 0, what ``build_decode_step``'s ``init_state``
draws) carried over through ``utils/weights.py``.

- every family (gemma2-2b, olmoe-1b-7b, zamba2-1.2b, mamba2-2.7b,
  whisper-base, smoke configs, float32): 8 teacher-forced steps of
  ``build_decode_step(mesh=)`` at batch 4 give logits within 1e-5 of
  their scale of the unsharded step's, and the state gathered whole
  likewise; every rank's gathered logits are the same;
- at (1, 4), olmoe and zamba2 within rtol 1e-4 of the reference's
  decode on the same weights;
- ``ServeRuntime(mesh=)`` on olmoe and zamba2 with the reference test's
  ``ServeConfig(slots=8, max_prompt_len=4, max_new_tokens=3,
  prefill_batch=4)`` and its 10 prompts, every rank reading a clock of
  its own: each request's tokens, the records and the stats equal the
  unsharded runtime's on every rank, and ``traces`` is one of each;
- a fault planted on one rank only (two prefill dispatches and one
  decode) is retried on every rank: the results equal the unsharded
  runtime's under the same hook;
- the census of a decode step and of a whole serving run, by axis,
  equals the count written below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models.transformer import Transformer as JT
from repro_torch.configs import smoke_config
from repro_torch.launch.meshcheck import spawn_ranks
from repro_torch.models.encdec import EncDec
from repro_torch.models.module import SHAPES
from repro_torch.models.transformer import Transformer
from repro_torch.sharding.parallel import sharded_units
from repro_torch.sharding.specs import shard_plan
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path
from repro_torch.utils.weights import to_numpy

import torch_serve_mesh_ranks as ranks

ARCHS, SERVE_ARCHS = ranks.ARCHS, ranks.SERVE_ARCHS
REFERENCE = ("olmoe-1b-7b", "zamba2-1.2b")
MESHES = {"(2, 2)": None, "(1, 4)": (1, 4)}
DM = {"(2, 2)": (2, 2), "(1, 4)": (1, 4)}
B = ranks.DECODE.global_batch
SC = ranks.SERVE
# the serving run of the 10 prompts at 8 slots, chunks of 4 and 3 new
# tokens: tick 1 admits two chunks of 4 and decodes, tick 2 decodes,
# tick 3 retires 8, admits a chunk of the last 2 and decodes, tick 4
# decodes, tick 5 retires 2 and has nothing to decode
PREFILLS, DECODES, TICKS, RETIRE_TICKS = 3, 4, 5, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here, as in every spawned rank."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def served():
    """{arch: whole params}: the port's init of seed 0, which the decode
    step's ``init_state(0)`` draws too, for the serving cases and the
    reference's decode."""
    return {a: Transformer.init(torch.Generator().manual_seed(0),
                                smoke_config(a)) for a in SERVE_ARCHS}


@pytest.fixture(scope="module")
def world(served, tmp_path_factory):
    decode = {f"{a} {lab}": (shape, a)
              for lab, shape in MESHES.items() for a in ARCHS}
    serve = {f"serve {a} {lab}": (shape, a, served[a], None)
             for lab, shape in MESHES.items() for a in SERVE_ARCHS}
    serve["fault"] = (None, "olmoe-1b-7b", served["olmoe-1b-7b"], 3)
    return spawn_ranks(4, ranks.world, (decode, serve),
                       workdir=tmp_path_factory.mktemp("servemesh"),
                       shape=(2, 2))


@pytest.fixture(scope="module")
def unsharded(served):
    out = {a: ranks.teacher_forced(None, a) for a in ARCHS}
    out.update({f"serve {a}": ranks.serve(None, a, served[a])
                for a in SERVE_ARCHS})
    out["fault"] = ranks.serve(None, "olmoe-1b-7b", served["olmoe-1b-7b"],
                               faulty_rank=0)
    return out


def _close(got, want, tol=1e-5):
    scale = float(want.abs().max())
    assert float((got.double() - want.double()).abs().max()) <= tol * scale


DECODE_CASES = [f"{a} {lab}" for lab in MESHES for a in ARCHS]


@pytest.mark.parametrize("name", DECODE_CASES)
def test_decode_matches_unsharded(name, world, unsharded):
    arch = name.split(" ")[0]
    want = unsharded[arch]
    first = world[0][name]["logits"]
    for rank in world:
        got = rank[name]
        assert torch.equal(got["logits"], first)
        _close(got["logits"], want["logits"])
        for a, b in zip(tree_leaves(got["state"]),
                        tree_leaves(want["state"])):
            assert a.shape == b.shape
            if a.is_floating_point():
                _close(a, b)
            else:
                assert torch.equal(a, b)


@pytest.mark.parametrize("arch", REFERENCE)
def test_one_by_four_decode_matches_reference(arch, world, served,
                                              unsharded):
    jcfg = j_smoke(arch)
    jp = to_numpy(served[arch])
    toks = ranks.teacher_tokens(smoke_config(arch)).numpy()
    jstep = jax.jit(lambda p, t, s: JT.decode_step(p, jcfg, t, s))
    state = JT.init_decode_state(jcfg, B, ranks.DECODE.seq_len)
    want = []
    for t in range(ranks.STEPS):
        lg, state = jstep(jp, jnp.asarray(toks[:, t:t + 1]), state)
        want.append(np.asarray(lg)[:, 0])
    want = np.stack(want, 1)
    for got in (world[0][f"{arch} (1, 4)"]["logits"],
                unsharded[arch]["logits"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


SERVE_CASES = [f"serve {a} {lab}" for lab in MESHES for a in SERVE_ARCHS]


@pytest.mark.parametrize("name", SERVE_CASES)
def test_serving_matches_unsharded_on_every_rank(name, world, unsharded):
    want = unsharded[f"serve {name.split(' ')[1]}"]
    assert want["stats"]["by_status"]["done"] == len(ranks.PROMPTS)
    for rank in world:
        got = rank[name]
        assert got["tokens"] == want["tokens"]
        assert got["records"] == want["records"]
        assert got["stats"] == want["stats"]
        assert got["stats"]["traces"] == {"prefill": 1, "admit": 1,
                                          "decode": 1}


def test_fault_on_one_rank_is_retried_on_every_rank(world, unsharded):
    want = unsharded["fault"]
    assert want["stats"]["dispatch_retries"] == 3
    assert want["tokens"] == unsharded["serve olmoe-1b-7b"]["tokens"]
    for r, rank in enumerate(world):
        got = rank["fault"]
        assert got["fired"] == (want["fired"] if r == 3 else [])
        assert got["tokens"] == want["tokens"]
        assert got["records"] == want["records"]
        assert got["stats"] == want["stats"]


# ------------------------------------------------------------ the census
def _model_calls(cfg, n, m, moe_rows=None) -> dict:
    """{key: (calls, bytes)} over ``model`` of one decode body on ``n``
    rows of a float32 smoke config at ``m`` ranks: the vocab-parallel
    embedding and logits, each split attention, FFN, MoE (on
    ``moe_rows``, default ``n``) and Mamba block's reduce, the gate
    norm's sum of squares."""
    units = sharded_units(cfg, {"model": m})
    act = n * cfg.d_model * 4
    out: dict = {}

    def add(key, calls, nbytes):
        c, b = out.get(key, (0, 0))
        out[key] = (c + calls, b + calls * nbytes)
    L = cfg.n_layers
    shared = (len(cfg.ssm.shared_attn_positions)
              if cfg.family == "hybrid" else 0)
    n_attn = {"audio": 2 * L, "ssm": 0, "hybrid": shared}.get(cfg.family, L)
    n_ffn = {"audio": L, "ssm": 0, "hybrid": shared}.get(
        cfg.family, 0 if cfg.moe else L)
    if units["vocab"]:
        add("model/all_reduce/embed", 1, act)
        add("model/all_gather/logits", 1, n * cfg.vocab_padded // m * 4)
    if units["attn"]:
        add("model/all_reduce/attn", n_attn, act)
    if units["ffn"] and n_ffn:
        add("model/all_reduce/ffn", n_ffn, act)
    if units["moe"]:
        add("model/all_reduce/moe", L, (moe_rows or n) * cfg.d_model * 4)
    if units["mamba"]:
        add("model/all_reduce/mamba", L, act)
        add("model/all_reduce/norm", L, n * 4)
    return out


def _weights_gather(cfg, d, m) -> tuple:
    """(calls, bytes) of one gather over ``data`` of every FSDP block:
    one call a leaf the plan splits over ``data``, the rank's block."""
    model = EncDec if cfg.family == "audio" else Transformer
    whole = model.init(SHAPES, cfg)
    plan = shard_plan(whole, {"data": d, "model": m},
                      {"data": 0, "model": 0}, "full", cfg)
    blocks = [t.numel() // d * ((s.hi - s.lo) if s.dim is not None
                                 else t.shape[0]) // (
                  t.shape[s.dim] if s.dim is not None else t.shape[0])
              * t.element_size()
              for t, s in zip(tree_leaves(whole), tree_leaves(plan))
              if s.ddim is not None]
    return len(blocks), sum(blocks)


def _as_census(counts: dict) -> dict:
    return {k: {"calls": c, "bytes": b} for k, (c, b) in counts.items()
            if c}


def decode_census(arch, d, m) -> dict:
    cfg = smoke_config(arch)
    n = B // d
    # a dispatch group of the whole batch spans the data ranks: the MoE
    # runs on every row of the batch
    out = _model_calls(cfg, n, m, moe_rows=B)
    if d > 1:
        out["all_gather/weights"] = _weights_gather(cfg, d, m)
        if cfg.moe is not None:
            out["all_gather/moe_rows"] = (cfg.n_layers,
                                          cfg.n_layers * n * cfg.d_model * 4)
    return _as_census(out)


@pytest.mark.parametrize("name", DECODE_CASES)
def test_decode_census_is_as_counted(name, world):
    arch, lab = name.split(" ", 1)
    want = decode_census(arch, *DM[lab])
    for rank in world:
        assert all(c == want for c in rank[name]["census"])


def serve_census(arch, d, m, retries=0) -> dict:
    cfg = smoke_config(arch)
    S, Pb, P = SC.slots // d, SC.prefill_batch // d, SC.max_prompt_len
    cap = SC.max_prompt_len + SC.max_new_tokens
    out: dict = {}

    def merge(counts, times):
        for k, (c, b) in counts.items():
            c0, b0 = out.get(k, (0, 0))
            out[k] = (c0 + c * times, b0 + b * times)
    merge(_model_calls(cfg, S, m), DECODES)
    merge(_model_calls(cfg, Pb, m), PREFILLS * P)
    if d > 1:
        merge({"all_gather/weights": _weights_gather(cfg, d, m)},
              DECODES + PREFILLS)
        # a chunk's rows, one call a dtype: the state (float32) and the
        # per-row positions, ring indices and first tokens (int32)
        f32 = _table_bytes(cfg, Pb, cap, m)
        i32 = (2 if cfg.family != "ssm" else 1) * Pb * 4 + Pb * 4
        merge({"all_gather/admit": (2, f32 + i32)}, PREFILLS)
        merge({"all_gather/retire": (1, S * SC.max_new_tokens * 4)},
              RETIRE_TICKS)
    # the host group: rank 0's clock a submit, a tick and an admitted
    # chunk; one fault flag a dispatch attempt
    n_prompts = len(ranks.PROMPTS)
    merge({"host/broadcast/clock": (1, 8)}, n_prompts + TICKS + PREFILLS)
    merge({"host/all_reduce/fault": (1, 4)},
          2 * PREFILLS + DECODES + retries)
    return _as_census(out)


def _table_bytes(cfg, n, cap, m) -> int:
    """Bytes of the floating leaves of a rank's slot table at ``n`` rows:
    the KV cache's heads over ``m`` where the attention unit splits, the
    SSD heads over ``m``, the conv's x channels over ``m`` (B and C
    whole with one group)."""
    units = sharded_units(cfg, {"model": m})
    table = Transformer.init_decode_state(cfg, n, cap, device="meta")
    total = 0
    for p, t in tree_leaves_with_path(table):
        path = "/".join(map(str, p))
        if not t.is_floating_point():
            continue
        nb = t.numel() * t.element_size()
        if path in ("kv/k", "kv/v") and units["attn"]:
            nb //= m
        elif path == "mamba/h" and units["mamba"]:
            nb //= m
        elif path == "mamba/conv" and units["mamba"]:
            s = cfg.ssm
            d_in, gn = s.expand * cfg.d_model, s.n_groups * s.d_state
            gn_r = gn if s.n_groups == 1 else gn // m
            nb = nb // (d_in + 2 * gn) * (d_in // m + 2 * gn_r)
        total += nb
    return total


@pytest.mark.parametrize("name", SERVE_CASES + ["fault"])
def test_serving_census_is_as_counted(name, world):
    if name == "fault":
        want = serve_census("olmoe-1b-7b", 2, 2, retries=3)
    else:
        _, arch, lab = name.split(" ", 2)
        want = serve_census(arch, *DM[lab])
    for rank in world:
        assert rank[name]["census"] == want
