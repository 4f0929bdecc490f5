"""The port's continuous-batching runtime, held against ``repro.serve``.

Every case of ``tests/test_serving.py`` but the mesh placement (which
needs 8 devices there; the port's mesh runtime is held in
``tests/test_torch_decode_mesh.py`` and ``tests/test_torch_serve_mesh.py``)
runs here on the port's ``ServeRuntime``
and on the JAX package's, side by side: the weights of one JAX init
carried across, one ``FakeClock`` each (so every time is the fake
clock's), the same submissions and the same ``fault_hook``.  Their
``records()`` must be equal (tokens exactly; statuses, token counts,
retries and fake-clock latencies and TTFTs) and so must ``stats()``,
whose ``traces`` are the JAX package's jit traces on one side and the
argument signatures the port's steps were built for on the other.

Greedy tokens compare exactly: float32 logits that differ by ~1e-6 in
their sums would flip an argmax only at a near tie, which these random
smoke models do not reach.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.config import ExperimentConfig as JConfig
from repro.configs import smoke_config as j_smoke
from repro.models.transformer import Transformer as JT
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeRuntime as JRuntime
from repro.serve import run_closed_loop as j_run_closed_loop
from repro_torch.api import ExperimentConfig
from repro_torch.configs import smoke_config
from repro_torch.models.transformer import Transformer
from repro_torch.serve import (ServeConfig, ServeRuntime, STATUS_DONE,
                               STATUS_EVICTED_DEADLINE,
                               STATUS_EVICTED_FAILURE, STATUS_REJECTED,
                               make_prompts, run_closed_loop)
from repro_torch.utils.tree import tree_leaves_with_path
from repro_torch.utils.weights import to_torch
from torch_threads import one_thread  # noqa: F401


class FakeClock:
    """Deterministic injectable clock; sleeps advance it."""

    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt

    def sleep(self, dt):
        self.sleeps.append(dt)
        self.t += dt


SC = ServeConfig(slots=4, max_prompt_len=6, max_new_tokens=5,
                 prefill_batch=2)


class Pair:
    """The port's runtime and the reference's over one JAX init, each
    with its own fake clock and its own copy of a stateful fault hook."""

    def __init__(self, arch, sc=SC, hook=None):
        jcfg, self.cfg = j_smoke(arch), smoke_config(arch)
        jp = jax.device_get(JT.init(jax.random.PRNGKey(0), jcfg))
        self.jclk, self.tclk = FakeClock(), FakeClock()
        self.j = JRuntime(jcfg, JServeConfig(**sc.to_dict()), params=jp,
                          clock=self.jclk, sleep=self.jclk.sleep,
                          fault_hook=hook() if hook else None)
        self.t = ServeRuntime(self.cfg, sc, params=to_torch(jp),
                              clock=self.tclk, sleep=self.tclk.sleep,
                              fault_hook=hook() if hook else None,
                              device="cpu")
        self.both = (self.j, self.t)

    def submit(self, prompt, **kw):
        rids = [rt.submit(prompt, **kw) for rt in self.both]
        assert rids[0] == rids[1]
        return rids[1]

    def do(self, name, *a, **kw):
        for rt in self.both:
            getattr(rt, name)(*a, **kw)

    def advance(self, dt):
        self.jclk.advance(dt)
        self.tclk.advance(dt)

    def tokens(self, rid):
        return [rt.results[rid].tokens.tolist() for rt in self.both]

    def check(self):
        """records, tokens and stats equal; returns the port's records."""
        assert self.t.records() == self.j.records()
        for rid in self.j.results:
            want, got = self.tokens(rid)
            assert got == want, rid
        assert self.t.stats() == self.j.stats()
        assert self.tclk.sleeps == self.jclk.sleeps
        return self.t.records()


def _shapes(rt):
    return [(p, tuple(t.shape), t.dtype) for p, t in tree_leaves_with_path(
        (rt.state, rt.cur_tok, rt.counts, rt.out_buf, rt._chunk_zero))]


@pytest.fixture(scope="module")
def pair():
    """One module-scoped pair — reused so the trace counters span every
    arrival pattern the tests throw at it."""
    return Pair("gemma2-2b")


def _greedy_reference(rt, prompt, n_new):
    """Per-token reference on the port: batch 1, scalar position."""
    arch, sc = rt.arch, rt.serve
    state = Transformer.init_decode_state(
        arch, 1, sc.max_prompt_len + sc.max_new_tokens, device="cpu")
    logits = None
    with torch.no_grad():
        for t in (list(prompt) or [0]):
            logits, state = Transformer.decode_step(
                rt.params, arch, torch.tensor([[t]], dtype=torch.int32),
                state)
        out = [int(torch.argmax(logits[0, -1]))]
        for _ in range(n_new - 1):
            logits, state = Transformer.decode_step(
                rt.params, arch, torch.tensor([[out[-1]]],
                                              dtype=torch.int32), state)
            out.append(int(torch.argmax(logits[0, -1])))
    return out


def test_compile_once_across_arrival_patterns(pair, monkeypatch):
    """Static shapes: every slot-table tensor keeps its shape and dtype,
    each step is built for one signature, and a decode tick is ONE
    batched decode over all slots."""
    shapes = _shapes(pair.t)
    calls = []
    orig = Transformer.decode_step

    def counting(params, cfg, token, state, **kw):
        calls.append(token.shape[0])
        return orig(params, cfg, token, state, **kw)

    monkeypatch.setattr(Transformer, "decode_step", staticmethod(counting))
    # pattern 1: sequential singles
    for i in range(3):
        pair.submit([1 + i], max_new=2)
        pair.do("drain")
    # pattern 2: a burst over capacity (queueing + slot reuse)
    for i in range(9):
        pair.submit([2, 3, 4][: 1 + i % 3], max_new=3)
    pair.do("drain")
    # pattern 3: staggered arrivals mid-flight
    pair.submit([5, 6], max_new=4)
    pair.do("step")
    pair.submit([7], max_new=2)
    pair.do("step")
    pair.submit([1, 2, 3, 4, 5, 6], max_new=3)
    pair.do("drain")
    recs = pair.check()
    assert all(r["status"] == STATUS_DONE for r in recs)
    # THE claim: one build per step site, regardless of arrivals
    assert pair.t.traces == {"prefill": 1, "admit": 1, "decode": 1}
    assert pair.t.stats()["max_slot_reuse"] > 1
    assert _shapes(pair.t) == shapes
    # prefill: max_prompt_len calls at prefill_batch rows per chunk;
    # decode: one call at all slots per tick
    assert set(calls) == {SC.slots, SC.prefill_batch}
    n_chunks = calls.count(SC.prefill_batch) // SC.max_prompt_len
    assert calls.count(SC.prefill_batch) == n_chunks * SC.max_prompt_len
    assert 0 < calls.count(SC.slots) <= pair.t.stats()["ticks"]


def test_output_matches_per_token_reference(pair):
    prompts = [[1, 2, 3], [9], [4, 5, 6, 7, 8, 2]]
    rids = [pair.submit(p, max_new=4) for p in prompts]
    pair.do("drain")
    pair.check()
    for p, rid in zip(prompts, rids):
        assert pair.t.results[rid].tokens.tolist() == \
            _greedy_reference(pair.t, p, 4), p


def test_empty_prompt_is_bos_zero(pair):
    rid = pair.submit([], max_new=3)
    pair.do("drain")
    pair.check()
    assert pair.t.results[rid].tokens.tolist() == \
        _greedy_reference(pair.t, [], 3)


def test_slot_reuse_never_leaks():
    """A request served in a REUSED slot is bit-for-bit a fresh runtime:
    the ring-buffer position reset invalidates every stale cache entry
    the previous occupant left (no cache zeroing dispatch exists)."""
    sc = ServeConfig(slots=1, max_prompt_len=6, max_new_tokens=5,
                     prefill_batch=1)
    p = Pair("gemma2-2b", sc)
    # occupant 1 fills the slot's cache to a different occupancy/content
    p.submit([3, 1, 4, 1, 5, 9], max_new=5)
    p.do("drain")
    # occupant 2 reuses slot 0
    rid = p.submit([2, 7], max_new=5)
    p.do("drain")
    p.check()
    assert p.t.assignments[0] == 2
    fresh = ServeRuntime(p.cfg, sc, params=p.t.params, device="cpu")
    frid = fresh.submit([2, 7], max_new=5)
    fresh.drain()
    assert p.t.results[rid].tokens.tolist() == \
        fresh.results[frid].tokens.tolist()


def test_batched_prefill_bit_equals_per_token(pair):
    """One prefill chunk with MIXED lengths against per-token stepping of
    each row, and against the reference's chunk."""
    rt = pair.t
    tokens = np.zeros((SC.prefill_batch, SC.max_prompt_len), np.int32)
    rows = [[3, 1, 4, 1, 5], [2, 7, 1]]
    lens = np.asarray([len(r) for r in rows], np.int32)
    for i, r in enumerate(rows):
        tokens[i, :len(r)] = r
    (cstate, first), _ = rt._dispatch(
        "prefill", rt._prefill, rt.params, torch.from_numpy(tokens),
        torch.from_numpy(lens), rt._chunk_zero)
    (_, jfirst), _ = pair.j._dispatch(
        "prefill", pair.j._prefill, pair.j.params, jnp.asarray(tokens),
        jnp.asarray(lens), pair.j._chunk_zero)
    assert first.tolist() == np.asarray(jfirst).tolist()
    for i, row in enumerate(rows):
        assert int(first[i]) == _greedy_reference(rt, row, 1)[0], i
    # the prefilled state must carry the row's true length as pos
    assert cstate["pos"].tolist() == lens.tolist()
    assert cstate["kv"].idx.tolist() == lens.tolist()


def test_deadline_rejects_queued_and_evicts_inflight():
    sc = ServeConfig(slots=1, max_prompt_len=4, max_new_tokens=8,
                     prefill_batch=1, deadline_s=100.0)
    p = Pair("gemma2-2b", sc)
    slow = p.submit([1, 2], deadline_s=5.0)      # will expire in flight
    queued = p.submit([3], deadline_s=5.0)       # will expire queued
    p.do("step")                                 # admits `slow` only
    assert p.t.results[slow].status == "running"
    p.advance(10.0)                              # both deadlines pass
    p.do("step")
    assert p.t.results[slow].status == STATUS_EVICTED_DEADLINE
    assert len(p.t.results[slow].tokens) > 0     # partial output kept
    assert p.t.results[queued].status == STATUS_REJECTED
    assert len(p.t.results[queued].tokens) == 0  # zero compute spent
    # the slot is free again and the runtime keeps serving
    ok = p.submit([4], max_new=2)
    p.do("drain")
    assert p.t.results[ok].status == STATUS_DONE
    p.check()


def test_done_requests_honor_deadline():
    """No request completes past its deadline: generous deadlines all
    finish in time, and every finish timestamp is within bound."""
    p = Pair("gemma2-2b")
    rids = [p.submit([i + 1], max_new=3, deadline_s=1e6) for i in range(6)]
    while any(p.t.results[r].status != STATUS_DONE for r in rids):
        p.do("step")
        p.advance(0.01)
    p.check()
    for r in rids:
        req = p.t.results[r]
        assert req.finished <= req.deadline


class FailTwice:
    """Decode fails twice, then succeeds."""

    def __init__(self):
        self.n = 0

    def __call__(self, site, tick, attempt):
        if site == "decode" and self.n < 2:
            self.n += 1
            raise RuntimeError("injected stall")


def test_retry_backoff_schedule():
    """A dispatch that fails twice then succeeds: the injected sleeps
    follow backoff_base * 2^attempt and the request still completes."""
    sc = ServeConfig(slots=2, max_prompt_len=4, max_new_tokens=3,
                     prefill_batch=1, max_retries=3, backoff_base_s=0.5)
    p = Pair("gemma2-2b", sc, hook=FailTwice)
    rid = p.submit([1, 2], max_new=3)
    p.do("drain")
    p.check()
    assert p.t.results[rid].status == STATUS_DONE
    assert p.tclk.sleeps == [0.5, 1.0]       # base * 2^0, base * 2^1
    assert p.t.dispatch_retries == 2
    assert p.t.results[rid].retries >= 2


class KillDecode:
    def __init__(self):
        self.kill = True

    def __call__(self, site, tick, attempt):
        if site == "decode" and self.kill:
            raise RuntimeError("persistent decode fault")


def test_decode_exhaustion_evicts_live_and_recovers():
    """Decode retry exhaustion evicts every live slot with its partial
    output; the runtime immediately serves new requests."""
    sc = ServeConfig(slots=2, max_prompt_len=4, max_new_tokens=3,
                     prefill_batch=2, max_retries=1)
    p = Pair("gemma2-2b", sc, hook=KillDecode)
    rids = [p.submit([1 + i], max_new=3) for i in range(2)]
    p.do("step")
    for r in rids:
        req = p.t.results[r]
        assert req.status == STATUS_EVICTED_FAILURE
        assert len(req.tokens) == 1          # the prefill's first token
    assert p.t.evictions["failure"] == 2
    for rt in p.both:
        rt.fault_hook.kill = False
    ok = p.submit([5], max_new=2)
    p.do("drain")
    assert p.t.results[ok].status == STATUS_DONE
    p.check()


def _kill_prefill():
    def hook(site, tick, attempt):
        if site == "prefill":
            raise RuntimeError("persistent prefill fault")
    return hook


def test_prefill_exhaustion_evicts_chunk_only():
    sc = ServeConfig(slots=2, max_prompt_len=4, max_new_tokens=2,
                     prefill_batch=2, max_retries=0)
    p = Pair("gemma2-2b", sc, hook=_kill_prefill)
    rids = [p.submit([1]), p.submit([2])]
    p.do("step")
    p.check()
    assert all(p.t.results[r].status == STATUS_EVICTED_FAILURE
               for r in rids)
    assert p.t.n_live == 0 and len(p.t.free) == 2  # slots returned


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b",
                                  "zamba2-1.2b"])
def test_closed_loop_loadgen(arch):
    """The closed loop's row equals the reference's, at a window, a MoE
    (each slot its own dispatch group) and the hybrid."""
    p = Pair(arch)
    prompts = make_prompts(8, SC.max_prompt_len, p.cfg.vocab, seed=3)
    row = run_closed_loop(p.t, prompts, concurrency=3)
    assert row == j_run_closed_loop(p.j, prompts, concurrency=3)
    p.check()
    assert row["by_status"][STATUS_DONE] == 8
    assert row["throughput_tok_s"] > 0
    assert row["latency_s"]["p50"] is not None
    assert row["latency_s"]["p50"] <= row["latency_s"]["p99"]


def test_closed_loop_empty_prompts_on_reused_runtime():
    """Requests are selected by the ids this call submitted, not a tail
    slice of the runtime's shared history."""
    p = Pair("gemma2-2b")
    prompts = make_prompts(4, SC.max_prompt_len, p.cfg.vocab, seed=3)
    warm = run_closed_loop(p.t, prompts, concurrency=2)
    assert warm == j_run_closed_loop(p.j, prompts, concurrency=2)
    assert warm["by_status"][STATUS_DONE] == 4
    row = run_closed_loop(p.t, [], concurrency=2)
    assert row == j_run_closed_loop(p.j, [], concurrency=2)
    assert row["n_requests"] == 0
    assert all(v == 0 for v in row["by_status"].values()), row["by_status"]
    assert row["throughput_tok_s"] == 0.0
    assert row["throughput_req_s"] == 0.0
    assert row["latency_s"]["p50"] is None
    p.check()


def test_mamba2_runtime():
    sc = ServeConfig(slots=2, max_prompt_len=4, max_new_tokens=3,
                     prefill_batch=2)
    p = Pair("mamba2-2.7b", sc)
    rids = [p.submit([1, 2], max_new=3), p.submit([3], max_new=2)]
    p.do("drain")
    p.check()
    assert all(p.t.results[r].status == STATUS_DONE for r in rids)
    assert p.t.traces == {"prefill": 1, "admit": 1, "decode": 1}


def test_serve_config_validation_and_roundtrip():
    sc = ServeConfig(slots=16, deadline_s=2.5, max_retries=1)
    assert ServeConfig.from_dict(sc.to_dict()) == sc
    assert sc.to_dict() == JServeConfig(slots=16, deadline_s=2.5,
                                        max_retries=1).to_dict()
    with pytest.raises(KeyError):
        ServeConfig.from_dict({"bogus": 1})
    with pytest.raises(ValueError):
        ServeConfig(prefill_batch=9, slots=8).validate()
    with pytest.raises(ValueError):
        ServeConfig(deadline_s=0.0).validate()
    cfg = ExperimentConfig(serve=sc)
    rt = ExperimentConfig.from_dict(cfg.to_dict())
    assert rt.serve == sc
    # pre-serve configs load with default knobs
    d = cfg.to_dict()
    d.pop("serve")
    assert ExperimentConfig.from_dict(d).serve == ServeConfig()
    # the reference's dict drives the port and comes back unchanged
    jd = JConfig(serve=JServeConfig(slots=16, deadline_s=2.5,
                                    max_retries=1)).to_dict()
    assert ExperimentConfig.from_dict(jd).validate().to_dict() == jd


def test_submit_rejects_over_budget(pair):
    with pytest.raises(ValueError):
        pair.t.submit(list(range(SC.max_prompt_len + 1)))
    with pytest.raises(ValueError):
        pair.t.submit([1], max_new=SC.max_new_tokens + 1)
    with pytest.raises(ValueError):
        pair.t.submit([pair.cfg.vocab])


def test_mesh_raises():
    """A mesh no longer raises: a (1, 1) mesh in this process serves, and
    gives the unsharded runtime's records and stats exactly."""
    from repro_torch.launch.mesh import make_local_mesh
    cfg = smoke_config("gemma2-2b")
    params = Transformer.init(torch.Generator().manual_seed(0), cfg)
    prompts = make_prompts(6, SC.max_prompt_len, cfg.vocab, seed=3)
    mesh = make_local_mesh("cpu")
    try:
        runs = []
        for m in (None, mesh):
            rt = ServeRuntime(cfg, SC, params=params, mesh=m,
                              clock=lambda: 0.0, device="cpu")
            run_closed_loop(rt, prompts, concurrency=3)
            runs.append((rt.records(), rt.stats(),
                         [rt.results[r].tokens.tolist()
                          for r in sorted(rt.results)]))
        assert runs[0] == runs[1]
        assert runs[1][1]["by_status"]["done"] == len(prompts)
    finally:
        mesh.close()
