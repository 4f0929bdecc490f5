"""Continuous-batching split-serving runtime (vLLM-style slot reuse).

Port of ``repro/serve/runtime.py``.  The server stage of the split
deployment consumes concurrent client token streams through a
**fixed-capacity slot table**: ``slots`` independent decode states
stacked along the batch axis, advanced together by ONE batched decode
call per tick.  Admission and retirement are pure masking — a retired
slot is handed to the next queued request with every slot-table tensor
keeping its shape and dtype — so each of the three step functions
(prefill, admission scatter, decode) sees one argument signature
whatever the arrival pattern.  ``traces`` counts the signatures each has
been built for, as the JAX package counts its jit traces; static shapes
are what lets the tick be captured in a CUDA graph.

Where the JAX package ``vmap``s a batch-1 decode over the slots, the
port's ``Transformer.decode_step`` takes a position per row: the slot
table is ``init_decode_state`` at batch ``slots`` with ``pos`` (and the
cache's ``idx``) one per slot, and each slot's MoE tokens are routed as
a group of their own (``moe_group_size=1``), as under the ``vmap``.

Dataflow per :meth:`ServeRuntime.step` (one tick):

  1. retire   — slots whose generation budget is met hand back tokens;
  2. deadline — expired queued requests are rejected (zero compute),
                expired in-flight requests are evicted with their
                partial output;
  3. admit    — up to ``prefill_batch`` queued requests are prefilled
                in ONE dispatch (a loop over the prompt budget's
                positions through the same batched decode body, masked
                per row by its length) and scattered into free slots;
  4. decode   — one batched step advances every live slot.

Slot-reuse correctness comes from the ring-buffer cache math:
:func:`repro_torch.models.attention.attend_decode` masks cache entries
via ``k_pos = pos - ((pos - slot) % C) ; valid = k_pos >= 0``, so
resetting a slot's ``pos`` to 0 at admission invalidates every stale
entry the previous occupant left behind — no cache zeroing needed.

The host reads the card in two places only: the first tokens of an
admitted chunk (time-to-first-token is taken after that read) and, once
a tick, the output rows of the slots it retires.  Per-tick inputs go up
from pinned memory without waiting for the queued work.

Robustness: every dispatch runs under a retry budget with exponential
backoff; exhaustion evicts the affected slots and the runtime keeps
serving (see :class:`~repro_torch.serve.config.ServeConfig`).
``clock`` / ``sleep`` / ``fault_hook`` are injectable so the deadline
and backoff paths are deterministic under test.

On a mesh (``mesh=``, a ``launch.mesh.Mesh``; one process a rank) the
weights are placed as the prefill step's (``sharding.specs.step_placement``:
tensor- and expert-parallel over ``model``, FSDP blocks over ``data``,
gathered once a dispatch, never once a prefill position), and the slot
table, the prefill chunk and the per-slot vectors by the decode state's
plan (``sharding.specs.decode_state_plan``, allocated by
``decode_state_zeros``): a rank holds its slots of each over the batch
axes, where they divide (``decode_rows``), and its heads over
``model``.  Every rank runs the scheduler and takes the same
decisions: the clock is rank 0's, broadcast (once a tick, once an
admitted chunk, once a submit), and a fault the ``fault_hook`` raises on
any rank is agreed by all of them before the step runs (a host
all-reduce of a flag), so every rank retries or evicts together.  These
two go over a host (gloo) group, so the card's queue is never drained
for them.  A prefilled chunk's rows and first tokens are gathered over
the batch axes and each rank keeps the rows of its own slots; a tick's
retired rows are gathered the same way, so every rank's ``results``,
``stats()`` and ``records()`` are the same.  A fault raised inside a
step's collectives on one rank alone cannot be agreed on: the others
wait in the collective.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import host_comm
from repro_torch.models.module import SHAPES
from repro_torch.models.transformer import Transformer
from repro_torch.serve.config import ServeConfig
from repro_torch.sharding.parallel import gather_from_data
from repro_torch.sharding.specs import (decode_rows, decode_state_zeros,
                                        rows_comm, shard_params,
                                        step_placement)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

# request terminal states
STATUS_QUEUED = "queued"
STATUS_RUNNING = "running"
STATUS_DONE = "done"
STATUS_REJECTED = "rejected_deadline"      # expired before admission
STATUS_EVICTED_DEADLINE = "evicted_deadline"
STATUS_EVICTED_FAILURE = "evicted_failure"
TERMINAL = (STATUS_DONE, STATUS_REJECTED, STATUS_EVICTED_DEADLINE,
            STATUS_EVICTED_FAILURE)


class ServeDispatchError(RuntimeError):
    """A dispatch failed on every retry attempt."""

    def __init__(self, site: str, attempts: int, cause: Exception):
        super().__init__(f"{site} dispatch failed after {attempts} "
                         f"attempts: {cause!r}")
        self.site = site
        self.attempts = attempts
        self.cause = cause


@dataclass
class Request:
    """One client stream: prompt in, up to ``max_new`` greedy tokens out.

    The first output token is the one the prefilled prompt predicts
    (argmax of the prefill logits) — time-to-first-token is the prefill
    dispatch, not a decode tick.
    """
    rid: int
    prompt: np.ndarray                 # int32 [len], 1 <= len <= budget
    max_new: int
    deadline_s: float
    submitted: float
    status: str = STATUS_QUEUED
    admitted: Optional[float] = None
    first_token_t: Optional[float] = None
    finished: Optional[float] = None
    slot: Optional[int] = None
    retries: int = 0                   # dispatch retries this request saw
    tokens: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))

    @property
    def deadline(self) -> float:
        return self.submitted + self.deadline_s

    def record(self) -> dict:
        lat = (self.finished - self.submitted
               if self.finished is not None else None)
        ttft = (self.first_token_t - self.submitted
                if self.first_token_t is not None else None)
        return {"rid": self.rid, "status": self.status,
                "prompt_len": int(len(self.prompt)),
                "n_tokens": int(len(self.tokens)),
                "latency_s": lat, "ttft_s": ttft, "retries": self.retries}


def _signature(args) -> tuple:
    """Shapes and dtypes of every tensor in ``args``: what a step is
    specialised for."""
    return tuple((tuple(t.shape), t.dtype) for t in tree_leaves(args)
                 if isinstance(t, torch.Tensor))


def _slot_ax(t: torch.Tensor) -> int:
    """The slot axis of a slot-table leaf: per-slot scalars (pos, ring
    idx) are [S]; every stacked leaf is [L, S, ...]."""
    return 0 if t.dim() == 1 else 1


class ServeRuntime:
    """Fixed-slot continuous-batching server for decoder-only archs, on
    the card unless ``device="cpu"`` is passed (on ``mesh``, on the
    mesh's device).  ``params`` are whole; on a mesh each rank keeps its
    blocks of them."""

    def __init__(self, arch: ArchConfig, serve: ServeConfig, *,
                 params=None, seed: int = 0, mesh=None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 fault_hook: Optional[Callable[[str, int, int], None]] = None,
                 log=None, device=None):
        if arch.family == "audio":
            raise ValueError("ServeRuntime serves decoder-only archs; "
                             "audio (enc-dec) uses launch.serve.serve_whisper")
        self.arch = arch
        self.serve = serve.validate()
        self.mesh = mesh
        self.device = (resolve_device(device) if mesh is None
                       else mesh.device)
        self.clock = clock
        self.sleep = sleep
        self.fault_hook = fault_hook
        self.log = log or (lambda *a: None)
        self.slots = serve.slots
        self.max_new = serve.max_new_tokens
        self.cap = serve.max_prompt_len + serve.max_new_tokens

        # ---- placement: whole on one card; on a mesh the weights as a
        # prefill step's, the slots and the chunk's rows by the decode
        # state's plan (this rank's rows [lo, hi) of each)
        self.tp = self.fsdp = self._plan = self._host = None
        self._rows = (0, self.slots, None)
        self._chunk_rows = (0, serve.prefill_batch, None)
        if mesh is not None:
            self.tp, self.fsdp, self._plan = step_placement(
                mesh, arch, Transformer.init(SHAPES, arch))
            self._rows = decode_rows(mesh.shape, mesh.coords, self.slots)
            self._chunk_rows = decode_rows(mesh.shape, mesh.coords,
                                           serve.prefill_batch)
            self._host = host_comm(mesh)
        if params is None:
            params = Transformer.init(
                torch.Generator(device=self.device).manual_seed(seed), arch)
        self.params = (params if self._plan is None
                       else shard_params(params, self._plan))

        dev = self.device
        lo, hi, _ = self._rows
        self.state = self._zero_slot_state(self.slots)
        self.cur_tok = torch.zeros((hi - lo,), dtype=torch.int32,
                                   device=dev)
        self.counts = torch.zeros((hi - lo,), dtype=torch.int32,
                                  device=dev)
        self.out_buf = torch.zeros((hi - lo, self.max_new),
                                   dtype=torch.int32, device=dev)
        self._chunk_zero = self._zero_slot_state(serve.prefill_batch)

        # ---- compile-once claim instrumentation: each counter counts the
        # argument signatures (shapes, dtypes) its step was built for
        self.traces = {"prefill": 0, "admit": 0, "decode": 0}
        self._build_steps()

        # ---- host-side scheduler state
        self.queue: deque[Request] = deque()
        self.slot_req: list[Optional[Request]] = [None] * self.slots
        self.free: list[int] = list(range(self.slots))[::-1]
        self.counts_host = np.zeros(self.slots, np.int64)
        self.results: dict[int, Request] = {}
        self.assignments = np.zeros(self.slots, np.int64)
        self._tick = 0
        self._next_rid = 0
        self.dispatch_retries = 0
        self.evictions = {"deadline": 0, "failure": 0, "rejected": 0}

    # ------------------------------------------------------------ build
    def _zero_slot_state(self, n: int):
        """A decode state at batch ``n`` with one position per row (on a
        mesh, this rank's block of it: its rows and heads)."""
        st = Transformer.init_decode_state(self.arch, n, self.cap,
                                           device="meta")
        st = tree_map(lambda t: t.new_zeros((n,)) if t.dim() == 0 else t, st)
        return decode_state_zeros(st, self.mesh, self.arch, self.device)

    def _where_slot(self, mask, new, old):
        """Per-slot select over a slot-table tree (mask [S] bool)."""
        def sel(n, o):
            shape = [1] * n.dim()
            shape[_slot_ax(n)] = n.shape[_slot_ax(n)]
            return torch.where(mask.reshape(shape), n, o)

        return tree_map(sel, new, old)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device, copied from pinned memory so the
        host does not wait for the queued work."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _built(self, site: str, fn):
        """``fn`` that counts each new argument signature in
        ``traces[site]``."""
        seen = set()

        def call(*args):
            sig = _signature(args)
            if sig not in seen:
                seen.add(sig)
                self.traces[site] += 1
            with torch.no_grad():
                return fn(*args)

        return call

    def _whole_over_data(self, params):
        """The weights gathered over ``data`` (FSDP), once a dispatch."""
        if self.fsdp is None:
            return params
        return gather_from_data(self.fsdp, params, self._plan)

    def _build_steps(self):
        arch, tp = self.arch, self.tp
        M, P = self.max_new, self.serve.max_prompt_len
        chunk_comm = (None if self.mesh is None
                      else rows_comm(self.mesh, self._chunk_rows[2]))

        def vstep(params, tok, state):
            # every row is its own sequence: its own position, its own
            # MoE group (the JAX package's vmap over slots)
            return Transformer.decode_step(params, arch, tok, state,
                                           moe_group_size=1, tp=tp)

        def decode_fn(params, state, cur_tok, live, counts, out_buf):
            params = self._whole_over_data(params)
            lg, st2 = vstep(params, cur_tok[:, None], state)
            state = self._where_slot(live, st2, state)
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
            tok = torch.where(live, tok, cur_tok)
            idx = torch.clamp(counts, 0, M - 1).long()
            rows = torch.arange(out_buf.shape[0], device=out_buf.device)
            out_buf = out_buf.index_put(
                (rows, idx), torch.where(live, tok, out_buf[rows, idx]))
            counts = counts + live.to(torch.int32)
            return state, tok, counts, out_buf

        def prefill_fn(params, tokens, lens, state):
            # batched prefill: ONE dispatch steps the whole prompt budget
            # through the same batched decode body, masking rows past
            # their length — bit-equal to per-token stepping by
            # construction (torch.where passes the active rows' bits
            # through untouched)
            params = self._whole_over_data(params)
            logits = torch.zeros((tokens.shape[0], 1, arch.vocab),
                                 dtype=torch.float32, device=tokens.device)
            for i in range(P):
                lg, st2 = vstep(params, tokens[:, i:i + 1], state)
                state = self._where_slot(i < lens, st2, state)
                logits = torch.where((i == lens - 1)[:, None, None], lg,
                                     logits)
            first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            return state, first

        def admit_fn(state, cur_tok, counts, out_buf, cstate, first, src,
                     take):
            # each slot that takes a prefilled chunk row (``take``) takes
            # row ``src`` of the chunk; every other slot keeps its own.
            # On a mesh the chunk's rows are first gathered over the
            # batch axes, and each rank selects into its own slots
            if chunk_comm is not None:
                leaves = tree_leaves(cstate)
                got = chunk_comm.all_gather_tree(
                    [t.movedim(_slot_ax(t), 0) for t in leaves] + [first],
                    "admit")
                cstate = tree_unflatten_like(cstate, [
                    g.movedim(0, _slot_ax(t))
                    for t, g in zip(leaves, got[:-1])])
                first = got[-1]

            def sel(leaf, cleaf):
                ax = _slot_ax(leaf)
                shape = [1] * leaf.dim()
                shape[ax] = -1
                return torch.where(take.reshape(shape),
                                   cleaf.index_select(ax, src), leaf)

            state = tree_map(sel, state, cstate)
            mine = first.index_select(0, src)
            cur_tok = torch.where(take, mine, cur_tok)
            counts = torch.where(take, torch.ones_like(counts), counts)
            col = torch.where(take, mine, out_buf[:, 0])
            out_buf = torch.cat([col[:, None], out_buf[:, 1:]], dim=1)
            return state, cur_tok, counts, out_buf

        self._decode = self._built("decode", decode_fn)
        self._prefill = self._built("prefill", prefill_fn)
        self._admit = self._built("admit", admit_fn)

    # --------------------------------------------------------- dispatch
    def _now(self) -> float:
        """The clock; on a mesh of more than one rank, rank 0's reading,
        broadcast over the host group (census ``host/broadcast/clock``)."""
        t = self.clock()
        if self._host is None:
            return t
        return float(self._host.broadcast(
            torch.tensor([t], dtype=torch.float64), "clock")[0])

    def _fault_check(self, site: str, attempt: int) -> None:
        """Run the fault hook; on a mesh of more than one rank, raise on
        every rank when it raised on any (a host all-reduce of the
        flag, census ``host/all_reduce/fault``), before any rank starts
        the step's collectives."""
        err = None
        if self.fault_hook is not None:
            try:
                self.fault_hook(site, self._tick, attempt)
            except Exception as e:      # noqa: BLE001 — any planted fault
                err = e
        if self._host is not None:
            flag = torch.tensor([int(err is not None)], dtype=torch.int32)
            if int(self._host.all_reduce(flag, "fault")[0]) and err is None:
                err = RuntimeError(f"{site} failed on another rank")
        if err is not None:
            raise err

    def _dispatch(self, site: str, fn, *args):
        """Run one dispatch under the retry/backoff budget."""
        last = None
        for attempt in range(self.serve.max_retries + 1):
            try:
                self._fault_check(site, attempt)
                out = fn(*args)
            except Exception as e:      # noqa: BLE001 — any dispatch fault
                last = e
                self.dispatch_retries += int(
                    attempt < self.serve.max_retries)
                if attempt < self.serve.max_retries:
                    if self.serve.backoff_base_s > 0:
                        self.sleep(self.serve.backoff_base_s
                                   * (2.0 ** attempt))
                    continue
                raise ServeDispatchError(site, attempt + 1, e) from e
            return out, attempt
        raise ServeDispatchError(site, self.serve.max_retries + 1, last)

    # ----------------------------------------------------------- submit
    def submit(self, prompt: Sequence[int], *, max_new: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue one request; returns its rid.  An empty prompt is a
        BOS-0 prompt (matching ``serve_decoder_only``'s prompt_len=0
        semantics: generation starts from token 0's prediction)."""
        toks = np.asarray(list(prompt) or [0], np.int32)
        if len(toks) > self.serve.max_prompt_len:
            raise ValueError(
                f"prompt of {len(toks)} tokens exceeds the static budget "
                f"serve.max_prompt_len={self.serve.max_prompt_len}")
        if (toks < 0).any() or (toks >= self.arch.vocab).any():
            raise ValueError("prompt token out of vocab range")
        mn = self.max_new if max_new is None else int(max_new)
        if not 1 <= mn <= self.max_new:
            raise ValueError(f"max_new={mn} must be in [1, "
                             f"{self.max_new}]")
        req = Request(rid=self._next_rid, prompt=toks, max_new=mn,
                      deadline_s=(self.serve.deadline_s if deadline_s is None
                                  else float(deadline_s)),
                      submitted=self._now())
        self._next_rid += 1
        self.queue.append(req)
        self.results[req.rid] = req
        return req.rid

    # ------------------------------------------------------- scheduling
    def live_requests(self) -> list[Request]:
        return [r for r in self.slot_req if r is not None]

    @property
    def n_live(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def _retire(self, slot: int, status: str, now: float, out: np.ndarray):
        """Hand slot ``slot`` back; ``out`` is the host's copy of
        ``out_buf``."""
        req = self.slot_req[slot]
        n = int(self.counts_host[slot])
        req.tokens = out[slot, :n].astype(np.int32)
        req.status = status
        req.finished = now
        self.slot_req[slot] = None
        self.counts_host[slot] = 0
        self.free.append(slot)

    def _evict_chunk(self, chunk: list[Request], slots: list[int],
                     attempts: int, now: float):
        for r in chunk:
            r.retries += attempts - 1
            r.status = STATUS_EVICTED_FAILURE
            r.finished = now
            self.evictions["failure"] += 1
        self.free.extend(slots)

    def _out_rows(self) -> np.ndarray:
        """Every slot's ``out_buf`` row on the host: on a mesh whose
        slots split over the batch axes, gathered over them first
        (census ``all_gather/retire``)."""
        comm = (None if self.mesh is None
                else rows_comm(self.mesh, self._rows[2]))
        buf = (self.out_buf if comm is None
               else comm.all_gather(self.out_buf, "retire"))
        return buf.cpu().numpy()

    def _upload_rows(self, a: np.ndarray, rows) -> torch.Tensor:
        """This rank's rows ``[lo, hi)`` of a host array, on the device."""
        lo, hi, _ = rows
        return self._upload(np.ascontiguousarray(a[lo:hi]))

    def step(self) -> None:
        """One scheduler tick: retire / expire / admit / decode."""
        now = self._now()
        self._tick += 1
        out = None                      # out_buf on the host, read once

        def host_out():
            nonlocal out
            if out is None:
                out = self._out_rows()
            return out

        # 1. retire slots whose generation budget is met
        for s, req in enumerate(self.slot_req):
            if req is not None and self.counts_host[s] >= req.max_new:
                self._retire(s, STATUS_DONE, now, host_out())
        # 2. deadlines: expired in-flight slots are evicted with their
        # partial output; expired queued requests never consume compute
        for s, req in enumerate(self.slot_req):
            if req is not None and now > req.deadline:
                self._retire(s, STATUS_EVICTED_DEADLINE, now, host_out())
                self.evictions["deadline"] += 1
        kept = deque()
        for req in self.queue:
            if now > req.deadline:
                req.status = STATUS_REJECTED
                req.finished = now
                self.evictions["rejected"] += 1
            else:
                kept.append(req)
        self.queue = kept
        # 3. admission: chunked batched prefill into free slots
        while self.queue and self.free:
            self._admit_chunk(now)
        # 4. decode: one batched step advances every live slot
        live_idx = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not live_idx:
            return
        live = np.zeros(self.slots, bool)
        live[live_idx] = True
        try:
            (self.state, self.cur_tok, self.counts, self.out_buf), att = \
                self._dispatch("decode", self._decode, self.params,
                               self.state, self.cur_tok,
                               self._upload_rows(live, self._rows),
                               self.counts, self.out_buf)
        except ServeDispatchError:
            # decode failures carry no per-slot blame — evict every live
            # slot with its partial output and keep the runtime serving
            self.log(f"[serve] decode dispatch exhausted at tick "
                     f"{self._tick}; evicting {len(live_idx)} live slots")
            for s in live_idx:
                self.slot_req[s].retries += self.serve.max_retries
                self._retire(s, STATUS_EVICTED_FAILURE, now, host_out())
                self.evictions["failure"] += 1
            return
        if att:
            for s in live_idx:
                self.slot_req[s].retries += att
        self.counts_host[live_idx] += 1

    def _admit_chunk(self, now: float) -> None:
        Pb = self.serve.prefill_batch
        n = min(len(self.queue), len(self.free), Pb)
        chunk = [self.queue.popleft() for _ in range(n)]
        slots = [self.free.pop() for _ in range(n)]
        # each of this rank's slots [lo, hi): the chunk row it takes, if
        # one was admitted to it
        lo, hi, _ = self._rows
        src = np.zeros(hi - lo, np.int64)
        take = np.zeros(hi - lo, bool)
        for i, s in enumerate(slots):
            if lo <= s < hi:
                src[s - lo], take[s - lo] = i, True
        tokens = np.zeros((Pb, self.serve.max_prompt_len), np.int32)
        lens = np.zeros(Pb, np.int32)
        for i, r in enumerate(chunk):
            tokens[i, :len(r.prompt)] = r.prompt
            lens[i] = len(r.prompt)
        try:
            (cstate, first), att = self._dispatch(
                "prefill", self._prefill, self.params,
                self._upload_rows(tokens, self._chunk_rows),
                self._upload_rows(lens, self._chunk_rows), self._chunk_zero)
        except ServeDispatchError:
            self.log(f"[serve] prefill dispatch exhausted at tick "
                     f"{self._tick}; evicting {n} queued requests")
            self._evict_chunk(chunk, slots, self.serve.max_retries + 1, now)
            return
        (self.state, self.cur_tok, self.counts, self.out_buf), _ = \
            self._dispatch("admit", self._admit, self.state, self.cur_tok,
                           self.counts, self.out_buf, cstate, first,
                           self._upload(src), self._upload(take))
        first.cpu()                     # the first tokens exist: TTFT
        t_first = self._now()
        for i, r in enumerate(chunk):
            r.status = STATUS_RUNNING
            r.slot = slots[i]
            r.admitted = now
            r.first_token_t = t_first
            r.retries += att
            self.slot_req[slots[i]] = r
            self.counts_host[slots[i]] = 1
            self.assignments[slots[i]] += 1

    def drain(self, max_ticks: int = 100_000) -> None:
        """Step until the queue and slot table are empty."""
        ticks = 0
        while self.queue or self.n_live:
            self.step()
            ticks += 1
            if ticks >= max_ticks:
                raise RuntimeError(
                    f"serve drain made no progress in {max_ticks} ticks "
                    f"({len(self.queue)} queued, {self.n_live} live)")

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        reqs = list(self.results.values())
        by = {s: sum(r.status == s for r in reqs) for s in TERMINAL}
        return {
            "requests": len(reqs),
            "by_status": by,
            "tokens_out": int(sum(len(r.tokens) for r in reqs)),
            "ticks": self._tick,
            "dispatch_retries": self.dispatch_retries,
            "evictions": dict(self.evictions),
            "slot_assignments": self.assignments.tolist(),
            "max_slot_reuse": int(self.assignments.max(initial=0)),
            "traces": dict(self.traces),
        }

    def records(self) -> list[dict]:
        return [self.results[rid].record() for rid in sorted(self.results)]
