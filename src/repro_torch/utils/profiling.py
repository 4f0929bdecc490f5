"""Host-side round profiling: where a training round's wall time goes.

Port of ``repro/utils/profiling.py``, with the reference's public names:

* :class:`RoundProfiler` — wall time of the HOST sections of
  ``Engine.run()``: ``sample`` (cohort draw, padding and the copy to the
  device), ``dispatch`` (the round's, or the pipelined tail's, calls),
  ``sync`` (the host blocks on the round's work: on the card
  ``torch.cuda.synchronize``, on the CPU the loss is read) and ``eval``.
  Pass one to ``Engine(..., profiler=...)``; ``result["profile"]`` is
  its :meth:`~RoundProfiler.summary`.  Without one the run loop enters
  a shared no-op context and nothing else changes.

* :func:`phase_costs` — wall time of each phase of the Engine's
  program.  The port runs a round eagerly, phase after phase, but the
  card runs them asynchronously behind the host, so a phase is not
  timed from inside a round either: as in the reference every program
  *prefix* (phases[:1], phases[:2], ...) runs as a round of its own,
  timed between ``torch.cuda.synchronize()`` calls, and the difference
  between consecutive prefixes is the appended phase's cost.  A delta
  can be negative where a longer prefix does less work than a shorter
  one (report it as it is).

* :func:`round_census` — the reference's ``round_hlo`` feeds its
  collective census (``repro.utils.hlo_cost.collective_census``); the
  port's collectives count themselves
  (``sharding.collectives.Collectives``), so this returns one round's
  census of the Engine's mesh instead.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

NULL_SECTION = nullcontext()      # reentrant no-op for unprofiled runs


class RoundProfiler:
    """Accumulates wall time of named host-side sections (see the
    module's docstring for the ones the Engine opens).  ``dispatch``
    measuring ms where the device's work takes µs is the sign that the
    host, not the card, sets the round's pace."""

    def __init__(self):
        self.total_s: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)

    @contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total_s[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(total, 6),
                "calls": self.calls[name],
                "mean_ms": round(total / max(1, self.calls[name]) * 1e3, 3),
            }
            for name, total in sorted(self.total_s.items())
        }


@contextmanager
def _borrow_sampler(eng):
    """Run throwaway cohort draws without moving the Engine's sampling
    clock or its telemetry (both are restored on exit, so a profiled
    Engine still replays the exact cohort stream)."""
    clock, ntel = eng._sample_clock, len(eng._telemetry)
    try:
        yield
    finally:
        eng._sample_clock = clock
        del eng._telemetry[ntel:]


def _one_round_args(eng, algo):
    """A fresh state placed as ``algo`` places it and one sampled round's
    inputs: the arguments of ``algo.round``."""
    from repro_torch.api.phases import place_state
    rng = np.random.default_rng(eng.cfg.seed + 1)
    state = place_state(eng.init_state(), algo.store_rows, algo.task)
    with _borrow_sampler(eng):
        cohort, xs, ys, mask = eng.sample_round(rng)
    return state, cohort, xs, ys, eng.round_key(0), mask


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_names(program) -> list[str]:
    """The program's phase class names in order, a repeated class marked
    with ``'`` (the keys of :func:`phase_costs`)."""
    out: list[str] = []
    for phase in program.phases:
        name = type(phase).__name__
        while name in out:
            name += "'"
        out.append(name)
    return out


def phase_costs(eng, repeats: int = 5) -> dict:
    """Steady-state cost of each phase of the Engine's round, by prefix
    timing.  Returns ``{phase_name: {cum_ms, delta_ms}}`` in program
    order: ``cum_ms`` is the median time of the prefix round ending at
    that phase, ``delta_ms`` its difference from the previous prefix's.
    Each prefix runs once untimed first (first launches, cuBLAS and
    cuDNN set-up)."""
    from repro_torch.api.phases import RoundProgram, build_algorithm
    from repro_torch.api.registry import get_program
    from repro_torch.optim import adam

    cfg = eng.cfg
    prog = get_program(cfg.algo)
    opt_s, opt_c = adam(cfg.lr_server), adam(cfg.lr_client)
    out: dict[str, dict] = {}
    prev = 0.0
    for k, name in enumerate(phase_names(prog), start=1):
        sub = RoundProgram(prog.name, prog.phases[:k],
                           prog.uses_global_client)
        algo = build_algorithm(sub, eng.task, opt_s, opt_c, cfg.cycle,
                               device=eng.device, mesh=eng.mesh,
                               shard_data=cfg.shard_cohort,
                               n_clients=eng.fed.n_clients)
        args = _one_round_args(eng, algo)
        algo.round(*args)                          # warm
        _sync(eng.device)
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            algo.round(*args)
            _sync(eng.device)
            ts.append(time.perf_counter() - t0)
        cum = float(np.median(ts)) * 1e3
        out[name] = {"cum_ms": round(cum, 3), "delta_ms": round(cum - prev, 3)}
        prev = cum
    return out


def round_census(eng) -> dict:
    """One round's census of every collective group of the Engine's mesh
    (``"{op}/{what}"`` -> calls and bytes, a group's axis prefixed), the
    port's counterpart of the reference's HLO collective census; ``{}``
    without a mesh.  The round runs from a fresh state on a borrowed
    cohort draw, and the groups' running censuses are left as they were."""
    if eng.mesh is None:
        return {}
    comms = mesh_comms(eng.mesh)
    before = [dict(c.census) for c in comms]
    for c in comms:
        c.census = {}
    try:
        eng.algo.round(*_one_round_args(eng, eng.algo))
        _sync(eng.device)
        out: dict = {}
        for c in comms:
            out.update(c.census)
    finally:
        for c, saved in zip(comms, before):
            c.census = saved
    return out


def mesh_comms(mesh) -> list:
    """The distinct collective groups of ``mesh``: its ``model`` axis',
    its batch axes', its ``data`` axis' where that is a group of its own
    and its kv head groups' (``Mesh.kv_comms``, census ``"kv/..."``)."""
    out: list = []
    kv = [c for _, c in sorted(mesh.kv_comms.items())]
    for comm in (mesh.model_comm, mesh.comm, mesh.data_comm, *kv):
        if comm is not None and all(comm is not c for c in out):
            out.append(comm)
    return out
