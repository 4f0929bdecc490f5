"""Closed-loop load generator + latency statistics for ServeRuntime.

Port of ``repro/serve/loadgen.py``: the prompts are numpy draws, so
both packages serve the same ones.  ``run_closed_loop`` keeps exactly
``concurrency`` requests outstanding against one runtime: each
completed request is immediately replaced until ``n_requests`` have
been submitted, then the runtime drains.  A closed loop measures the
slot table's steady-state throughput at a given client population.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.serve.runtime import ServeRuntime, STATUS_DONE, TERMINAL


def percentiles(xs, qs=(50, 90, 99)) -> dict:
    xs = [x for x in xs if x is not None]
    if not xs:
        return {f"p{q}": None for q in qs}
    return {f"p{q}": float(np.percentile(np.asarray(xs), q)) for q in qs}


def make_prompts(n: int, max_prompt_len: int, vocab: int,
                 seed: int = 0) -> list[np.ndarray]:
    """Deterministic mixed-length prompt set (lengths 1..budget)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ln = int(rng.integers(1, max_prompt_len + 1))
        out.append(rng.integers(0, vocab, size=ln).astype(np.int32))
    return out


def run_closed_loop(rt: ServeRuntime, prompts: list[np.ndarray], *,
                    concurrency: int, max_ticks: int = 100_000,
                    deadline_s: Optional[float] = None) -> dict:
    """Serve ``prompts`` keeping ``concurrency`` requests in flight.

    Returns a bench row: throughput (tokens/s, requests/s over the
    wall-clock window), latency and time-to-first-token percentiles
    (seconds), and terminal-status counts.
    """
    pending = list(prompts)[::-1]           # submit in order via pop()
    t0 = rt.clock()
    outstanding: set[int] = set()
    submitted: list[int] = []               # THIS call's request ids — the
    #                                         runtime's results dict is
    #                                         shared across calls on a
    #                                         reused runtime
    ticks = 0
    while pending or outstanding:
        while pending and len(outstanding) < concurrency:
            rid = rt.submit(pending.pop(), deadline_s=deadline_s)
            submitted.append(rid)
            outstanding.add(rid)
        rt.step()
        outstanding = {rid for rid in outstanding
                       if rt.results[rid].status not in TERMINAL}
        ticks += 1
        if ticks >= max_ticks:
            raise RuntimeError(f"closed loop stalled after {max_ticks} "
                               f"ticks ({len(pending)} pending, "
                               f"{len(outstanding)} outstanding)")
    elapsed = max(rt.clock() - t0, 1e-9)
    reqs = [rt.results[rid] for rid in submitted]
    done = [r for r in reqs if r.status == STATUS_DONE]
    toks = sum(len(r.tokens) for r in done)
    return {
        "concurrency": concurrency,
        "n_requests": len(prompts),
        "elapsed_s": elapsed,
        "ticks": ticks,
        "throughput_tok_s": toks / elapsed,
        "throughput_req_s": len(done) / elapsed,
        "latency_s": percentiles([r.finished - r.submitted for r in done
                                  if r.finished is not None]),
        "ttft_s": percentiles([r.first_token_t - r.submitted
                               for r in done
                               if r.first_token_t is not None]),
        "by_status": {s: sum(r.status == s for r in reqs)
                      for s in TERMINAL},
    }
