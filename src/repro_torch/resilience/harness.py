"""Crash/resume worker: the subprocess half of the SIGKILL-mid-round proof.

Port of ``repro/resilience/harness.py``.  Runs a small image-task Engine
with ``eval_every=1`` (one checkpoint per round) and prints its result
as one JSON line, so a driver (the test suite, ``chip_smoke.py``, or a
human) can:

1. launch it, wait for ``step_K`` to appear, and SIGKILL it mid-round;
2. relaunch with ``--resume`` and compare the resumed history tail
   against an uninterrupted run.

``--sleep-per-round`` widens the kill window deterministically (a plain
``time.sleep`` inside an ``on_round`` callback — the round's work is
done when it fires, so the kill always lands between a committed round
and the next checkpoint, never inside the atomic write's rename).

It runs on the card unless ``--device cpu`` is given; ``--pipeline-depth``
and ``--pipeline-staleness`` run the pipelined schedule.

Usage::

    python -m repro_torch.resilience.harness --ckpt-dir ck --rounds 6
    python -m repro_torch.resilience.harness --ckpt-dir ck --rounds 6 \
        --resume --out result.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.resilience.config import ResilienceConfig
from repro_torch.resilience.faults import FaultConfig


class _SleepEachRound:
    def __init__(self, seconds: float):
        self.seconds = seconds

    def on_round(self, engine, rnd, state, metrics):
        if self.seconds > 0:
            time.sleep(self.seconds)


def build_engine(args):
    # imported here so ``--help`` stays fast
    from repro_torch.api.config import ExperimentConfig
    from repro_torch.api.engine import Engine

    cfg = ExperimentConfig(
        algo=args.algo, task="image", rounds=args.rounds,
        n_clients=args.clients, attendance=args.attendance,
        min_cohort=2, batch=args.batch, eval_every=1,
        width=8, cut=1, seed=args.seed,
        pipeline_depth=args.pipeline_depth,
        pipeline_staleness=args.pipeline_staleness,
        ckpt_dir=args.ckpt_dir, resume=args.resume,
        resilience=ResilienceConfig(
            guard=args.guard,
            faults=FaultConfig.from_spec(args.faults)),
    )
    return Engine(cfg, device=args.device,
                  callbacks=(_SleepEachRound(args.sleep_per_round),),
                  log=lambda *a: print(*a, file=sys.stderr))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--algo", default="cyclesfl")
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--attendance", type=float, default=0.25)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restore from the newest valid checkpoint")
    ap.add_argument("--guard", action="store_true",
                    help="arm the in-round health guards")
    ap.add_argument("--faults", default="",
                    help="fault-injection spec (see "
                         "repro_torch.resilience.faults)")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="run the pipelined (extract, tail) schedule "
                         "with this ring depth (0 = sequential)")
    ap.add_argument("--pipeline-staleness", default="sync",
                    choices=("sync", "async"),
                    help="sync = barrier mode (bit for bit the sequential "
                         "run); async = bounded-stale extraction")
    ap.add_argument("--sleep-per-round", type=float, default=0.0,
                    help="host sleep after each round (widens the "
                         "SIGKILL window for the crash test)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    ap.add_argument("--out", default=None,
                    help="write the result JSON here (default: stdout)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    result = build_engine(args).run()
    payload = json.dumps({
        "history": result["history"],
        "resumed_from_round": result.get("resumed_from_round", 0),
        "resilience": result.get("resilience"),
    })
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
    else:
        print(payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
