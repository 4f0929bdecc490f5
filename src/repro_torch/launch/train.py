"""Federated split-learning training CLI for the PyTorch port.

Thin front end over ``repro_torch.api.Engine``.  It runs on the card
(``--device cuda``, the default) and raises where there is none; pass
``--device cpu`` to run on the CPU.  The flags are
``ExperimentConfig.add_arguments``'s, the checkpoint (``--ckpt-dir``,
``--resume``), scenario (``--scenario*``) and resilience (``--guard``,
``--on-*``, ``--faults``) flags included.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train \
      --algo cyclesfl --task image --rounds 200 --clients 100 --width 32

On N cards of one host, one rank a card (``--no-shard-cohort`` runs the
whole round on every rank); rank 0 prints.  ``--mesh-shape d,m`` places
the weights as the reference's 2-D mesh does (FSDP over ``data``, the
dense stages' columns over ``model``; d * m = N):
  PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train \
      --mesh-shape N,1 --rounds 200 --clients 100 --width 32
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --mesh-shape 2,2 --rounds 200 --clients 100 --width 32
Every other flag combines with ``--mesh-shape`` (``--pipeline-depth``,
``--ckpt-dir``/``--resume``, the guard's and the scenario's): rank 0
writes the checkpoints, and every rank resumes from the step it chose.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.api import Engine, ExperimentConfig
from repro_torch.core.cyclesl import CycleConfig


def run(algo_name: str, task_name: str = "image", rounds: int = 100,
        n_clients: int = 100, attendance: float = 0.05, batch: int = 16,
        lr_server: float = 1e-3, lr_client: float = 1e-3, alpha: float = 0.5,
        server_epochs: int = 1, seed: int = 0, width: int = 16, cut: int = 2,
        eval_every: int = 20, ckpt_dir: str | None = None, device=None,
        log=print):
    """Kwargs-style wrapper; new code constructs an ExperimentConfig and
    an Engine directly.  ``device=None`` trains on the card."""
    cfg = ExperimentConfig(
        algo=algo_name, task=task_name, rounds=rounds, n_clients=n_clients,
        attendance=attendance, batch=batch, lr_server=lr_server,
        lr_client=lr_client, alpha=alpha, seed=seed, width=width, cut=cut,
        eval_every=eval_every, ckpt_dir=ckpt_dir,
        cycle=CycleConfig(server_epochs=server_epochs))
    return Engine(cfg, device=device, log=log).run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ExperimentConfig.add_arguments(ap)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cfg = ExperimentConfig.from_flags(args)
    # every rank of a mesh trains; rank 0 (torchrun's RANK) reports
    lead = int(os.environ.get("RANK", "0")) == 0
    eng = Engine(cfg, device=args.device,
                 log=print if lead else (lambda *a: None))
    try:
        res = eng.run()
    finally:
        eng.close()
    if not lead:
        return res
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res["history"][-1] if res["history"] else {}, indent=1))
    return res


if __name__ == "__main__":
    main()
