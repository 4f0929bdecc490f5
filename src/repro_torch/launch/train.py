"""Federated split-learning training CLI for the PyTorch port.

Thin front end over ``repro_torch.api.Engine``.  It runs on the card
(``--device cuda``, the default) and raises where there is none; pass
``--device cpu`` to run on the CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train \
      --algo cyclesfl --task image --rounds 200 --clients 100 --width 32
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.api import Engine, ExperimentConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ExperimentConfig.add_arguments(ap)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cfg = ExperimentConfig.from_flags(args)
    res = Engine(cfg, device=args.device).run()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res["history"][-1] if res["history"] else {}, indent=1))
    return res


if __name__ == "__main__":
    main()
