"""Client-drift / gradient-stability bookkeeping (paper Table 6).

Port of ``repro/core/drift.py``: aggregates the rounds'
``feat_grad_norm_*`` metrics across a run.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class GradStabilityTracker:
    means: list = field(default_factory=list)
    stds: list = field(default_factory=list)

    def update(self, metrics: dict):
        # keep the device scalars: reading them here would sync the host
        # every round; summary() reads them all in one transfer
        self.means.append(metrics["feat_grad_norm_mean"])
        self.stds.append(metrics["feat_grad_norm_std"])

    def summary(self) -> dict:
        def host(vals):
            if vals and isinstance(vals[0], torch.Tensor):
                return torch.stack([v.reshape(()) for v in vals]).cpu().tolist()
            return [float(v) for v in vals]
        self.means, self.stds = host(self.means), host(self.stds)
        m = np.asarray(self.means)
        return {
            "grad_norm_mean": float(m.mean()) if len(m) else float("nan"),
            "grad_norm_std_over_rounds": float(m.std()) if len(m) else float("nan"),
            "grad_norm_within_batch_std": float(np.mean(self.stds)) if self.stds else float("nan"),
        }
