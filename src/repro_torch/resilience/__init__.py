"""Fault-tolerant training runtime: guards, recovery, fault injection
(port of ``repro.resilience``).

Four pieces, split by where they run:

* :mod:`~repro_torch.resilience.guards`  — torch health checks folded
  into the round (NaN/Inf + EMA loss-spike).
* :mod:`~repro_torch.resilience.policy`  — the host-side
  :class:`RecoveryController` (quarantine ledger, retry budget,
  last-good snapshot ring, telemetry).
* :mod:`~repro_torch.resilience.faults`  — deterministic fault-injection
  streams (pure (seed, salt, round) fold-ins, scenario-profile style).
* :mod:`~repro_torch.resilience.config`  — the serializable
  :class:`ResilienceConfig` riding ``ExperimentConfig.resilience``.

The null config is free: no guard phase, no controller, no snapshots —
the guard-free round, op for op.
"""
from repro_torch.resilience.config import ACTIONS, ResilienceConfig
from repro_torch.resilience.faults import (FaultConfig, FaultInjectedError,
                                           FaultStream, add_fault_arguments,
                                           build_fault_stream)
from repro_torch.resilience.guards import (HEALTH_EMA, HEALTH_NONFINITE,
                                           HEALTH_SLOT_ANY, HEALTH_SPIKE,
                                           ema_update, health_vector,
                                           masked_tree_all_finite,
                                           slot_nonfinite, tree_all_finite)
from repro_torch.resilience.policy import (FAULT_KINDS, RecoveryController,
                                           ResilienceExhaustedError,
                                           quarantine_mask)

__all__ = [
    "ACTIONS", "ResilienceConfig",
    "FaultConfig", "FaultInjectedError", "FaultStream",
    "add_fault_arguments", "build_fault_stream",
    "HEALTH_EMA", "HEALTH_NONFINITE", "HEALTH_SLOT_ANY", "HEALTH_SPIKE",
    "ema_update", "health_vector", "masked_tree_all_finite",
    "slot_nonfinite", "tree_all_finite",
    "FAULT_KINDS", "RecoveryController", "ResilienceExhaustedError",
    "quarantine_mask",
]
