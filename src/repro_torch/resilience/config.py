"""Serializable resilience knobs (rides ``ExperimentConfig.resilience``).

A copy of ``repro/resilience/config.py``.  The null config
(``ResilienceConfig()``) is the contract anchor: no guard phase is
appended, no recovery controller is built, no snapshot is taken — the
Engine runs the guard-free round op for op.
"""
from __future__ import annotations

import argparse
from dataclasses import asdict, dataclass, field, fields

from repro_torch.resilience.faults import FaultConfig

# recovery actions a policy can name, in escalation order: an action
# that cannot apply (no blamable slot, empty snapshot ring) falls
# through to the next one rather than wedging the round
ACTIONS = ("ignore", "quarantine", "retry", "rollback")


@dataclass(frozen=True)
class ResilienceConfig:
    """Health guards + per-fault recovery policies + fault injection.

    ``guard=True`` appends the :class:`~repro_torch.api.phases.HealthGuard`
    phase to the round (NaN/Inf over loss, feature grads,
    and the committed TrainState, plus the EMA loss-spike detector) and
    arms the Engine's recovery controller.  The three ``on_*`` knobs
    pick the action per fault kind:

    * ``quarantine`` — zero the blamed cohort slots in the attendance
      mask (the scenario churn machinery), ban those clients from future
      cohorts, and re-run the round from the pre-round state.
    * ``retry``      — re-run the round from the pre-round state after
      exponential backoff (transient faults clear on redraw).
    * ``rollback``   — restore the newest snapshot from the in-memory
      last-good ring and re-run the current round from it.
    * ``ignore``     — record telemetry, accept the round as-is.
    """
    guard: bool = False
    on_nonfinite: str = "quarantine"  # NaN/Inf in loss/grads/params
    on_spike: str = "ignore"          # EMA loss-spike divergence
    on_error: str = "retry"           # dispatch raised (host exception)
    max_retries: int = 3              # recovery attempts per round
    backoff_base_s: float = 0.0       # sleep base * 2^(attempt-1) between
                                      # attempts (0 = no backoff, tests)
    ring_size: int = 2                # last-good TrainState snapshots
    snapshot_every: int = 1           # accepted rounds between snapshots
    ema_alpha: float = 0.1            # loss-EMA smoothing
    spike_factor: float = 4.0         # loss > factor * EMA = spike
    spike_warmup: int = 5             # accepted rounds before spikes arm
    faults: FaultConfig = field(default_factory=FaultConfig)

    # -------------------------------------------------------- round-trips
    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ResilienceConfig":
        d = dict(d)
        faults = d.pop("faults", {})
        if not isinstance(faults, FaultConfig):
            faults = FaultConfig.from_dict(faults)
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise KeyError(
                f"unknown ResilienceConfig fields: {sorted(unknown)}")
        return cls(faults=faults, **d)

    def validate(self) -> "ResilienceConfig":
        for name in ("on_nonfinite", "on_spike", "on_error"):
            action = getattr(self, name)
            if action not in ACTIONS:
                raise ValueError(f"resilience.{name}={action!r}: expected "
                                 f"one of {ACTIONS}")
        if self.max_retries < 0:
            raise ValueError(f"resilience.max_retries={self.max_retries} "
                             "must be >= 0")
        if self.ring_size < 1:
            raise ValueError(f"resilience.ring_size={self.ring_size} "
                             "must be >= 1")
        if self.snapshot_every < 1:
            raise ValueError(f"resilience.snapshot_every="
                             f"{self.snapshot_every} must be >= 1")
        if self.backoff_base_s < 0:
            raise ValueError(f"resilience.backoff_base_s="
                             f"{self.backoff_base_s} must be >= 0")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError(f"resilience.ema_alpha={self.ema_alpha} must "
                             "be in (0, 1]")
        if self.spike_factor <= 1.0:
            raise ValueError(f"resilience.spike_factor={self.spike_factor} "
                             "must be > 1")
        self.faults.validate()
        return self

    @property
    def active(self) -> bool:
        """True when the Engine must build a recovery controller (guards
        armed, or faults injected — an injected dispatch error needs the
        controller even with guards off)."""
        return self.guard or self.faults.any

    @property
    def quarantines(self) -> bool:
        return self.guard and "quarantine" in (self.on_nonfinite,
                                               self.on_spike, self.on_error)

    # -------------------------------------------------------------- flags
    @staticmethod
    def add_arguments(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
        from repro_torch.resilience.faults import add_fault_arguments
        ap.add_argument("--guard", action="store_true",
                        help="arm the in-round health guards (NaN/Inf + loss "
                             "spike) and the recovery controller")
        ap.add_argument("--on-nonfinite", default="quarantine",
                        choices=ACTIONS,
                        help="recovery action for NaN/Inf faults")
        ap.add_argument("--on-spike", default="ignore", choices=ACTIONS,
                        help="recovery action for loss-spike divergence")
        ap.add_argument("--on-error", default="retry", choices=ACTIONS,
                        help="recovery action for dispatch exceptions")
        ap.add_argument("--max-retries", type=int, default=3,
                        help="recovery attempts per round before the run "
                             "gives up")
        ap.add_argument("--backoff-base-s", type=float, default=0.0,
                        help="exponential-backoff base between recovery "
                             "attempts (seconds)")
        ap.add_argument("--snapshot-ring", type=int, default=2,
                        help="in-memory last-good TrainState snapshots "
                             "kept for rollback")
        add_fault_arguments(ap)
        return ap

    @classmethod
    def from_flags(cls, args: argparse.Namespace) -> "ResilienceConfig":
        return cls(guard=args.guard,
                   on_nonfinite=args.on_nonfinite,
                   on_spike=args.on_spike,
                   on_error=args.on_error,
                   max_retries=args.max_retries,
                   backoff_base_s=args.backoff_base_s,
                   ring_size=args.snapshot_ring,
                   faults=FaultConfig.from_spec(args.faults,
                                                seed=args.faults_seed)
                   ).validate()
