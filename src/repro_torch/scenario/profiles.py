"""Client population profiles + deterministic per-round churn streams.

A numpy copy of ``repro/scenario/profiles.py``: every draw folds the
same ``(seed, salt, round)`` into ``np.random.default_rng``, so the
port's streams equal the JAX package's exactly.

The paper's protocol (non-iid data, partial attendance) is the *easy*
corner of what a production split-learning fleet sees.  This module adds
the missing axes as data, not as new execution paths:

* :class:`ClientProfile` — per-client compute multiplier, bandwidth,
  mid-round dropout hazard, and staleness bound.
* :class:`ProfileStream` — deterministic, seedable generators (uniform,
  pareto-straggler, diurnal-churn) that emit per-round, per-cohort-slot
  **drop** and **lag** events as plain numpy arrays, plus optional
  per-round attendance *weights* for cohort sampling.
* :class:`ScenarioConfig` — the serializable knob block that rides
  ``ExperimentConfig.scenario`` (``to_dict``/``from_dict``/flags).

Design rule: churn folds into machinery the Engine already has.  A
mid-round dropout zeroes the slot's entry in the compile-once attendance
mask *before* ``ServerUpdate`` consumes its pooled features and before
``Commit`` writes it back — exactly the padded-slot semantics, so the
round's shapes never change.  A straggler whose drawn
delivery lag exceeds its staleness bound misses the round (dropped); one
within the bound delivers against the bounded-stale snapshot the
pipelined schedule already carries (``pipeline_staleness='async'`` = the
θ snapshot is exactly one round old).  The null scenario
(``kind='none'``) builds no stream at all — the Engine path is
bit-for-bit the scenario-free one.

Determinism contract: every stream draw is keyed by
``(scenario seed, salt, round)`` through ``np.random.default_rng`` — a
pure fold-in, never a stateful stream — so ``events(rnd, cohort)`` is
identical under replay regardless of call order or history (resume
needs no event replay; the property suite pins this).
"""
from __future__ import annotations

import argparse
from dataclasses import asdict, dataclass, fields
from typing import NamedTuple, Optional

import numpy as np

# fixed fold-in salts (never derived from hash(): PYTHONHASHSEED-proof)
_PROFILE_SALT = 0x5C11
_EVENT_SALT = 0x5C12


@dataclass(frozen=True)
class ClientProfile:
    """One simulated client's capability/behaviour profile.

    ``compute`` multiplies the client's service time (1 = nominal, 2 =
    half speed); ``bandwidth`` in (0, 1] divides its delivery speed;
    ``dropout_hazard`` is the per-round probability of a mid-round
    dropout (features extracted but never delivered); ``staleness_bound``
    is the largest delivery lag (in rounds) the protocol tolerates for
    this client before its contribution misses the round entirely.
    ``phase`` is the diurnal availability phase (radians).
    """
    compute: float = 1.0
    bandwidth: float = 1.0
    dropout_hazard: float = 0.0
    staleness_bound: int = 1
    phase: float = 0.0


class RoundEvents(NamedTuple):
    """Per-cohort-slot churn events for ONE round.

    ``keep`` ([C] float32) is 1.0 for slots that survive the round and
    0.0 for mid-round drops — the Engine multiplies it into the padded
    attendance mask, so a dropped slot's features never reach a valid
    server minibatch and its commit is skipped (padded-slot machinery).
    ``lag`` ([C] int) is each surviving slot's drawn delivery lag in
    rounds (0 = delivers within its round); slots whose draw exceeded
    their staleness bound appear with ``keep == 0``.
    """
    keep: np.ndarray
    lag: np.ndarray
    hazard_drops: int                 # slots lost to mid-round dropout
    deadline_drops: int               # slots lost to lag > staleness bound


@dataclass(frozen=True)
class ScenarioConfig:
    """Serializable description of a client-population scenario.

    ``kind='none'`` (the default) is the null scenario: no stream is
    built and the Engine runs its scenario-free path bit-for-bit.
    """
    kind: str = "none"                # none | uniform | pareto-straggler
                                      # | diurnal-churn
    dropout: float = 0.0              # base mid-round dropout hazard
    straggler: float = 0.0            # mean service lag (rounds) at
                                      # nominal compute/bandwidth
    staleness_bound: int = 1          # max tolerated delivery lag
    compute_spread: float = 1.0       # compute ~ U[1, 1 + spread]
    bandwidth_spread: float = 0.75    # bandwidth ~ 1/(1 + U[0, spread])
    pareto_shape: float = 1.5         # tail index of pareto-straggler
    period: int = 48                  # diurnal period (rounds)
    amplitude: float = 0.8            # diurnal availability swing [0, 1)
    seed: Optional[int] = None        # stream seed (None = experiment seed)

    # -------------------------------------------------------- round-trips
    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioConfig":
        d = dict(d)
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise KeyError(f"unknown ScenarioConfig fields: {sorted(unknown)}")
        return cls(**d)

    def validate(self) -> "ScenarioConfig":
        if self.kind != "none" and self.kind not in STREAMS:
            raise KeyError(f"unknown scenario kind {self.kind!r}: "
                           f"{scenario_kinds()}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"scenario.dropout={self.dropout} must be in "
                             "[0, 1)")
        if self.straggler < 0:
            raise ValueError(f"scenario.straggler={self.straggler} must be "
                             ">= 0")
        if self.staleness_bound < 0:
            raise ValueError(f"scenario.staleness_bound="
                             f"{self.staleness_bound} must be >= 0")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError(f"scenario.amplitude={self.amplitude} must be "
                             "in [0, 1) (availability must stay positive)")
        if self.period < 2:
            raise ValueError(f"scenario.period={self.period} must be >= 2")
        if self.pareto_shape <= 0:
            raise ValueError(f"scenario.pareto_shape={self.pareto_shape} "
                             "must be > 0")
        return self

    @property
    def churns(self) -> bool:
        """True when the scenario can shrink a live cohort mid-round
        (dropout hazard or straggler deadline misses)."""
        return self.kind != "none" and (self.dropout > 0
                                        or self.straggler > 0)

    # -------------------------------------------------------------- flags
    @staticmethod
    def add_arguments(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
        ap.add_argument("--scenario", default="none",
                        choices=scenario_kinds(),
                        help="client-population scenario driving per-round "
                             "churn (profiles -> attendance mask + lag)")
        ap.add_argument("--scenario-dropout", type=float, default=0.0,
                        help="base mid-round dropout hazard per slot-round")
        ap.add_argument("--scenario-straggler", type=float, default=0.0,
                        help="mean service lag in rounds at nominal "
                             "compute/bandwidth (0 = no stragglers)")
        ap.add_argument("--scenario-staleness-bound", type=int, default=1,
                        help="max delivery lag (rounds) before a straggler "
                             "misses the round")
        ap.add_argument("--scenario-period", type=int, default=48,
                        help="diurnal availability period in rounds")
        ap.add_argument("--scenario-amplitude", type=float, default=0.8,
                        help="diurnal availability swing in [0, 1)")
        ap.add_argument("--scenario-seed", type=int, default=None,
                        help="scenario stream seed (default: run seed)")
        return ap

    @classmethod
    def from_flags(cls, args: argparse.Namespace) -> "ScenarioConfig":
        return cls(kind=args.scenario,
                   dropout=args.scenario_dropout,
                   straggler=args.scenario_straggler,
                   staleness_bound=args.scenario_staleness_bound,
                   period=args.scenario_period,
                   amplitude=args.scenario_amplitude,
                   seed=args.scenario_seed).validate()


# ------------------------------------------------------------------ streams
class ProfileStream:
    """Deterministic per-round churn generator over a fixed population.

    Subclasses implement ``_init_profiles`` (drawn ONCE from the profile
    fold-in stream) and may override ``hazard_at``/``weights`` for
    time-varying behaviour.  All arrays are numpy — the stream runs on
    the host, feeding values (never shapes) into the round.
    """

    kind = "base"

    def __init__(self, cfg: ScenarioConfig, n_clients: int, seed: int):
        self.cfg = cfg.validate()
        self.n = int(n_clients)
        self.seed = int(cfg.seed if cfg.seed is not None else seed)
        self.phase = np.zeros(self.n)
        self._init_profiles(self._rng(_PROFILE_SALT))

    # deterministic fold-in: a fresh Generator per (seed, salt, round)
    def _rng(self, *salt: int) -> np.random.Generator:
        return np.random.default_rng([int(s) & 0xFFFFFFFF for s in
                                      (self.seed, *salt)])

    def _init_profiles(self, rng: np.random.Generator) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------ queries
    def profile(self, client: int) -> ClientProfile:
        return ClientProfile(compute=float(self.compute[client]),
                             bandwidth=float(self.bandwidth[client]),
                             dropout_hazard=float(self.hazard[client]),
                             staleness_bound=int(self.bound[client]),
                             phase=float(self.phase[client]))

    @property
    def churns(self) -> bool:
        return self.cfg.churns

    def weights(self, rnd: int) -> Optional[np.ndarray]:
        """Per-client attendance weights for round ``rnd`` (``None`` =
        uniform — the sampler then makes exactly the draws the
        scenario-free Engine makes, keeping the null path bit-for-bit)."""
        return None

    def hazard_at(self, rnd: int, cohort: np.ndarray) -> np.ndarray:
        """Per-slot mid-round dropout hazard for round ``rnd``."""
        return self.hazard[cohort]

    # ------------------------------------------------------------- events
    def events(self, rnd: int, cohort, min_live: int = 1) -> RoundEvents:
        """Drop/lag events for one round's live cohort slots.

        A slot drops when (a) its hazard uniform fires (mid-round
        dropout) or (b) its drawn delivery lag exceeds its staleness
        bound (it cannot deliver inside the tolerated window).  At least
        ``min_live`` slots always survive: the most-survivable dropped
        slots (largest hazard margin) are deterministically revived, a
        revived straggler delivering exactly at its bound — so a churny
        round can never hand the server an empty feature pool.

        All draws come from ``rng([seed, EVENT_SALT, rnd])`` in a fixed
        order, so the result is a pure function of (seed, round, cohort).
        """
        cohort = np.asarray(cohort)
        c = len(cohort)
        rng = self._rng(_EVENT_SALT, rnd)
        u = rng.random(c)                        # hazard uniforms
        raw = rng.exponential(size=c)            # service-time draws
        hz = np.asarray(self.hazard_at(rnd, cohort), np.float64)
        hazard_drop = u < hz
        lag = np.zeros(c, np.int64)
        if self.cfg.straggler > 0:
            lag = np.floor(raw * self.cfg.straggler * self.compute[cohort]
                           / self.bandwidth[cohort]).astype(np.int64)
        bound = self.bound[cohort]
        deadline_drop = ~hazard_drop & (lag > bound)
        keep = ~(hazard_drop | deadline_drop)
        floor = min(int(min_live), c)
        if keep.sum() < floor:
            for i in np.argsort(hz - u):         # most survivable first
                if keep.sum() >= floor:
                    break
                if not keep[i]:
                    keep[i] = True
                    hazard_drop[i] = deadline_drop[i] = False
                    lag[i] = min(lag[i], bound[i])
        return RoundEvents(keep.astype(np.float32), lag,
                           int(hazard_drop.sum()), int(deadline_drop.sum()))


class UniformStream(ProfileStream):
    """Homogeneous-in-law heterogeneity: compute/bandwidth drawn iid
    uniform, constant dropout hazard, uniform attendance.  With zero
    dropout/straggler this stream is a structural no-op — the Engine run
    is bit-for-bit the null scenario.
    """

    kind = "uniform"

    def _init_profiles(self, rng):
        cfg = self.cfg
        self.compute = 1.0 + rng.random(self.n) * cfg.compute_spread
        self.bandwidth = 1.0 / (1.0 + rng.random(self.n)
                                * cfg.bandwidth_spread)
        self.hazard = np.full(self.n, cfg.dropout)
        self.bound = np.full(self.n, cfg.staleness_bound, np.int64)


class ParetoStragglerStream(ProfileStream):
    """Heavy-tailed compute (Pareto): a small fraction of clients is
    much slower than the fleet median — the classic straggler regime
    (arxiv 2411.13907).  Slow links also drop more (hazard scales with
    1/bandwidth)."""

    kind = "pareto-straggler"

    def _init_profiles(self, rng):
        cfg = self.cfg
        self.compute = 1.0 + rng.pareto(cfg.pareto_shape, self.n)
        self.bandwidth = 1.0 / (1.0 + rng.random(self.n)
                                * cfg.bandwidth_spread)
        self.hazard = np.clip(cfg.dropout / self.bandwidth, 0.0, 0.95)
        self.bound = np.full(self.n, cfg.staleness_bound, np.int64)


class DiurnalChurnStream(UniformStream):
    """Diurnal availability: each client's attendance weight follows a
    sinusoid with a private phase (time zones), and the dropout hazard
    rises when availability is low (a client sampled near its trough is
    the one most likely to vanish mid-round)."""

    kind = "diurnal-churn"

    def _init_profiles(self, rng):
        super()._init_profiles(rng)
        self.phase = rng.uniform(0.0, 2.0 * np.pi, self.n)

    def availability(self, rnd: int) -> np.ndarray:
        cfg = self.cfg
        return 1.0 + cfg.amplitude * np.sin(
            2.0 * np.pi * rnd / cfg.period + self.phase)

    def weights(self, rnd: int) -> np.ndarray:
        a = self.availability(rnd)
        return a / a.sum()

    def hazard_at(self, rnd: int, cohort: np.ndarray) -> np.ndarray:
        return np.clip(self.hazard[cohort]
                       * (2.0 - self.availability(rnd)[cohort]), 0.0, 0.95)


STREAMS: dict[str, type] = {
    s.kind: s for s in (UniformStream, ParetoStragglerStream,
                        DiurnalChurnStream)
}


def scenario_kinds() -> tuple[str, ...]:
    return ("none",) + tuple(sorted(STREAMS))


def build_profile_stream(cfg: ScenarioConfig, n_clients: int,
                         seed: int) -> Optional[ProfileStream]:
    """Resolve a ScenarioConfig into a stream; ``None`` for the null
    scenario (the Engine then runs its scenario-free path untouched)."""
    cfg.validate()
    if cfg.kind == "none":
        return None
    return STREAMS[cfg.kind](cfg, n_clients, seed)
