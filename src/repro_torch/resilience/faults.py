"""Deterministic fault-injection streams (styled after scenario/profiles).

A numpy copy of ``repro/resilience/faults.py``: the same salts and
fold-ins, so both packages fire the same faults.

Every draw is a pure fold-in of ``(seed, salt, round[, attempt])``
through ``np.random.default_rng`` — never a stateful stream — so every
recovery path the Engine takes is replayable under test: two
independently-built streams agree on which rounds are poisoned, which
dispatches raise, and which checkpoint writes are torn, regardless of
query order or how many recovery attempts a round consumed.

Three fault kinds, mirroring what a real fleet throws at the server:

* ``nan``   — poisoned client delivery: ``nan_slots(rnd, attempt)``
  names the cohort slots whose feature batch arrives as NaN that round.
  By default a fault clears after the first attempt (a transient link),
  so retry/rollback recover; ``persist`` extends it across recovery
  attempts — then only quarantining the slot saves the round.
* ``error`` — a dispatch raises (preempted host, OOM, link loss):
  ``check_dispatch(rnd, attempt)`` raises :class:`FaultInjectedError`
  before the round/extract/tail dispatch runs.  Attempt-keyed, so a
  retry lands on a healthy draw.
* ``ckpt``  — a torn checkpoint write: ``ckpt_corrupt(step)`` says
  whether to truncate the just-written step's array file, exercising the
  restore-past-corrupt fallback in :mod:`repro_torch.checkpoint.io`.
"""
from __future__ import annotations

import argparse
import os
from dataclasses import asdict, dataclass, fields
from typing import Optional

import numpy as np

# fixed fold-in salts (never derived from hash(): PYTHONHASHSEED-proof)
_NAN_SALT = 0xFA01
_ERROR_SALT = 0xFA02
_CKPT_SALT = 0xFA03


class FaultInjectedError(RuntimeError):
    """A deterministically-injected dispatch failure.

    ``site`` names where the fault fired ('round', 'extract', 'tail');
    the Engine's recovery controller treats it as the 'error' fault kind
    (policy ``on_error``).  Escapes the run unhandled when no recovery
    is configured — an unguarded Engine dies on it, by design.
    """

    def __init__(self, site: str, rnd: int, attempt: int):
        super().__init__(f"injected {site} fault at round {rnd} "
                         f"(attempt {attempt})")
        self.site = site
        self.rnd = rnd
        self.attempt = attempt


@dataclass(frozen=True)
class FaultConfig:
    """Serializable fault-injection knobs (rides ``ResilienceConfig``).

    All rates are per-round probabilities in [0, 1); a zero-rate config
    builds no stream at all (:func:`build_fault_stream` returns None)
    and the Engine's fault hooks are never consulted.
    """
    nan_rate: float = 0.0          # P[a round's delivery is poisoned]
    nan_slots: int = 1             # cohort slots poisoned when it fires
    error_rate: float = 0.0        # P[a dispatch raises] per attempt
    ckpt_rate: float = 0.0         # P[a checkpoint write is torn]
    persist: int = 0               # recovery attempts a NaN fault outlives
                                   # (0 = clears after the first attempt)
    seed: Optional[int] = None     # stream seed (None = experiment seed)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultConfig":
        d = dict(d)
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise KeyError(f"unknown FaultConfig fields: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_spec(cls, spec: str, seed: Optional[int] = None) -> "FaultConfig":
        """Parse the compact ``--faults`` flag syntax:
        ``"nan=0.2,error=0.1,ckpt=0.5,slots=2,persist=3"`` (any subset)."""
        kw: dict = {"seed": seed}
        if spec:
            for part in spec.split(","):
                k, _, val = part.partition("=")
                key = {"nan": "nan_rate", "error": "error_rate",
                       "ckpt": "ckpt_rate", "slots": "nan_slots",
                       "persist": "persist"}.get(k.strip())
                if key is None:
                    raise KeyError(f"unknown fault spec key {k!r} in {spec!r}"
                                   " (expected nan/error/ckpt/slots/persist)")
                kw[key] = (int(val) if key in ("nan_slots", "persist")
                           else float(val))
        return cls(**kw).validate()

    def validate(self) -> "FaultConfig":
        for name in ("nan_rate", "error_rate", "ckpt_rate"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"faults.{name}={v} must be in [0, 1)")
        if self.nan_slots < 1:
            raise ValueError(f"faults.nan_slots={self.nan_slots} must be >= 1")
        if self.persist < 0:
            raise ValueError(f"faults.persist={self.persist} must be >= 0")
        return self

    @property
    def any(self) -> bool:
        return (self.nan_rate > 0 or self.error_rate > 0
                or self.ckpt_rate > 0)


class FaultStream:
    """Deterministic per-round fault generator.

    One instance per run; every query is a pure function of
    ``(seed, salt, round[, attempt])`` so recovery replays are exact.
    """

    def __init__(self, cfg: FaultConfig, seed: int):
        self.cfg = cfg.validate()
        self.seed = int(cfg.seed if cfg.seed is not None else seed)

    # deterministic fold-in: a fresh Generator per (seed, salt, ...)
    def _rng(self, *salt: int) -> np.random.Generator:
        return np.random.default_rng([int(s) & 0xFFFFFFFF for s in
                                      (self.seed, *salt)])

    # ------------------------------------------------------------- kinds
    def nan_slots_for(self, rnd: int, attempt: int,
                      live: int) -> np.ndarray:
        """Cohort slot indices whose features are poisoned this attempt
        ([0] .. [live) ints, possibly empty).  The round-level draw (does
        the fault fire, and on which slots) depends only on ``rnd``;
        ``attempt`` only gates persistence — a retry past
        ``cfg.persist`` attempts lands on a clean delivery.
        """
        cfg = self.cfg
        if cfg.nan_rate <= 0 or live <= 0 or attempt > cfg.persist:
            return np.empty(0, np.int64)
        rng = self._rng(_NAN_SALT, rnd)
        if rng.random() >= cfg.nan_rate:
            return np.empty(0, np.int64)
        k = min(cfg.nan_slots, live)
        return np.sort(rng.choice(live, size=k, replace=False))

    def check_dispatch(self, rnd: int, attempt: int,
                       site: str = "round") -> None:
        """Raise :class:`FaultInjectedError` when the (rnd, attempt)
        dispatch draw fires.  Attempt-keyed: a retry redraws."""
        if self.cfg.error_rate <= 0:
            return
        u = self._rng(_ERROR_SALT, rnd, attempt).random()
        if u < self.cfg.error_rate:
            raise FaultInjectedError(site, rnd, attempt)

    def ckpt_corrupt(self, step: int) -> bool:
        """Whether the write of checkpoint ``step`` should be torn."""
        if self.cfg.ckpt_rate <= 0:
            return False
        return bool(self._rng(_CKPT_SALT, step).random()
                    < self.cfg.ckpt_rate)

    # --------------------------------------------------------- mutations
    @staticmethod
    def corrupt_checkpoint(ckpt_dir: str, step: int,
                           keep_bytes: int = 64) -> str:
        """Tear a written checkpoint: truncate its array payload to
        ``keep_bytes`` (a partial write frozen mid-flight).  The manifest
        survives, so only the content checksum can tell — exactly the
        failure mode the restore fallback must skip."""
        path = os.path.join(ckpt_dir, f"step_{step}", "arrays.npz")
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(min(keep_bytes, size))
        return path


def build_fault_stream(cfg: Optional[FaultConfig], seed: int
                       ) -> Optional[FaultStream]:
    """Resolve a FaultConfig into a stream; ``None`` when no fault kind
    has a positive rate (the Engine then never consults the hooks)."""
    if cfg is None or not cfg.any:
        return None
    return FaultStream(cfg, seed)


def add_fault_arguments(ap: argparse.ArgumentParser
                        ) -> argparse.ArgumentParser:
    ap.add_argument("--faults", default="",
                    help="deterministic fault injection spec, e.g. "
                         "'nan=0.2,error=0.1,ckpt=0.3,slots=2,persist=0' "
                         "(empty = no injection)")
    ap.add_argument("--faults-seed", type=int, default=None,
                    help="fault stream seed (default: run seed)")
    return ap
