"""Host-side recovery controller: the bookkeeping half of the guards.

A copy of ``repro/resilience/policy.py``.  The round computes the health
verdict (see :mod:`repro_torch.resilience.guards`); this module owns
everything that lives outside the round — the per-fault action table,
the retry/backoff budget, the bounded in-memory ring of last-good
TrainState snapshots, the quarantine ledger feeding the cohort sampler,
and the per-round telemetry the run result reports.

The controller never touches device state itself: the Engine asks it
what to do (``action_for``), hands it accepted states to remember
(``note_accept``), and pulls restore targets from it (``rollback``).
Snapshots are plain references, which costs no copy: no round writes a
tensor of its input state in place (every phase, and the fused Adam
kernel, returns new tensors).  An in-place optimizer step or a replayed
CUDA graph would overwrite the snapshots, and the rollback tests, which
compare a restored state with a host copy taken at accept time, would
catch it.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional, Sequence

import numpy as np

from repro_torch.resilience.config import ACTIONS, ResilienceConfig

# fault kinds a verdict can name (order = severity for telemetry only)
FAULT_KINDS = ("nonfinite", "spike", "error")


class ResilienceExhaustedError(RuntimeError):
    """Every configured recovery action failed for one round."""

    def __init__(self, rnd: int, attempts: int, kinds: Sequence[str]):
        super().__init__(
            f"round {rnd}: recovery exhausted after {attempts} attempts "
            f"(faults seen: {sorted(set(kinds))}); raise "
            "resilience.max_retries, widen the policy, or fix the fault")
        self.rnd = rnd
        self.attempts = attempts


def quarantine_mask(mask: np.ndarray, slot_bad: np.ndarray) -> np.ndarray:
    """Zero the blamed slots out of a [C] attendance mask.

    Pure and shape-preserving — exactly the transform the Engine applies
    before a quarantine re-run: a blamed slot's mask entry reads 0, so
    its pooled feature rows are invalid before ServerUpdate resamples
    and its commit is a structural no-op (the scenario churn semantics, reused verbatim).
    """
    mask = np.asarray(mask, np.float32)
    bad = np.asarray(slot_bad, np.float32)
    return (mask * (bad <= 0)).astype(np.float32)


class RecoveryController:
    """Per-run recovery state machine (one instance per Engine.run)."""

    def __init__(self, cfg: ResilienceConfig, n_clients: int,
                 min_live: int = 1, log=print, sleep=time.sleep):
        self.cfg = cfg.validate()
        self.n_clients = int(n_clients)
        self.min_live = int(min_live)
        self.log = log
        self.sleep = sleep
        self.ring: deque = deque(maxlen=cfg.ring_size)  # (rnd, state, ema)
        self.quarantined: set[int] = set()
        # (round, ids) per quarantine event — the replayable form of the
        # ledger: resume rebuilds `quarantined` as of any past round from
        # this, so a restored run's cohort draws match the original's
        self.quarantine_history: list[tuple[int, tuple[int, ...]]] = []
        self.rows: list[dict] = []
        self.totals = {"retries": 0, "rollbacks": 0,
                       "quarantine_events": 0, "faulted_rounds": 0,
                       "faults": {k: 0 for k in FAULT_KINDS}}
        self._accepted = 0            # accepted rounds (spike warmup gate)

    # ------------------------------------------------------------ policy
    def action_for(self, kind: str, attempt: int) -> str:
        """The action for fault ``kind`` on recovery attempt ``attempt``.

        The configured action leads; if it proved inapplicable on an
        earlier attempt of the same round the Engine walks the
        escalation tail via :meth:`escalate`.
        """
        base = {"nonfinite": self.cfg.on_nonfinite,
                "spike": self.cfg.on_spike,
                "error": self.cfg.on_error}[kind]
        return base

    @staticmethod
    def escalate(action: str) -> Optional[str]:
        """Next action when ``action`` cannot apply (no blamable slot,
        empty snapshot ring): quarantine -> retry -> rollback -> None."""
        ladder = [a for a in ACTIONS if a != "ignore"]
        i = ladder.index(action) if action in ladder else -1
        return ladder[i + 1] if 0 <= i < len(ladder) - 1 else None

    def spike_armed(self) -> bool:
        return self._accepted >= self.cfg.spike_warmup

    def backoff(self, attempt: int) -> None:
        if self.cfg.backoff_base_s > 0:
            self.sleep(self.cfg.backoff_base_s * (2.0 ** (attempt - 1)))

    # --------------------------------------------------------- snapshots
    def note_accept(self, rnd: int, state, ema) -> None:
        """Record an accepted round; snapshot on the configured cadence.
        Called once per accepted round, faulted or not.  ``ema`` is kept
        as-is (a device scalar) — no host sync here."""
        self._accepted += 1
        if self.cfg.guard and self._accepted % self.cfg.snapshot_every == 0:
            self.ring.append((rnd, state, ema))

    def rollback(self) -> Optional[tuple[int, object, float]]:
        """Pop the newest last-good snapshot (None when the ring is
        empty).  Consumed on use so repeated faults walk further back."""
        if not self.ring:
            return None
        self.totals["rollbacks"] += 1
        return self.ring.pop()

    # -------------------------------------------------------- quarantine
    def quarantine(self, cohort: np.ndarray, mask: np.ndarray,
                   slot_bad: np.ndarray,
                   rnd: Optional[int] = None) -> Optional[np.ndarray]:
        """Blame -> new mask + ledger update; None when inapplicable.

        Inapplicable when no LIVE slot with a real client id is blamed,
        or when zeroing the blamed slots would leave fewer than one live
        slot (the server inner loop would see an empty pool) — the
        caller then escalates.
        """
        cohort = np.asarray(cohort)
        mask = np.asarray(mask, np.float32)
        bad = (np.asarray(slot_bad) > 0) & (mask > 0) \
            & (cohort < self.n_clients)
        if not bad.any():
            return None
        new_mask = quarantine_mask(mask, bad)
        if new_mask.sum() < 1:
            return None
        ids = sorted(int(c) for c in cohort[bad])
        self.quarantined.update(ids)
        self.quarantine_history.append(
            (-1 if rnd is None else int(rnd), tuple(ids)))
        self.totals["quarantine_events"] += 1
        self.log(f"[resilience] quarantined clients {ids} "
                 f"({len(self.quarantined)} total)")
        return new_mask

    def sampling_weights(self, base: Optional[np.ndarray]
                         ) -> Optional[np.ndarray]:
        """Fold the quarantine ledger into the cohort-sampling weights.

        ``None`` in, no quarantine -> ``None`` out (the sampler keeps
        the exact scenario-free draw path).  With quarantined clients
        their weight is zeroed — unless that would starve the sampler
        below ``min_live`` candidates, in which case the ledger is
        ignored for sampling (better a suspect client than no cohort).
        """
        if not self.quarantined:
            return base
        w = (np.ones(self.n_clients, np.float64) if base is None
             else np.asarray(base, np.float64).copy())
        w[list(self.quarantined)] = 0.0
        if (w > 0).sum() < max(self.min_live, 1):
            return base
        return w

    # ------------------------------------------------------- persistence
    def export_state(self) -> dict:
        """JSON-serializable controller state for checkpoint metadata.

        Covers the parts a resumed run must not forget: the quarantine
        ledger (set + per-round event history, so sampling replay can
        reconstruct the set as of any round), the accepted-round count
        (the spike-warmup gate), and the recovery totals.  The snapshot
        ring and telemetry rows are deliberately NOT persisted — ring
        entries are live device pytrees (the checkpoint itself is the
        last-good state after a resume) and rows are per-run telemetry.
        """
        return {
            "quarantined": sorted(self.quarantined),
            "quarantine_history": [[r, list(ids)]
                                   for r, ids in self.quarantine_history],
            "accepted": self._accepted,
            "totals": {**{k: v for k, v in self.totals.items()
                          if k != "faults"},
                       "faults": dict(self.totals["faults"])},
        }

    def restore_state(self, d: dict) -> None:
        """Inverse of :meth:`export_state` (tolerates older metadata
        missing keys: absent fields keep their fresh-run defaults)."""
        self.quarantined = set(int(c) for c in d.get("quarantined", ()))
        self.quarantine_history = [
            (int(r), tuple(int(c) for c in ids))
            for r, ids in d.get("quarantine_history", ())]
        self._accepted = int(d.get("accepted", 0))
        totals = d.get("totals", {})
        for k in self.totals:
            if k == "faults":
                for fk in self.totals["faults"]:
                    self.totals["faults"][fk] = int(
                        totals.get("faults", {}).get(fk, 0))
            else:
                self.totals[k] = int(totals.get(k, self.totals[k]))

    def quarantined_as_of(self, rnd: int) -> set[int]:
        """The quarantine set as of the START of round ``rnd`` (events
        from earlier rounds only) — the set the original run's sampler
        saw when drawing round ``rnd``'s cohort."""
        return {int(c) for r, ids in self.quarantine_history if r < rnd
                for c in ids}

    # --------------------------------------------------------- telemetry
    def record_round(self, rnd: int, attempts: int, kinds: list[str],
                     actions: list[str], quarantined_now: int) -> None:
        """One telemetry row per round that needed ANY recovery work."""
        if attempts == 0:
            return
        self.totals["faulted_rounds"] += 1
        for k in kinds:
            self.totals["faults"][k] += 1
        self.totals["retries"] += sum(a == "retry" for a in actions)
        self.rows.append({"round": rnd, "attempts": attempts,
                          "faults": list(kinds), "actions": list(actions),
                          "quarantined_slots": quarantined_now})

    def summary(self) -> dict:
        return {
            "retries": self.totals["retries"],
            "rollbacks": self.totals["rollbacks"],
            "quarantine_events": self.totals["quarantine_events"],
            "quarantined_clients": sorted(self.quarantined),
            "faulted_rounds": self.totals["faulted_rounds"],
            "faults": dict(self.totals["faults"]),
            "snapshots_held": len(self.ring),
            "per_round": list(self.rows),
        }
