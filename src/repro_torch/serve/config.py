"""Serializable serving knobs (rides ``ExperimentConfig.serve``).

Port of ``repro/serve/config.py``, field for field, so one dict drives
both packages.  One :class:`ServeConfig` describes the
continuous-batching runtime in :mod:`repro_torch.serve.runtime`: the
static slot-table capacity every tick runs at, the prompt/generation
budgets every request is padded to, and the robustness policy
(per-request deadlines, dispatch retry with exponential backoff).  It
round-trips losslessly through ``to_dict``/``from_dict`` and hangs off
:class:`~repro_torch.api.config.ExperimentConfig`.
"""
from __future__ import annotations

import argparse
from dataclasses import asdict, dataclass, fields


@dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching serve runtime knobs.

    * ``slots`` — static slot-table capacity: every decode tick runs
      over exactly this many concurrent sequences; admission and
      retirement ride a live-slot mask (the training arc's
      attendance-mask idiom), never a new shape.
    * ``max_prompt_len`` / ``max_new_tokens`` — static per-request
      budgets every prompt/generation is padded to (requests above the
      prompt budget are rejected at submit).
    * ``prefill_batch`` — admission chunk width: queued requests are
      prefilled ``prefill_batch`` at a time in ONE batched dispatch.
    * ``deadline_s`` — default per-request deadline (overridable per
      submit): expired queued requests are rejected before consuming
      compute; expired in-flight requests are evicted at the next tick.
    * ``max_retries`` / ``backoff_base_s`` — failed dispatches retry up
      to ``max_retries`` times, sleeping ``backoff_base_s * 2^attempt``
      between attempts; exhaustion evicts the affected slots and leaves
      the runtime serving.
    """
    slots: int = 8
    max_prompt_len: int = 16
    max_new_tokens: int = 16
    prefill_batch: int = 4
    deadline_s: float = 60.0
    max_retries: int = 2
    backoff_base_s: float = 0.0

    # -------------------------------------------------------- round-trips
    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        d = dict(d)
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise KeyError(f"unknown ServeConfig fields: {sorted(unknown)}")
        return cls(**d)

    def validate(self) -> "ServeConfig":
        if self.slots < 1:
            raise ValueError(f"serve.slots={self.slots} must be >= 1")
        if self.max_prompt_len < 1:
            raise ValueError(f"serve.max_prompt_len={self.max_prompt_len} "
                             "must be >= 1")
        if self.max_new_tokens < 1:
            raise ValueError(f"serve.max_new_tokens={self.max_new_tokens} "
                             "must be >= 1")
        if not 1 <= self.prefill_batch <= self.slots:
            raise ValueError(
                f"serve.prefill_batch={self.prefill_batch} must be in "
                f"[1, slots={self.slots}] (admission scatters one chunk "
                "into distinct slots)")
        if self.deadline_s <= 0:
            raise ValueError(f"serve.deadline_s={self.deadline_s} must be "
                             "> 0")
        if self.max_retries < 0:
            raise ValueError(f"serve.max_retries={self.max_retries} must "
                             "be >= 0")
        if self.backoff_base_s < 0:
            raise ValueError(f"serve.backoff_base_s={self.backoff_base_s} "
                             "must be >= 0")
        return self

    # -------------------------------------------------------------- flags
    @staticmethod
    def add_arguments(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
        ap.add_argument("--serve-slots", type=int, default=8,
                        help="static decode slot-table capacity (one shape "
                             "serves any arrival pattern at this width)")
        ap.add_argument("--serve-max-prompt-len", type=int, default=16,
                        help="static prompt budget requests are padded to")
        ap.add_argument("--serve-max-new-tokens", type=int, default=16,
                        help="static generation budget per request")
        ap.add_argument("--serve-prefill-batch", type=int, default=4,
                        help="admission chunk width (one batched prefill "
                             "dispatch per chunk)")
        ap.add_argument("--serve-deadline-s", type=float, default=60.0,
                        help="default per-request deadline in seconds")
        ap.add_argument("--serve-max-retries", type=int, default=2,
                        help="dispatch retries before evicting the "
                             "affected slots")
        ap.add_argument("--serve-backoff-base-s", type=float, default=0.0,
                        help="exponential-backoff base between dispatch "
                             "retries (seconds)")
        return ap

    @classmethod
    def from_flags(cls, args: argparse.Namespace) -> "ServeConfig":
        return cls(slots=args.serve_slots,
                   max_prompt_len=args.serve_max_prompt_len,
                   max_new_tokens=args.serve_max_new_tokens,
                   prefill_batch=args.serve_prefill_batch,
                   deadline_s=args.serve_deadline_s,
                   max_retries=args.serve_max_retries,
                   backoff_base_s=args.serve_backoff_base_s).validate()
