"""Frozen experiment description, mirroring ``repro/api/config.py``.

``ExperimentConfig.from_dict`` accepts the JAX package's ``to_dict()``
output unchanged, so one dict drives both packages.  Every field the
JAX package has is kept with its default; a field whose feature the port
does not have yet must keep that default, or ``validate`` raises
``NotImplementedError``.  The nested scenario and resilience configs
stay plain dicts here, for the same reason; ``serve`` is the port's
``ServeConfig``, which ``repro_torch.launch.serve --continuous`` reads.
"""
from __future__ import annotations

import argparse
from dataclasses import asdict, dataclass, field, fields, replace
from typing import Optional

from repro_torch.api.registry import algorithm_names, get_program
from repro_torch.api.tasks import TASKS, task_names
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.serve.config import ServeConfig

SCENARIO_DEFAULTS = {
    "kind": "none", "dropout": 0.0, "straggler": 0.0, "staleness_bound": 1,
    "compute_spread": 1.0, "bandwidth_spread": 0.75, "pareto_shape": 1.5,
    "period": 48, "amplitude": 0.8, "seed": None}
RESILIENCE_DEFAULTS = {
    "guard": False, "on_nonfinite": "quarantine", "on_spike": "ignore",
    "on_error": "retry", "max_retries": 3, "backoff_base_s": 0.0,
    "ring_size": 2, "snapshot_every": 1, "ema_alpha": 0.1,
    "spike_factor": 4.0, "spike_warmup": 5,
    "faults": {"nan_rate": 0.0, "nan_slots": 1, "error_rate": 0.0,
               "ckpt_rate": 0.0, "persist": 0, "seed": None}}


@dataclass(frozen=True)
class ExperimentConfig:
    algo: str = "cyclesfl"
    task: str = "image"
    rounds: int = 100
    n_clients: int = 100
    attendance: float = 0.05          # partial participation rate (§4.1)
    min_cohort: int = 2
    batch: int = 16
    lr_server: float = 1e-3
    lr_client: float = 1e-3
    alpha: float = 0.5                # Dirichlet label-skew strength
    seed: int = 0
    width: int = 16
    cut: int = 2
    eval_every: int = 20
    # per-round key: seed * round_key_salt + round
    round_key_salt: int = 100_000
    # pad every cohort to the static capacity round(attendance * N) and
    # thread an attendance mask through the round
    pad_cohorts: bool = True
    # Binomial(N, attendance) cohort sizes, clipped to [min_cohort, C_max]
    variable_attendance: bool = False
    # block on the round's metrics and report round_time_s
    collect_timing: bool = False
    # with collect_timing, sync the host only every sync_every rounds
    # (plus the first round and the last); 1 syncs every round.  On the
    # card k > 1 times the same as 1 for now: each round's cohort is
    # copied from pageable host memory, and that copy waits for the
    # queued rounds (no pinned prefetch of the next cohort yet)
    sync_every: int = 1
    # ---- not ported yet: each must keep its default ----
    ckpt_dir: Optional[str] = None
    mesh_shape: Optional[tuple] = None
    mesh_axes: tuple = ("data", "model")
    shard_cohort: bool = True
    resume: bool = False
    pipeline_depth: int = 0
    pipeline_staleness: str = "sync"
    staleness_weighting: str = "none"
    staleness_lambda: float = 0.5
    scenario: dict = field(default_factory=lambda: dict(SCENARIO_DEFAULTS))
    resilience: dict = field(
        default_factory=lambda: {**RESILIENCE_DEFAULTS,
                                 "faults": dict(RESILIENCE_DEFAULTS["faults"])})
    # ---- continuous-batching serve runtime (repro_torch.serve); training
    # ignores it
    serve: ServeConfig = field(default_factory=ServeConfig)
    cycle: CycleConfig = field(default_factory=CycleConfig)

    # ---------------------------------------------------------- builders
    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        d = dict(d)
        cycle = d.pop("cycle", {})
        if not isinstance(cycle, CycleConfig):
            cycle = dict(cycle)
            cycle.pop("batch_constraint", None)   # pre-mesh JSONs
            cycle = CycleConfig(**cycle)
        # configs from before the serve field lack it: default knobs
        serve = d.pop("serve", {})
        if not isinstance(serve, ServeConfig):
            serve = ServeConfig.from_dict(serve)
        if d.get("mesh_shape") is not None:
            d["mesh_shape"] = tuple(int(s) for s in d["mesh_shape"])
        if d.get("mesh_axes") is not None:
            d["mesh_axes"] = tuple(d["mesh_axes"])
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise KeyError(f"unknown ExperimentConfig fields: {sorted(unknown)}")
        return cls(cycle=cycle, serve=serve, **d)

    def validate(self) -> "ExperimentConfig":
        """Raise on a field whose feature the port lacks, then check the
        ported ones."""
        defaults = ExperimentConfig()
        for name in ("ckpt_dir", "mesh_shape", "mesh_axes",
                     "shard_cohort", "resume", "pipeline_depth",
                     "pipeline_staleness", "staleness_weighting",
                     "staleness_lambda", "scenario", "resilience"):
            if getattr(self, name) != getattr(defaults, name):
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: not ported yet "
                    f"(the port runs with {getattr(defaults, name)!r})")
        self.cycle.check_ported()
        self.serve.validate()
        get_program(self.algo)
        if self.task not in TASKS:
            raise KeyError(f"unknown task {self.task!r}: {sorted(TASKS)}")
        if self.sync_every < 1:
            raise ValueError(f"sync_every={self.sync_every}: the host "
                             "must sync at least every round (>= 1)")
        return self

    # ------------------------------------------------------------- flags
    @staticmethod
    def add_arguments(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
        ap.add_argument("--algo", default="cyclesfl",
                        choices=algorithm_names())
        ap.add_argument("--task", default="image", choices=task_names())
        ap.add_argument("--rounds", type=int, default=100)
        ap.add_argument("--clients", type=int, default=100)
        ap.add_argument("--attendance", type=float, default=0.05)
        ap.add_argument("--batch", type=int, default=16)
        ap.add_argument("--lr-server", type=float, default=1e-3)
        ap.add_argument("--lr-client", type=float, default=1e-3)
        ap.add_argument("--alpha", type=float, default=0.5)
        ap.add_argument("--server-epochs", type=int, default=1)
        ap.add_argument("--server-batch", type=int, default=None)
        ap.add_argument("--grad-clip", type=float, default=None)
        ap.add_argument("--fused-gather-loss", action="store_true",
                        help="fuse the resample gather with the server "
                             "head's loss (linear-head tasks only)")
        ap.add_argument("--seed", type=int, default=0)
        ap.add_argument("--width", type=int, default=16)
        ap.add_argument("--cut", type=int, default=2)
        ap.add_argument("--eval-every", type=int, default=20)
        ap.add_argument("--sync-every", type=int, default=1,
                        help="host-sync cadence under collect_timing: "
                             "block on round metrics every k rounds")
        ap.add_argument("--no-pad-cohorts", action="store_true",
                        help="disable fixed-shape padded cohorts")
        ap.add_argument("--variable-attendance", action="store_true",
                        help="Binomial(N, attendance) cohort sizes per round")
        ServeConfig.add_arguments(ap)
        return ap

    @classmethod
    def from_flags(cls, args: argparse.Namespace) -> "ExperimentConfig":
        return cls(
            algo=args.algo, task=args.task, rounds=args.rounds,
            n_clients=args.clients, attendance=args.attendance,
            batch=args.batch, lr_server=args.lr_server,
            lr_client=args.lr_client, alpha=args.alpha, seed=args.seed,
            width=args.width, cut=args.cut, eval_every=args.eval_every,
            sync_every=args.sync_every,
            pad_cohorts=not args.no_pad_cohorts,
            variable_attendance=args.variable_attendance,
            serve=ServeConfig.from_flags(args),
            cycle=CycleConfig(server_epochs=args.server_epochs,
                              server_batch=args.server_batch,
                              grad_clip=args.grad_clip,
                              fused_gather_loss=args.fused_gather_loss),
        ).validate()

    def with_cycle(self, **kw) -> "ExperimentConfig":
        return replace(self, cycle=replace(self.cycle, **kw))
