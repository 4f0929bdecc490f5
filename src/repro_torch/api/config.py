"""Frozen experiment description, mirroring ``repro/api/config.py``.

``ExperimentConfig.from_dict`` accepts the JAX package's ``to_dict()``
output unchanged, so one dict drives both packages.  Every field the
JAX package has is kept with its default.  The mesh knobs run the round
on a ``torch.distributed`` mesh, ``(data, model)`` or ``(pod, data,
model)``, whose weights lie as the reference places them (FSDP over
``data``, the dense stages' columns over ``model``); every other knob
combines with them (the pipelined rounds, resilience, checkpoints and
resume, a scenario, a serve config).  ``scenario`` and
``resilience`` are the port's ``ScenarioConfig`` and
``ResilienceConfig`` (their dict forms load too); ``serve`` is the
port's ``ServeConfig``, which ``repro_torch.launch.serve --continuous``
reads.
"""
from __future__ import annotations

import argparse
from dataclasses import asdict, dataclass, field, fields, replace
from typing import Optional

from repro_torch.api.registry import algorithm_names, get_program
from repro_torch.api.tasks import TASKS, task_names
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.resilience.config import ResilienceConfig
from repro_torch.scenario.profiles import ScenarioConfig
from repro_torch.serve.config import ServeConfig

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
    # checkpoint after every evaluation (step = rounds done); with
    # resume, run() restores the newest valid checkpoint under ckpt_dir
    # and continues at its round, the cohort stream replayed
    ckpt_dir: Optional[str] = None
    resume: bool = False
    # ---- the device mesh: one rank a card over torch.distributed; the
    # cohort's slots split over the batch axes ('pod', 'data'); with
    # shard_cohort off every rank runs the whole round
    mesh_shape: Optional[tuple] = None
    mesh_axes: tuple = ("data", "model")
    shard_cohort: bool = True
    # ---- pipelined rounds ----
    # 0 = sequential rounds; L >= 1 keeps a ring of in-flight extracted
    # cohorts: the extract of cohort k + L (async) or k + 1 (sync) runs
    # around the tail of cohort k
    pipeline_depth: int = 0
    # 'sync'  extract(k + 1) reads the post-Commit state of round k: the
    #         sequential run, bit for bit, at any depth;
    # 'async' extract(k + L) reads the pre-tail state of round k, so the
    #         client params and the θ_S^t snapshot are stale by at most
    #         L rounds; on the card it runs on a side stream beside the
    #         tail of round k
    pipeline_staleness: str = "sync"
    # scale a stale cohort's server and feature gradients by its
    # realized lag: 'none', 'inverse' 1 / (1 + lag), 'exp'
    # exp(-staleness_lambda * lag)
    staleness_weighting: str = "none"
    staleness_lambda: float = 0.5
    # client-population scenario; kind='none' builds no stream and the
    # Engine runs its scenario-free path
    scenario: ScenarioConfig = field(default_factory=ScenarioConfig)
    # health guards, recovery policies, fault injection; the null config
    # builds no guard phase and no controller
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
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
        # configs from before these fields lack them: the null scenario,
        # the null resilience config, the default serve knobs
        scenario = d.pop("scenario", {})
        if not isinstance(scenario, ScenarioConfig):
            scenario = ScenarioConfig.from_dict(scenario)
        resilience = d.pop("resilience", {})
        if not isinstance(resilience, ResilienceConfig):
            resilience = ResilienceConfig.from_dict(resilience)
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
        return cls(cycle=cycle, scenario=scenario, resilience=resilience,
                   serve=serve, **d)

    def validate(self) -> "ExperimentConfig":
        """Raise on a combination the port lacks, then check the fields."""
        if self.mesh_shape is not None and \
                len(self.mesh_shape) != len(self.mesh_axes):
            raise ValueError(f"mesh_shape {self.mesh_shape} and "
                             f"mesh_axes {self.mesh_axes} must have "
                             "equal length")
        self.cycle.check_ported()
        self.serve.validate()
        get_program(self.algo)
        if self.task not in TASKS:
            raise KeyError(f"unknown task {self.task!r}: {sorted(TASKS)}")
        if self.sync_every < 1:
            raise ValueError(f"sync_every={self.sync_every}: the host "
                             "must sync at least every round (>= 1)")
        if self.pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth={self.pipeline_depth}: expected 0 "
                "(sequential) or a positive staleness window L")
        if self.pipeline_staleness not in ("sync", "async"):
            raise ValueError(
                f"pipeline_staleness={self.pipeline_staleness!r}: expected "
                "'sync' or 'async'")
        if self.staleness_weighting not in ("none", "inverse", "exp"):
            raise ValueError(
                f"staleness_weighting={self.staleness_weighting!r}: "
                "expected 'none', 'inverse' or 'exp'")
        if self.staleness_lambda < 0:
            raise ValueError(
                f"staleness_lambda={self.staleness_lambda} must be >= 0")
        self.scenario.validate()
        if self.scenario.churns and not self.pad_cohorts:
            # churn zeroes slots in the attendance mask; without padded
            # cohorts there is no mask to zero
            raise ValueError(
                f"scenario kind={self.scenario.kind!r} with dropout/"
                "straggler churn requires pad_cohorts=True (mid-round "
                "drops ride the attendance mask)")
        self.resilience.validate()
        if self.resilience.quarantines and not self.pad_cohorts:
            # quarantine zeroes blamed slots in the attendance mask, the
            # same machinery as scenario churn
            raise ValueError(
                "resilience quarantine policy requires pad_cohorts=True "
                "(slot quarantine rides the attendance mask)")
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
        ap.add_argument("--ckpt-dir", default=None,
                        help="checkpoint after every evaluation here")
        ap.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in "
                             "--ckpt-dir")
        ap.add_argument("--sync-every", type=int, default=1,
                        help="host-sync cadence under collect_timing: "
                             "block on round metrics every k rounds")
        ap.add_argument("--no-pad-cohorts", action="store_true",
                        help="disable fixed-shape padded cohorts")
        ap.add_argument("--variable-attendance", action="store_true",
                        help="Binomial(N, attendance) cohort sizes per round")
        ap.add_argument("--pipeline-depth", type=int, default=0,
                        help="L >= 1 keeps an L-deep ring of in-flight "
                             "cohort extractions (0 = sequential)")
        ap.add_argument("--pipeline-staleness", default="sync",
                        choices=("sync", "async"),
                        help="sync = barrier mode (bit for bit the "
                             "sequential Engine); async = bounded-stale "
                             "extraction (lag <= depth) beside the tail")
        ap.add_argument("--staleness-weighting", default="none",
                        choices=("none", "inverse", "exp"),
                        help="scale stale cohorts' server/feature "
                             "gradients by realized lag: 1/(1+lag) or "
                             "exp(-lambda*lag)")
        ap.add_argument("--staleness-lambda", type=float, default=0.5,
                        help="decay rate for --staleness-weighting exp")
        ScenarioConfig.add_arguments(ap)
        ResilienceConfig.add_arguments(ap)
        ap.add_argument("--mesh-shape", default=None,
                        help="device mesh, e.g. 4,1: one rank a card, "
                             "launched by torchrun --nproc-per-node 4")
        ap.add_argument("--mesh-axes", default="data,model",
                        help="the mesh's axis names")
        ap.add_argument("--no-shard-cohort", action="store_true",
                        help="on a mesh, run the whole round on every rank")
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
            ckpt_dir=args.ckpt_dir, resume=args.resume,
            sync_every=args.sync_every,
            pad_cohorts=not args.no_pad_cohorts,
            variable_attendance=args.variable_attendance,
            pipeline_depth=args.pipeline_depth,
            pipeline_staleness=args.pipeline_staleness,
            staleness_weighting=args.staleness_weighting,
            staleness_lambda=args.staleness_lambda,
            mesh_shape=(None if args.mesh_shape is None else
                        tuple(int(v) for v in args.mesh_shape.split(","))),
            mesh_axes=tuple(args.mesh_axes.split(",")),
            shard_cohort=not args.no_shard_cohort,
            scenario=ScenarioConfig.from_flags(args),
            resilience=ResilienceConfig.from_flags(args),
            serve=ServeConfig.from_flags(args),
            cycle=CycleConfig(server_epochs=args.server_epochs,
                              server_batch=args.server_batch,
                              grad_clip=args.grad_clip,
                              fused_gather_loss=args.fused_gather_loss),
        ).validate()

    def with_cycle(self, **kw) -> "ExperimentConfig":
        return replace(self, cycle=replace(self.cycle, **kw))
