"""The driver loop: sample cohorts, run rounds, evaluate, checkpoint.

Port of the single-device path of ``repro/api/engine.py``: its timing
windows (``collect_timing``, ``sync_every``), crash-safe checkpoints and
resume (``ckpt_dir``, ``resume``), the client-population scenario
(``scenario``), the fault-tolerant runtime (``resilience``) and the
pipelined rounds (``pipeline_depth``, ``pipeline_staleness``): a ring
of in-flight extracted cohorts, whose async extracts run on a side CUDA
stream beside the tail of the round before (the stand-in for JAX's
asynchronous dispatch), and the mesh (``mesh_shape``, ``mesh_axes``,
``shard_cohort``): one rank a card over ``torch.distributed``, the
cohort's slots split over the ranks, the per-client store row-sharded.
Every rank samples the same cohort from the seed and copies only its
own slots' batches to its device; metrics and evaluations come out the
same on every rank.

Every path runs on the mesh as off it.  The host-side streams (cohort
draws, scenario events, the fault stream) are seeded and the same on
every rank; the guard's verdict is agreed over the ranks inside the
round (``resilience.guards.agree``), so every rank takes the same
recovery path; a checkpoint is the whole state, gathered from every
rank and written by rank 0 alone, and a restore cuts each rank's blocks
out of it (the file is the unsharded run's: it loads off the mesh, on
any mesh and in the reference).  Host decisions that must agree
otherwise (the step to resume, a finished write) go over a host group
(``launch.mesh.host_comm``, census ``host/...``).

The async pipelined extract runs on a side stream (on the card), and on
a mesh it issues collectives of its own (the store rows' read, the
shared client's FSDP gather, a ``model`` axis' activation gathers).  It
shares each group's communicator with the tail, which cannot deadlock:
every rank issues the same host calls in one order (the extract of
cohort k + L wholly before the tail of cohort k), NCCL runs one
communicator's calls in that order, and every call waits only on work
issued before it (the side stream waits on the main stream's work up to
the prefetch; the main stream waits on the side stream only through a
stage's ``ready`` event, recorded before any later call).  So the
earliest call not yet finished on some rank has what it waits on done
on every rank, and runs.  The cost is that a tail's first collective
queues behind the extract's on that communicator.

    eng = Engine(ExperimentConfig(algo="cyclesfl", rounds=100))
    result = eng.run()           # {"history": [...], "grad_stability": ...}

The Engine runs on the card unless the caller passes ``device="cpu"``;
with no card it raises.  Cohort draws come from numpy's
``default_rng(seed + 1)``, exactly as in the JAX package, so both
packages train on the same cohorts and batches; scenario and fault
streams are numpy fold-ins of (seed, salt, round), equal in both.
``cfg.resume`` restores the newest valid checkpoint under ``ckpt_dir``
and continues at its round with the eval/ckpt cadence and the sampling
stream aligned.  Callbacks are objects with ``on_round(engine, rnd,
state, metrics)`` and/or ``on_eval(engine, rnd, loss, mets)``.
"""
from __future__ import annotations

import math
import time
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.config import ExperimentConfig
from repro_torch.api.phases import (PipelinedAlgorithm, SLAlgorithm,
                                    TrainState, build_algorithm,
                                    build_pipelined_algorithm, place_state,
                                    slot_split, whole_state)
from repro_torch.api.registry import get_program
from repro_torch.api.tasks import build_task
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    load_metadata, save_checkpoint)
from repro_torch.core.cyclesl import PlanFn
from repro_torch.core.drift import GradStabilityTracker
from repro_torch.core.feature_store import StaleFeatureRing
from repro_torch.core.split import SplitTask
from repro_torch.data.federated import FederatedDataset, sample_cohort
from repro_torch.launch.mesh import host_comm
from repro_torch.optim import adam
from repro_torch.resilience import (HEALTH_EMA, HEALTH_NONFINITE,
                                    HEALTH_SPIKE, FaultInjectedError,
                                    RecoveryController,
                                    ResilienceExhaustedError,
                                    build_fault_stream)
from repro_torch.scenario.profiles import build_profile_stream
from repro_torch.sharding.specs import shard_aligned_capacity
from repro_torch.utils.device import resolve_device  # noqa: F401
from repro_torch.utils.profiling import NULL_SECTION
from repro_torch.utils.tree import tree_leaves, tree_map


def evaluate(task, state, fed, batch: int = 256, max_batches: int = 8,
             max_clients: int = 40):
    """Test metrics matching the paper's protocol (§4.1).

    SFL family (shared client model): the pooled sample-wise test set,
    sample-weighted.  PSL family (per-client models, never aggregated):
    each of the first ``max_clients`` clients that hold test data is
    scored with ITS OWN model on its first ``t`` test samples (``t`` the
    smallest test size among them), and the clients' means are averaged
    unweighted.  Either way the host reads the device once.
    """
    sp = state.server.params
    device = state.server.step.device
    if state.client_global is None:
        return _evaluate_per_client(task, state.clients.params, sp, fed,
                                    device, max_clients)
    cp = state.client_global.params
    try:
        xs, ys = fed.test_arrays()
    except ValueError:
        xs = ys = ()
    if not len(xs):
        warnings.warn("evaluate: pooled test set is empty; skipping "
                      "evaluation (NaN loss)", RuntimeWarning, stacklevel=2)
        return float("nan"), {}
    n = min(len(xs), batch * max_batches)
    losses, mets, ws = [], [], []
    with torch.no_grad():
        for lo in range(0, n, batch):
            hi = min(lo + batch, n)
            x = torch.from_numpy(xs[lo:hi]).to(device)
            y = torch.from_numpy(ys[lo:hi]).to(device)
            out = task.predict(cp, sp, x)
            losses.append(task.loss(out, y))
            mets.append(task.metrics(out, y))
            ws.append(hi - lo)
    # one device -> host transfer for the whole evaluation
    host = torch.stack(losses + [m[k] for m in mets for k in sorted(m)]
                       ).cpu().numpy()
    keys = sorted(mets[0])
    loss = float(np.average(host[:len(ws)], weights=ws))
    per = host[len(ws):].reshape(len(ws), len(keys))
    return loss, {k: float(np.average(per[:, j], weights=ws))
                  for j, k in enumerate(keys)}


def _evaluate_per_client(task, client_params, sp, fed, device,
                         max_clients: int):
    idxs = [i for i, c in enumerate(fed.clients) if len(c.x_test)]
    idxs = idxs[:max_clients]
    if not idxs:
        warnings.warn("evaluate: no sampled client has test data; "
                      "skipping per-client evaluation (NaN loss)",
                      RuntimeWarning, stacklevel=3)
        return float("nan"), {}
    t = min(len(fed.clients[i].x_test) for i in idxs)
    xs = torch.from_numpy(np.stack([fed.clients[i].x_test[:t]
                                    for i in idxs])).to(device)
    ys = torch.from_numpy(np.stack([fed.clients[i].y_test[:t]
                                    for i in idxs])).to(device)
    losses, mets = [], []
    with torch.no_grad():
        for j, i in enumerate(idxs):
            out = task.predict(tree_map(lambda p: p[i], client_params), sp,
                               xs[j])
            losses.append(task.loss(out, ys[j]))
            mets.append(task.metrics(out, ys[j]))
    keys = sorted(mets[0])
    # one device -> host transfer: the loss and each metric, averaged
    # over the clients
    host = torch.stack([torch.stack(losses).mean()]
                       + [torch.stack([m[k] for m in mets]).mean()
                          for k in keys]).cpu().numpy()
    return float(host[0]), {k: float(host[1 + j]) for j, k in enumerate(keys)}


class Engine:
    """Build the task and the algorithm once, drive the whole experiment.

    ``plan_fn`` replaces the server's resample plan (see
    ``repro_torch.core.cyclesl.PlanFn``); its ``key`` is
    :meth:`round_key` of the round.  ``side_stream`` (async pipelining
    on the card only) runs each prefetched extract on a second CUDA
    stream; False keeps the whole schedule on one stream.

    With ``cfg.mesh_shape`` the Engine builds the mesh once
    (``launch.mesh.make_engine_mesh``, over the process group torchrun
    or the caller started) and trains on this rank's card; ``close()``
    ends a process group the mesh started itself.  The task is placed on
    the mesh (``api.tasks.build_task(..., mesh=)``): on a ``model`` axis
    its dense stages split their columns, and where the round splits the
    cohort the server and the shared client model hold FSDP blocks over
    ``data`` (the reference's ``train_state_shardings``).  Callbacks see
    this rank's state; :meth:`whole_state` gathers it whole.  ``host`` is
    the host group's collectives a checkpointing run on more than one
    rank agrees over (None otherwise).

    ``donate`` donates the TrainState to every round, as the reference's
    Engine does (``api.phases.build_algorithm(..., donate=True)``: the
    entities are stepped in place, so a card holds each one's state
    once).  ``None`` turns it on for a CUDA device and off on the CPU;
    ``True`` is honoured on the CPU too.  It is off whenever
    ``cfg.resilience.active``: the guard's recovery re-runs a faulted
    round from the pre-round state and rolls back to its snapshot ring,
    which must outlive the dispatch.  The pipelined tail donates the
    state only under ``pipeline_staleness == "sync"`` (an async extract
    of a later cohort still reads the pre-tail state, on the card on the
    side stream); it donates its stage in both modes.  On a mesh each
    rank donates its own blocks and slots.  A state passed to
    :meth:`run` is donated with the rest: the caller reads it no more.

    ``profiler`` (a ``utils.profiling.RoundProfiler``) times the run
    loop's host sections, ``sample``, ``dispatch``, ``sync`` and
    ``eval``, where the reference's Engine opens them, and ``run()``
    returns its summary as ``result["profile"]``; the run is otherwise
    the unprofiled one.
    """

    def __init__(self, cfg: ExperimentConfig, *, device=None,
                 task: Optional[SplitTask] = None,
                 fed: Optional[FederatedDataset] = None,
                 metric_key: Optional[str] = None,
                 callbacks: Sequence = (),
                 plan_fn: Optional[PlanFn] = None,
                 side_stream: bool = True,
                 donate: Optional[bool] = None,
                 profiler=None,
                 log=print):
        cfg.validate()
        self.profiler = profiler
        self.mesh = None
        if cfg.mesh_shape is not None:
            from repro_torch.launch.mesh import make_engine_mesh
            self.mesh = make_engine_mesh(cfg.mesh_shape, cfg.mesh_axes,
                                         device)
            self.device = self.mesh.device
        else:
            self.device = resolve_device(device)
        if (task is None) != (fed is None):
            raise ValueError("pass BOTH task and fed (they come from one "
                             "generator) or neither")
        if task is None:
            task, fed, mk = build_task(cfg.task, cfg.n_clients, cfg.alpha,
                                       cfg.seed, cfg.width, cfg.cut,
                                       mesh=self.mesh)
            metric_key = metric_key or mk
        self.cfg = cfg
        self.task = task
        self.fed = fed
        self.metric_key = metric_key or "accuracy"
        self.callbacks = tuple(callbacks)
        self.log = log
        # ---- fault-tolerant runtime: the deterministic fault stream and
        # the (per-run) recovery controller.  The null ResilienceConfig
        # builds neither and changes nothing downstream.
        self.faults = build_fault_stream(cfg.resilience.faults, cfg.seed)
        self.recovery: Optional[RecoveryController] = None
        self._ema = None                  # loss-EMA carry (device scalar)
        self._ckpt_corruptions = 0
        # ---- client-population scenario: the profile stream feeding
        # per-round attendance weights + drop/lag events.  None for the
        # null scenario (kind='none'): every scenario branch below is
        # then skipped and the run is the scenario-free one.
        self.scenario = build_profile_stream(cfg.scenario, fed.n_clients,
                                             cfg.seed)
        # resume-replay ledger window: draws for rounds below the cutoff
        # rebuild the quarantine set the ORIGINAL run's sampler saw at
        # that round (from the persisted event history) instead of the
        # final restored set; see restore()
        self._ledger_cutoff = 0
        self._ledger_offset = 0
        self._sample_clock = 0            # rounds drawn so far (scenario
                                          # streams fold this in, resume
                                          # fast-forwards it)
        self._telemetry: list[dict] = []  # one row per sampled round
        # the θ staleness the schedule can realize: async pipelining at
        # depth L carries snapshots up to L rounds old; everything else
        # delivers fresh params
        self._sched_lag = (cfg.pipeline_depth
                           if cfg.pipeline_staleness == "async" else 0)
        program = get_program(cfg.algo)
        churns = self.scenario is not None and self.scenario.churns
        if (cfg.pad_cohorts and (cfg.variable_attendance or churns)
                and any(getattr(p, "mode", None) == "cycle"
                        for p in program.phases)):
            # the masked inner loop runs a static number of steps; a
            # server batch above the smallest possible live pool would
            # leave a sparse or churn-thinned round with no valid step,
            # and the server would silently not train that round
            sb = cfg.cycle.server_batch or cfg.batch
            if sb > cfg.batch * cfg.min_cohort:
                raise ValueError(
                    f"cycle.server_batch={sb} can exceed the smallest "
                    f"possible live feature pool (min_cohort={cfg.min_cohort}"
                    f" x batch={cfg.batch} = {cfg.min_cohort * cfg.batch} "
                    "rows) under variable attendance or scenario churn, "
                    "which would leave the server inner loop with zero "
                    "valid steps in sparse rounds; lower cycle.server_batch "
                    "or raise min_cohort")
        if donate is None:
            donate = self.device.type == "cuda"
        if cfg.resilience.active:
            # the pre-round state and the snapshot ring must outlive
            # every dispatch, so a faulted round can re-run from them
            donate = False
        self.donate = donate
        opt_s, opt_c = adam(cfg.lr_server), adam(cfg.lr_client)
        self.algo: SLAlgorithm = build_algorithm(
            program, task, opt_s, opt_c, cfg.cycle, plan_fn=plan_fn,
            device=self.device, resilience=cfg.resilience, mesh=self.mesh,
            shard_data=cfg.shard_cohort, n_clients=fed.n_clients,
            donate=donate)
        # ---- pipelined rounds: the (extract, tail) pair, so cohort k+1's
        # feature extraction can be in flight while cohort k's server
        # phase runs.  None for the fused sequential programs (nothing to
        # overlap): the run loop then runs whole rounds.
        self.pipeline: Optional[PipelinedAlgorithm] = None
        self.pipeline_stats: dict = {}
        if cfg.pipeline_depth > 0:
            self.pipeline = build_pipelined_algorithm(
                program, task, opt_s, opt_c, cfg.cycle, plan_fn=plan_fn,
                device=self.device, resilience=cfg.resilience,
                staleness_weighting=cfg.staleness_weighting,
                staleness_lambda=cfg.staleness_lambda, mesh=self.mesh,
                shard_data=cfg.shard_cohort, n_clients=fed.n_clients,
                donate=donate,
                donate_state=cfg.pipeline_staleness == "sync")
        if self.pipeline is None:
            # whole rounds deliver fresh params whatever depth says
            self._sched_lag = 0
        self._side = (torch.cuda.Stream(self.device)
                      if side_stream and self._sched_lag
                      and self.device.type == "cuda" else None)
        # the host group a mesh's checkpoints agree over (None off the
        # mesh, at one rank and without checkpoints); rank 0 alone writes
        self.host = (host_comm(self.mesh)
                     if self.mesh is not None and cfg.ckpt_dir else None)
        self._lead = self.host is None or self.host.rank == 0

    @property
    def ring_depth(self) -> int:
        """In-flight extract stages the run loop keeps: the staleness
        window L in async mode, one stage in sync mode (at any depth: the
        sync extract(k+1) waits for Commit(k), so a deeper ring could
        never fill), 0 unpipelined."""
        if self.pipeline is None:
            return 0
        return self._sched_lag if self._sched_lag else 1

    # ------------------------------------------------------------ state
    def init_state(self) -> TrainState:
        return self.algo.init(self.cfg.seed, self.fed.n_clients)

    def round_key(self, rnd: int) -> int:
        return self.cfg.seed * self.cfg.round_key_salt + rnd

    @property
    def cohort_capacity(self) -> int:
        """C_max: the static cohort shape every round is padded to.
        Fixed attendance draws exactly ``round(attendance * N)`` clients,
        so no slot is padded unless ``min_cohort`` lifts the capacity;
        variable attendance pads to the ceil, to which the sampler clips
        its Binomial draws."""
        cfg = self.cfg
        n = self.fed.n_clients
        if cfg.variable_attendance:
            # tolerant ceil: 0.3 * 20 is 6.000000000000001 in binary
            cap = math.ceil(cfg.attendance * n - 1e-9)
        else:
            cap = round(cfg.attendance * n)
        return min(max(cfg.min_cohort, cap), n)

    @property
    def padded_capacity(self) -> int:
        """The shape rounds are padded to: :attr:`cohort_capacity` rounded
        up to a multiple of the mesh's batch-axis shard count, so every
        rank owns an equal share of the slots.  The sampler still clips
        to the capacity, so the draws do not depend on the rank count;
        the added slots are dead (sentinel id, zero mask) like any
        padded slot.  Identity off the mesh, at one rank and with
        ``shard_cohort`` off."""
        cap = self.cohort_capacity
        if self.mesh is None or not self.cfg.shard_cohort:
            return cap
        return shard_aligned_capacity(self.mesh, cap)

    def whole_state(self, state: TrainState, model: bool = True
                    ) -> TrainState:
        """The whole TrainState on every rank: the per-client store's
        rows, the FSDP blocks over ``data`` and (with ``model``) the
        ``model`` blocks gathered from the mesh; off the mesh, ``state``
        itself.  Evaluation reads it with the ``model`` blocks kept,
        which the task's forwards take."""
        if self.mesh is None:
            return state
        return whole_state(state, self.algo.store_rows, self.mesh.comm,
                           self.algo.task, model=model)

    def close(self):
        """End the process group the Engine's mesh started (a world of 1
        with no group of its own); a group torchrun or the caller
        started is left to them."""
        if self.mesh is not None:
            self.mesh.close()

    def _sample_cohort_ids(self, rng: np.random.Generator) -> np.ndarray:
        """Draw one round's live cohort, advancing the sample clock.

        Called exactly once per round by both :meth:`sample_round` and
        :meth:`_replay_sampling`, so the clock (which time-varying
        scenario streams fold into their attendance weights) stays
        aligned across resume replays.  The null scenario contributes
        ``weights=None``: ``rng.choice`` then takes the exact draw path
        of the scenario-free Engine (it takes another path when ``p=``
        is given).
        """
        cfg = self.cfg
        rnd = self._sample_clock
        self._sample_clock = rnd + 1
        weights = (self.scenario.weights(rnd)
                   if self.scenario is not None else None)
        if self.recovery is not None:
            # quarantined clients draw weight 0 from here on; with no
            # quarantines this passes through (None stays None)
            ctl = self.recovery
            if rnd < self._ledger_cutoff:
                # resume replay: this draw happened BEFORE some of the
                # restored ledger's events; weight it with the set as of
                # its original draw time (pipelined runs draw ring_depth
                # rounds ahead of recovery, hence the offset)
                saved = ctl.quarantined
                ctl.quarantined = ctl.quarantined_as_of(
                    rnd - self._ledger_offset)
                weights = ctl.sampling_weights(weights)
                ctl.quarantined = saved
            else:
                weights = ctl.sampling_weights(weights)
        return sample_cohort(self.fed.n_clients, cfg.attendance, rng,
                             min_cohort=cfg.min_cohort,
                             variable=cfg.variable_attendance,
                             max_cohort=(self.cohort_capacity
                                         if cfg.pad_cohorts else None),
                             weights=weights)

    def _replay_sampling(self, rng: np.random.Generator, rounds: int):
        """Consume exactly the RNG draws ``rounds`` rounds of
        :meth:`sample_round` would make (cohort ids plus each member's
        batch indices) without building any array, so round ``n`` of a
        resumed run draws the cohort an unbroken run would."""
        for _ in range(rounds):
            for c in self._sample_cohort_ids(rng):
                self.fed.clients[c].sample_indices(rng, self.cfg.batch)

    def sample_round(self, rng: np.random.Generator):
        """Cohort ids, per-client (x, y) batches and the attendance mask
        for one round, as tensors on the Engine's device.

        With ``cfg.pad_cohorts`` the cohort is padded to
        :attr:`padded_capacity`: padded slots carry the sentinel id N,
        zeroed batches and a 0 in the mask.  ``mask`` is None otherwise.

        Scenario churn rides the same mask: a mid-round dropout (hazard
        draw, or a straggler whose drawn lag exceeds its staleness bound)
        zeroes its LIVE slot, so its features never enter a valid server
        minibatch and its commit is skipped.  The client's batch is
        still drawn first, keeping the rng stream that of a no-churn
        round.  Each call appends one telemetry row.
        """
        cfg = self.cfg
        cohort = self._sample_cohort_ids(rng)
        rnd = self._sample_clock - 1       # the round that draw was for
        live = len(cohort)
        pairs = [self.fed.clients[c].sample_batch(rng, cfg.batch)
                 for c in cohort]
        xs = np.stack([p[0] for p in pairs])
        ys = np.stack([p[1] for p in pairs])
        row = {"round": rnd, "cohort": live, "live": live, "dropped": 0,
               "drop_hazard": 0, "drop_deadline": 0, "lag_drawn_max": 0,
               "realized_lag": 0}
        self._telemetry.append(row)
        put = lambda a: None if a is None else torch.from_numpy(a).to(
            self.device)
        if not cfg.pad_cohorts:
            xs, ys = self._own_slots(xs, ys)
            return put(cohort), put(xs), put(ys), None
        cap = self.padded_capacity
        pad = cap - live
        mask = np.ones(cap, np.float32)
        if pad:
            cohort = np.concatenate(
                [cohort, np.full(pad, self.fed.n_clients, cohort.dtype)])
            xs = np.concatenate([xs, np.zeros((pad,) + xs.shape[1:],
                                              xs.dtype)])
            ys = np.concatenate([ys, np.zeros((pad,) + ys.shape[1:],
                                              ys.dtype)])
            mask[-pad:] = 0.0
        if self.scenario is not None and self.scenario.churns:
            ev = self.scenario.events(rnd, cohort[:live],
                                      min_live=cfg.min_cohort)
            mask[:live] *= ev.keep
            kept = int(ev.keep.sum())
            row.update(live=kept, dropped=live - kept,
                       drop_hazard=ev.hazard_drops,
                       drop_deadline=ev.deadline_drops,
                       lag_drawn_max=int(ev.lag.max()) if live else 0)
        xs, ys = self._own_slots(xs, ys)
        return put(cohort), put(xs), put(ys), put(mask)

    def _own_slots(self, xs, ys):
        """On a mesh, the batches of this rank's slots only (the cohort
        ids and the mask stay whole)."""
        split = slot_split(self.algo.mesh, len(xs))
        if split is None:
            return xs, ys
        return xs[split.lo:split.hi], ys[split.lo:split.hi]

    def sync(self, metrics):
        """Block until the round's work is done: the card's queue drains
        (on the CPU every op has run; the loss is read all the same)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        else:
            float(metrics["server_loss"])

    def _emit(self, hook: str, *args):
        for cb in self.callbacks:
            fn = getattr(cb, hook, None)
            if fn is not None:
                fn(self, *args)

    # ----------------------------------------------------------- resume
    def restore(self, rng: np.random.Generator
                ) -> tuple[Optional[TrainState], int]:
        """Load the newest valid checkpoint under ``cfg.ckpt_dir`` and
        return ``(state, start_round)``; ``(None, 0)`` when there is
        nothing to resume.

        The checkpoint step is the 1-based round it was saved after, so
        the run continues at exactly that round index and the eval/ckpt
        cadence stays aligned.  The sampling stream is replayed through
        the skipped rounds, so round ``start_round`` draws the cohort an
        unbroken run would have drawn.
        """
        cfg = self.cfg
        step = (latest_step(cfg.ckpt_dir) if cfg.ckpt_dir and self._lead
                else None)
        if self.host is not None:
            # rank 0's choice, so every rank resumes from one step even
            # past a step torn while the others looked
            step = int(self.host.broadcast(torch.tensor(
                [-1 if step is None else step]), "ckpt_step")[0])
            step = None if step < 0 else step
        if step is None:
            return None, 0
        # the fresh state is the template: structure, dtypes, device (the
        # leaves come back whole, in the file's shapes); on a mesh each
        # rank then cuts out its blocks, the model blocks too
        state, _ = load_checkpoint(cfg.ckpt_dir, self.init_state(),
                                   step=step)
        if self.mesh is not None:
            state = place_state(state, self.algo.store_rows, self.algo.task,
                                model=True)
        if self.recovery is not None:
            # restore the recovery carry BEFORE replaying the sampling
            # stream: the replay rebuilds each round's quarantine set
            # from the persisted event history, so the replayed draws
            # consume exactly the variates the original run's did.
            # Checkpoints without the key keep the fresh controller.
            meta = load_metadata(cfg.ckpt_dir, step).get("resilience")
            if meta:
                self.recovery.restore_state(meta)
                if "ema" in meta:
                    self._ema = torch.tensor(meta["ema"],
                                             dtype=torch.float32,
                                             device=self.device)
            # pipelined runs draw round r's cohort ring_depth loop
            # iterations early (before the recovery of rounds r-L..r-1),
            # so their draws trail the ledger by ring_depth rounds,
            # including the priming draws for rounds step..step+L-1
            self._ledger_offset = self.ring_depth
            self._ledger_cutoff = step + self._ledger_offset
        self._replay_sampling(rng, step)
        self.log(f"[{self.algo.name}] resumed from {cfg.ckpt_dir} at "
                 f"round {step}")
        return state, step

    def _save(self, step: int, state: TrainState):
        """Checkpoint ``state`` as ``step`` with the run's metadata; the
        fault stream may then tear the write.  On a mesh every rank takes
        part in gathering the whole state, rank 0 alone writes (and
        tears), and the ranks meet on the host group after it, so none
        reads a step that is half written; a failed write raises on
        every rank."""
        cfg = self.cfg
        meta = {"algo": self.algo.name}
        if self.recovery is not None:
            # persist the recovery carry a resumed run must not forget:
            # the quarantine ledger (+ replayable event history) and the
            # spike-EMA scalar (fp32 -> python float -> fp32 is exact)
            meta["resilience"] = {**self.recovery.export_state(),
                                  "ema": float(self._ema)}
        whole = self.whole_state(state)
        torn = self.faults is not None and self.faults.ckpt_corrupt(step)
        err = None
        if self._lead:
            try:
                save_checkpoint(cfg.ckpt_dir, step, whole, metadata=meta)
                if torn:
                    # tear the just-written step: restore must fall back
                    # past it to the newest valid one
                    self.faults.corrupt_checkpoint(cfg.ckpt_dir, step)
            except Exception as e:      # noqa: BLE001 — raised below
                err = e
        if self.host is not None:
            flag = torch.tensor([int(err is not None)], dtype=torch.int32)
            if int(self.host.all_reduce(flag, "ckpt")[0]) and err is None:
                err = RuntimeError(f"checkpoint step {step} failed on "
                                   "rank 0")
        if err is not None:
            raise err
        if torn:
            self._ckpt_corruptions += 1
            self.log(f"[resilience] injected torn checkpoint at step {step}")

    # --------------------------------------------------------- pipeline
    def _extract(self, state, inputs):
        """The ExtractFeatures head for one cohort, on the current
        stream."""
        cohort, xs, ys, mask = inputs
        return self.pipeline.extract(state, cohort, xs, ys, mask)

    def _prefetch(self, state, inputs):
        """``(stage, ready)``: the extract of a prefetched cohort.  In
        async mode on the card it runs on the side stream, after the work
        queued so far (the pre-tail state and the cohort's copies) and
        beside the tail that follows; ``ready`` is the event the tail of
        its own round waits on.  The side stream's reads are recorded on
        the state's and inputs' memory, and the consumer's stream on the
        stage's, so the caching allocator hands neither to other work
        while the other stream may still use it.  Otherwise ``(stage,
        None)`` on the current stream."""
        if self._side is None:
            return self._extract(state, inputs), None
        main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            stage = self._extract(state, inputs)
            ready = torch.cuda.Event()
            ready.record(self._side)
        for t in tree_leaves((state, inputs)):
            t.record_stream(self._side)
        for t in tree_leaves(stage):
            t.record_stream(main)
        return stage, ready

    def _tail(self, state, inputs, stage, key, lag: int = 0, ready=None):
        """The ServerUpdate..Commit tail consuming ``stage`` (after its
        extract's ``ready`` event, when it ran on the side stream)."""
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        cohort, xs, ys, mask = inputs
        kw = {}
        if self.cfg.staleness_weighting != "none":
            kw["lag"] = lag
        ema = self._ema if self.cfg.resilience.guard else None
        return self.pipeline.tail(state, cohort, xs, ys, key, stage, mask,
                                  ema, **kw)

    # ------------------------------------------------------- resilience
    def _round_call(self, state, inputs, key):
        """One round; with the guard on it takes the EMA carry."""
        cohort, xs, ys, mask = inputs
        if self.cfg.resilience.guard:
            return self.algo.round(state, cohort, xs, ys, key, mask,
                                   self._ema)
        return self.algo.round(state, cohort, xs, ys, key, mask)

    def _inject_nan(self, inputs, rnd: int, attempt: int):
        """Fault hook: poison the drawn cohort's input batches with NaN
        per the deterministic stream (no-op without one).  The batch is
        copied first: the clean inputs feed the recovery attempts."""
        if self.faults is None or inputs is None:
            return inputs
        cohort, xs, ys, mask = inputs
        if not xs.is_floating_point():
            return inputs
        live = int((cohort < self.fed.n_clients).sum())
        slots = self.faults.nan_slots_for(rnd, attempt, live)
        if slots.size == 0:
            return inputs
        self.log(f"[resilience] round {rnd} attempt {attempt}: injected "
                 f"NaN features in slots {slots.tolist()}")
        split = slot_split(self.algo.mesh, cohort.shape[0])
        if split is not None:
            # the slots of the whole cohort this rank holds, in its frame
            slots = slots[(slots >= split.lo) & (slots < split.hi)] - split.lo
        xs = xs.clone()
        xs[torch.from_numpy(slots).to(xs.device)] = float("nan")
        return (cohort, xs, ys, mask)

    def _verdict(self, metrics) -> Optional[str]:
        """Host-read the packed health vector: the ONE sync the guard
        costs per round.  Returns the fault kind or None (healthy)."""
        if not self.cfg.resilience.guard:
            return None
        h = metrics["health"].cpu().numpy()
        if h[HEALTH_NONFINITE] > 0:
            return "nonfinite"
        if h[HEALTH_SPIKE] > 0 and self.recovery.spike_armed():
            return "spike"
        return None

    def _recover_round(self, state, inputs, inj0, rnd: int, stage=None,
                       pipelined: bool = False, lag: int = 0, ready=None):
        """Drive round ``rnd`` to an accepted ``(state, metrics)`` under
        the recovery policy.

        ``inputs`` are the CLEAN sampled round inputs; ``inj0`` the
        attempt-0 fault-injected view of them (the same objects when no
        fault fired).  ``stage`` is the already extracted stage of
        ``inj0`` on the pipelined path (``ready`` its event); recovery
        attempts extract again from the current candidate state, because
        the pooled store bakes the attendance mask in at extract time.
        Returns ``(state, metrics, attempts, healthy)``; raises
        :class:`ResilienceExhaustedError` past ``max_retries``.
        """
        ctl, rcfg = self.recovery, self.cfg.resilience
        key = self.round_key(rnd)
        cur_state, cur_inputs, cur_inj, cur_stage = state, inputs, inj0, stage
        kinds: list[str] = []
        actions: list[str] = []
        attempt = 0
        while True:
            site = ("extract" if pipelined and cur_stage is None
                    else ("tail" if pipelined else "round"))
            try:
                if self.faults is not None:
                    self.faults.check_dispatch(rnd, attempt, site)
                if pipelined:
                    # a new extract reads the CURRENT candidate state, so
                    # its realized lag (and staleness weight) resets to 0
                    st, att_lag, att_ready = cur_stage, lag, ready
                    if st is None:
                        st, att_lag, att_ready = (
                            self._extract(cur_state, cur_inj), 0, None)
                    new_state, metrics = self._tail(cur_state, cur_inj, st,
                                                    key, lag=att_lag,
                                                    ready=att_ready)
                else:
                    new_state, metrics = self._round_call(cur_state,
                                                          cur_inj, key)
                kind = self._verdict(metrics)
            except FaultInjectedError as e:
                self.log(f"[resilience] {e}")
                kind, new_state, metrics = "error", None, None
            if kind is None:
                break                      # healthy: accept
            kinds.append(kind)
            if len(kinds) > rcfg.max_retries:
                ctl.record_round(rnd, len(kinds), kinds, actions,
                                 len(ctl.quarantined))
                raise ResilienceExhaustedError(rnd, len(kinds), kinds)
            # resolve the configured action, escalating past the ones
            # that cannot apply (no blamable slot, empty snapshot ring)
            action = ctl.action_for(kind, attempt)
            applied = None
            while applied is None:
                if action == "ignore" and new_state is not None:
                    applied = "ignore"
                elif action == "quarantine":
                    mask = cur_inputs[3]
                    sb = (metrics.get("health_slot_bad")
                          if metrics is not None else None)
                    nm = (ctl.quarantine(cur_inputs[0].cpu().numpy(),
                                         mask.cpu().numpy(),
                                         sb.cpu().numpy(), rnd=rnd)
                          if mask is not None and sb is not None else None)
                    if nm is not None:
                        placed = torch.from_numpy(nm).to(self.device)
                        cur_inputs = cur_inputs[:3] + (placed,)
                        cur_inj = cur_inj[:3] + (placed,)
                        applied = "quarantine"
                elif action == "retry":
                    applied = "retry"
                elif action == "rollback":
                    tgt = ctl.rollback()
                    if tgt is not None:
                        _, cur_state, self._ema = tgt
                        applied = "rollback"
                if applied is None:
                    nxt = ctl.escalate(action) if action else None
                    if nxt is None:
                        applied = "retry"  # last resort
                    else:
                        action = nxt
            actions.append(applied)
            if applied == "ignore":
                self.log(f"[resilience] round {rnd}: {kind} ignored "
                         "by policy")
                break
            self.log(f"[resilience] round {rnd}: {kind} -> {applied} "
                     f"(attempt {len(kinds)}/{rcfg.max_retries})")
            ctl.backoff(len(kinds))
            attempt += 1
            cur_stage = None               # stale: mask or state may differ
            cur_inj = self._inject_nan(cur_inputs, rnd, attempt)
        healthy = kind is None
        ctl.record_round(rnd, len(kinds), kinds, actions,
                         len(ctl.quarantined))
        return new_state, metrics, len(kinds), healthy

    # -------------------------------------------------------------- run
    def run(self, state: Optional[TrainState] = None) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 1)
        if cfg.resilience.active:
            # fresh controller per run: empty quarantine ledger, empty
            # snapshot ring, EMA at the unarmed sentinel.  Built BEFORE
            # any sampling so resume replays see the same (empty) ledger
            # the original run started with.
            self.recovery = RecoveryController(
                cfg.resilience, self.fed.n_clients,
                min_live=cfg.min_cohort, log=self.log)
            self._ema = torch.zeros((), dtype=torch.float32,
                                    device=self.device)
            self._ckpt_corruptions = 0
        start_round = 0
        if state is None and cfg.resume:
            state, start_round = self.restore(rng)
        if state is None:
            state = self.init_state()
        state = place_state(state, self.algo.store_rows, self.algo.task)
        tracker = GradStabilityTracker()
        history = []
        t0 = time.time()
        prof = self.profiler
        sec = (prof.section if prof is not None
               else (lambda name: NULL_SECTION))
        # timing windows: the host syncs every sync_k rounds and at the
        # last; the first round (first launches, cuBLAS/cuDNN set-up) is
        # synced out of the first window and not timed.  The guard reads
        # its health verdict every round by design, so it pins sync_k 1.
        sync_k = 1 if cfg.resilience.guard else max(1, cfg.sync_every)
        round_time, timed_rounds = 0.0, 0
        t_tel = len(self._telemetry)     # rows this run appends start here
        # ---- pipeline prime: sample the first ring_depth cohorts IN ROUND
        # ORDER (the cohort stream stays the sequential one) and extract
        # them from the initial state, consumed at lags 0..L-1.  On resume
        # the restored state primes the ring, as the unbroken run's first
        # rounds are primed from the initial state.
        pipelined = self.pipeline is not None
        ring_depth = self.ring_depth
        ring = StaleFeatureRing(ring_depth) if pipelined else None
        max_lag, cur_lag = 0, 0
        nxt_inputs = None                # the sequential double buffer
        if pipelined:
            for i in range(min(ring_depth, cfg.rounds - start_round)):
                p_inputs = self.sample_round(rng)
                # attempt-0 fault injection comes BEFORE the priming
                # extract, so a poisoned delivery flows into its features
                p_inj = self._inject_nan(p_inputs, start_round + i, 0)
                ring.push(start_round + i, start_round,
                          self._extract(state, p_inj), p_inputs, p_inj)
        for rnd in range(start_round, cfg.rounds):
            healthy = True
            if pipelined:
                # round k's stage leaves the ring before the k+L slot is
                # pushed, so at most L stages are in flight and every
                # consumed lag is <= L
                entry = ring.pop(rnd)
                inputs, inj_inputs = entry.inputs, entry.inj_inputs
                cur_lag = rnd - entry.src_round
                max_lag = max(max_lag, cur_lag)
                with sec("sample"):
                    nxt = (self.sample_round(rng)
                           if rnd + ring_depth < cfg.rounds else None)
                nxt_inj = (self._inject_nan(nxt, rnd + ring_depth, 0)
                           if nxt is not None else None)
                t_round = time.perf_counter()
                if nxt is not None and cfg.pipeline_staleness == "async":
                    # extract(k+L) from the PRE-tail state: it shares no
                    # dependency with tail(k)'s outputs, so on the card it
                    # runs on the side stream beside the tail.  Clients
                    # and the θ_S^t snapshot are stale by exactly L rounds
                    # once the ring is warm
                    stage, ready = self._prefetch(state, nxt_inj)
                    ring.push(rnd + ring_depth, rnd, stage, nxt, nxt_inj,
                              ready)
                if self.recovery is None:
                    with sec("dispatch"):
                        state, metrics = self._tail(
                            state, inj_inputs, entry.stage,
                            self.round_key(rnd), lag=cur_lag,
                            ready=entry.ready)
                else:
                    state, metrics, attempts, healthy = self._recover_round(
                        state, inputs, inj_inputs, rnd, stage=entry.stage,
                        pipelined=True, lag=cur_lag, ready=entry.ready)
                    if attempts and len(ring):
                        # every in-flight prefetch read a pre-round state
                        # that recovery discarded: extract the whole ring
                        # again from the accepted state (the rewound
                        # stages are fresh, their lags restart from 0)
                        ring.rewind(lambda inj: self._extract(state, inj),
                                    src_round=rnd + 1)
                if nxt is not None and cfg.pipeline_staleness != "async":
                    # sync barrier: extract(k+1) reads the post-Commit
                    # state, the sequential schedule bit for bit
                    ring.push(rnd + 1, rnd + 1, self._extract(state, nxt_inj),
                              nxt, nxt_inj)
            else:
                with sec("sample"):
                    # double buffer: the round before drew this round's
                    # cohort and copied it to the device while its own
                    # work was in flight
                    inputs = (nxt_inputs if nxt_inputs is not None
                              else self.sample_round(rng))
                    nxt_inputs = None
                t_round = time.perf_counter()
                if self.recovery is None:
                    with sec("dispatch"):
                        state, metrics = self._round_call(
                            state, inputs, self.round_key(rnd))
                    if rnd + 1 < cfg.rounds:
                        # the next cohort behind the queued round (the
                        # draws are the same, in the same order)
                        with sec("sample"):
                            nxt_inputs = self.sample_round(rng)
                else:
                    # recovery may quarantine clients mid-round, so the
                    # faulted path draws strictly round by round
                    inj = self._inject_nan(inputs, rnd, 0)
                    state, metrics, _, healthy = self._recover_round(
                        state, inputs, inj, rnd)
            if self.recovery is not None and cfg.resilience.guard:
                # thread the EMA carry forward and snapshot last-good
                # states; both stay on the device (no extra host sync)
                self._ema = metrics["health"][HEALTH_EMA]
                if healthy:
                    self.recovery.note_accept(rnd, state, self._ema)
            # telemetry rows are appended at sample time (for pipelined
            # runs ring_depth rounds AHEAD of the tail); the θ staleness a
            # round actually saw is known only here, once its tail ran
            ti = t_tel + (rnd - start_round)
            if ti < len(self._telemetry):
                self._telemetry[ti]["realized_lag"] = cur_lag
            if cfg.collect_timing:
                if sync_k == 1:
                    with sec("sync"):
                        self.sync(metrics)
                    if rnd > start_round:
                        round_time += time.perf_counter() - t_round
                        timed_rounds += 1
                elif rnd == start_round:
                    with sec("sync"):
                        self.sync(metrics)
                    t_mark, r_mark = time.perf_counter(), rnd + 1
                elif (rnd == cfg.rounds - 1
                      or (rnd + 1 - start_round) % sync_k == 0):
                    # one sync closes the window; its time is averaged
                    # over the window's rounds
                    with sec("sync"):
                        self.sync(metrics)
                    round_time += time.perf_counter() - t_mark
                    timed_rounds += rnd + 1 - r_mark
                    t_mark, r_mark = time.perf_counter(), rnd + 1
            tracker.update(metrics)
            self._emit("on_round", rnd, state, metrics)
            if (rnd + 1) % cfg.eval_every == 0 or rnd == cfg.rounds - 1:
                with sec("eval"):
                    loss, mets = evaluate(self.task,
                                          self.whole_state(state,
                                                           model=False),
                                          self.fed)
                history.append({"round": rnd + 1, "test_loss": loss, **mets,
                                "train_loss": float(metrics["server_loss"]),
                                "elapsed_s": round(time.time() - t0, 1)})
                self.log(f"[{self.algo.name}] round {rnd+1:4d} "
                         f"test_loss={loss:.4f} "
                         f"{self.metric_key}="
                         f"{mets.get(self.metric_key, float('nan')):.4f}")
                if cfg.ckpt_dir:
                    self._save(rnd + 1, state)
                self._emit("on_eval", rnd, loss, mets)
        result = {"algo": self.algo.name, "task": cfg.task,
                  "history": history, "grad_stability": tracker.summary()}
        tel = self._telemetry[t_tel:]
        if tel:
            result["telemetry"] = {
                "per_round": tel,
                "live_cohort_mean": float(np.mean([r["live"] for r in tel])),
                "dropped_total": int(sum(r["dropped"] for r in tel)),
                "drop_hazard_total": int(sum(r["drop_hazard"] for r in tel)),
                "drop_deadline_total": int(sum(r["drop_deadline"]
                                               for r in tel)),
                "max_realized_lag": max(r["realized_lag"] for r in tel),
                "max_drawn_lag": max(r["lag_drawn_max"] for r in tel),
            }
        if self.recovery is not None:
            summary = self.recovery.summary()
            summary["ckpt_corruptions"] = self._ckpt_corruptions
            result["resilience"] = summary
        if start_round:
            result["resumed_from_round"] = start_round
        if cfg.collect_timing:
            result["round_time_s"] = round_time / max(1, timed_rounds)
        if cfg.pipeline_depth > 0:
            self.pipeline_stats = {
                "active": pipelined if cfg.rounds > start_round else False,
                "mode": cfg.pipeline_staleness,
                "depth": cfg.pipeline_depth,
                "ring_depth": ring_depth,
                "side_stream": self._side is not None,
                "staleness_weighting": cfg.staleness_weighting,
                "max_theta_s_lag_rounds": max_lag if pipelined else 0,
                "realized_lags": (list(ring.realized_lags)
                                  if ring is not None else []),
            }
            result["pipeline"] = self.pipeline_stats
        if prof is not None:
            result["profile"] = prof.summary()
        return result
