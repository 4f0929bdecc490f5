"""The driver loop: sample cohorts, run rounds, evaluate.

Port of the single-device, sequential path of ``repro/api/engine.py``,
with its timing windows (``collect_timing``, ``sync_every``): no mesh,
pipeline, scenario, resilience or checkpoint branches (their config
fields must keep their defaults).

    eng = Engine(ExperimentConfig(algo="cyclesfl", rounds=100))
    result = eng.run()           # {"history": [...], "grad_stability": ...}

The Engine runs on the card unless the caller passes ``device="cpu"``;
with no card it raises.  Cohort draws come from numpy's
``default_rng(seed + 1)``, exactly as in the JAX package, so both
packages train on the same cohorts and batches.  Callbacks are objects
with ``on_round(engine, rnd, state, metrics)`` and/or
``on_eval(engine, rnd, loss, mets)``.
"""
from __future__ import annotations

import math
import time
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.config import ExperimentConfig
from repro_torch.api.phases import SLAlgorithm, TrainState, build_algorithm
from repro_torch.api.registry import get_program
from repro_torch.api.tasks import build_task
from repro_torch.core.cyclesl import PlanFn
from repro_torch.core.drift import GradStabilityTracker
from repro_torch.core.split import SplitTask
from repro_torch.data.federated import FederatedDataset, sample_cohort
from repro_torch.optim import adam
from repro_torch.utils.device import resolve_device  # noqa: F401
from repro_torch.utils.tree import tree_map


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
    :meth:`round_key` of the round.
    """

    def __init__(self, cfg: ExperimentConfig, *, device=None,
                 task: Optional[SplitTask] = None,
                 fed: Optional[FederatedDataset] = None,
                 metric_key: Optional[str] = None,
                 callbacks: Sequence = (),
                 plan_fn: Optional[PlanFn] = None,
                 log=print):
        self.device = resolve_device(device)
        cfg.validate()
        if (task is None) != (fed is None):
            raise ValueError("pass BOTH task and fed (they come from one "
                             "generator) or neither")
        if task is None:
            task, fed, mk = build_task(cfg.task, cfg.n_clients, cfg.alpha,
                                       cfg.seed, cfg.width, cfg.cut)
            metric_key = metric_key or mk
        self.cfg = cfg
        self.task = task
        self.fed = fed
        self.metric_key = metric_key or "accuracy"
        self.callbacks = tuple(callbacks)
        self.log = log
        program = get_program(cfg.algo)
        if (cfg.pad_cohorts and cfg.variable_attendance
                and any(getattr(p, "mode", None) == "cycle"
                        for p in program.phases)):
            # the masked inner loop runs a static number of steps; a
            # server batch above the smallest possible live pool would
            # leave a sparse round with no valid step, and the server
            # would silently not train that round
            sb = cfg.cycle.server_batch or cfg.batch
            if sb > cfg.batch * cfg.min_cohort:
                raise ValueError(
                    f"cycle.server_batch={sb} can exceed the smallest "
                    f"possible live feature pool (min_cohort={cfg.min_cohort}"
                    f" x batch={cfg.batch} = {cfg.min_cohort * cfg.batch} "
                    "rows) under variable attendance; lower "
                    "cycle.server_batch or raise min_cohort")
        self.algo: SLAlgorithm = build_algorithm(
            program, task, adam(cfg.lr_server),
            adam(cfg.lr_client), cfg.cycle, plan_fn=plan_fn,
            device=self.device)

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
        """The shape rounds are padded to: without a mesh, the capacity."""
        return self.cohort_capacity

    def sample_round(self, rng: np.random.Generator):
        """Cohort ids, per-client (x, y) batches and the attendance mask
        for one round, as tensors on the Engine's device.

        With ``cfg.pad_cohorts`` the cohort is padded to
        :attr:`padded_capacity`: padded slots carry the sentinel id N,
        zeroed batches and a 0 in the mask.  ``mask`` is None otherwise.
        """
        cfg = self.cfg
        cohort = sample_cohort(self.fed.n_clients, cfg.attendance, rng,
                               min_cohort=cfg.min_cohort,
                               variable=cfg.variable_attendance,
                               max_cohort=(self.cohort_capacity
                                           if cfg.pad_cohorts else None))
        pairs = [self.fed.clients[c].sample_batch(rng, cfg.batch)
                 for c in cohort]
        xs = np.stack([p[0] for p in pairs])
        ys = np.stack([p[1] for p in pairs])
        mask = None
        if cfg.pad_cohorts:
            live, cap = len(cohort), self.padded_capacity
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
        put = lambda a: None if a is None else torch.from_numpy(a).to(
            self.device)
        return put(cohort), put(xs), put(ys), put(mask)

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

    # -------------------------------------------------------------- run
    def run(self, state: Optional[TrainState] = None) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 1)
        if state is None:
            state = self.init_state()
        tracker = GradStabilityTracker()
        history = []
        t0 = time.time()
        # timing windows: the host syncs every sync_k rounds and at the
        # last; the first round (first launches, cuBLAS/cuDNN set-up) is
        # synced out of the first window and not timed
        sync_k = max(1, cfg.sync_every)
        round_time, timed_rounds = 0.0, 0
        for rnd in range(cfg.rounds):
            cohort, xs, ys, mask = self.sample_round(rng)
            t_round = time.perf_counter()
            state, metrics = self.algo.round(state, cohort, xs, ys,
                                             self.round_key(rnd), mask)
            if cfg.collect_timing:
                if sync_k == 1:
                    self.sync(metrics)
                    if rnd > 0:
                        round_time += time.perf_counter() - t_round
                        timed_rounds += 1
                elif rnd == 0:
                    self.sync(metrics)
                    t_mark, r_mark = time.perf_counter(), 1
                elif rnd == cfg.rounds - 1 or (rnd + 1) % sync_k == 0:
                    # one sync closes the window; its time is averaged
                    # over the window's rounds
                    self.sync(metrics)
                    round_time += time.perf_counter() - t_mark
                    timed_rounds += rnd + 1 - r_mark
                    t_mark, r_mark = time.perf_counter(), rnd + 1
            tracker.update(metrics)
            self._emit("on_round", rnd, state, metrics)
            if (rnd + 1) % cfg.eval_every == 0 or rnd == cfg.rounds - 1:
                loss, mets = evaluate(self.task, state, self.fed)
                history.append({"round": rnd + 1, "test_loss": loss, **mets,
                                "train_loss": float(metrics["server_loss"]),
                                "elapsed_s": round(time.time() - t0, 1)})
                self.log(f"[{self.algo.name}] round {rnd+1:4d} "
                         f"test_loss={loss:.4f} "
                         f"{self.metric_key}="
                         f"{mets.get(self.metric_key, float('nan')):.4f}")
                self._emit("on_eval", rnd, loss, mets)
        result = {"algo": self.algo.name, "task": cfg.task,
                  "history": history, "grad_stability": tracker.summary()}
        if cfg.collect_timing:
            result["round_time_s"] = round_time / max(1, timed_rounds)
        return result
