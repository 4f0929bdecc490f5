"""Declarative round programs: an SL algorithm as a composition of typed
phases over one ``TrainState``.

Port of the phases of ``repro/api/phases.py`` that the ``cyclesfl``
program runs:

    ExtractFeatures -> ServerUpdate(cycle) -> FeatureGradients(updated)
    -> ClientUpdate -> Commit(average)

The JAX package traces the phases into one jitted round; here they run
eagerly, in order, on the tensors' device.  A phase mode the port does
not have yet raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.cyclesl import (CycleConfig, PlanFn, client_updates,
                                      extract_features, feature_gradients,
                                      server_inner_loop)
from repro_torch.core.feature_store import pool_store
from repro_torch.core.protocol import (EntityState, broadcast_entity,
                                       entity_mean, init_entity,
                                       masked_entity_mean)
from repro_torch.core.split import SplitTask
from repro_torch.optim import Optimizer
from repro_torch.utils.tree import tree_map


class TrainState(NamedTuple):
    """The state every phase transforms.  ``clients`` is the stacked
    [N, ...] per-client store (PSL family); ``client_global`` the one
    shared θ_C (SFL family).  Exactly one of the two is populated."""
    server: EntityState
    clients: Optional[EntityState]
    client_global: Optional[EntityState]


@dataclass(frozen=True)
class SLAlgorithm:
    """What the drivers call: ``init(seed, n_clients)`` and
    ``round(state, cohort, xs, ys, key, mask=None)``."""
    name: str
    init: Callable[..., TrainState]
    round: Callable[..., tuple[TrainState, dict]]
    uses_global_client: bool


@dataclass(frozen=True)
class PhaseContext:
    """Inputs shared by every phase of a round.  ``plan_fn`` replaces the
    server's resample plan (a test seam; None = the port's own plan)."""
    task: SplitTask
    opt_server: Optimizer
    opt_client: Optimizer
    cycle: CycleConfig
    plan_fn: Optional[PlanFn] = None


@dataclass
class RoundVars:
    """Mutable scratch flowing phase to phase within one round.

    ``mask`` is the attendance mask over cohort SLOTS ([C] float, 1.0 =
    live client, 0.0 = padded slot), or ``None`` on the unpadded path.
    Padded slots carry zeroed ``xs``/``ys``; every phase leaves them out
    of pooled and averaged quantities.
    """
    state: TrainState
    cohort: Any                       # [C] int client ids
    xs: Any                           # [C, b, ...] inputs
    ys: Any                           # [C, b] labels
    key: Any                          # the round's integer key
    mask: Any = None
    cohort_clients: Optional[EntityState] = None
    server_prev: Any = None           # θ_S^t params, pre-ServerUpdate
    feats: Any = None                 # [C, b, ...] smashed data
    fgrads: Any = None                # [C, b, ...] feature gradients
    metrics: dict = field(default_factory=dict)


class Phase:
    """A typed round phase: ``(PhaseContext, RoundVars) -> None``."""

    def __call__(self, ctx: PhaseContext, v: RoundVars) -> None:
        raise NotImplementedError


def masked_mean(x, mask):
    """Mean over the live cohort slots (all slots when ``mask`` is None);
    the denominator is floored at 1, so an all-zero mask gives 0."""
    if mask is None:
        return torch.mean(x)
    return (torch.sum(torch.where(mask > 0, x, 0.0))
            / torch.clamp(torch.sum(mask), min=1.0))


def feat_grad_metrics(fgrads, mask=None) -> dict:
    """Mean and (population) std over slots of the per-slot feature
    gradient norm, scaled by 1/sqrt(features per slot)."""
    fg = fgrads.reshape(fgrads.shape[0], -1).float()
    norms = torch.linalg.vector_norm(fg, dim=-1) / fg.shape[-1] ** 0.5
    if mask is None:
        return {"feat_grad_norm_mean": norms.mean(),
                "feat_grad_norm_std": norms.std(correction=0)}
    mu = masked_mean(norms, mask)
    var = masked_mean(torch.square(torch.abs(norms - mu)), mask)
    return {"feat_grad_norm_mean": mu, "feat_grad_norm_std": torch.sqrt(var)}


# ----------------------------------------------------------------- phases
@dataclass(frozen=True)
class ExtractFeatures(Phase):
    """Phase 1: broadcast the shared client model over the cohort slots
    and extract the smashed data; snapshot θ_S^t."""

    def __call__(self, ctx, v):
        if v.state.clients is not None:
            raise NotImplementedError(
                "per-client programs (PSL family) are not ported yet")
        v.cohort_clients = broadcast_entity(v.state.client_global,
                                            v.ys.shape[0])
        v.server_prev = v.state.server.params
        v.feats = extract_features(ctx.task, v.cohort_clients.params, v.xs)


@dataclass(frozen=True)
class ServerUpdate(Phase):
    """Phase 2, ``cycle`` mode: pool the features into D_S^f and run the
    CycleSL inner loop (E epochs of resampled minibatches, Eq. 3)."""
    mode: str = "cycle"

    def __call__(self, ctx, v):
        if self.mode != "cycle":
            raise NotImplementedError(
                f"ServerUpdate mode {self.mode!r} is not ported yet")
        store = pool_store(v.feats, v.ys, mask=v.mask)
        server, sloss = server_inner_loop(
            ctx.task, v.state.server, ctx.opt_server, store, v.key,
            ctx.cycle, batch=v.ys.shape[1], plan_fn=ctx.plan_fn)
        v.metrics["server_loss"] = sloss
        v.state = v.state._replace(server=server)


@dataclass(frozen=True)
class FeatureGradients(Phase):
    """Phase 3: B_i^g = ∇_{B_i^f} L(θ_S(B_i^f)) with θ_S frozen.
    ``use_updated=True`` reads θ_S^{t+1} (Eq. 5); ``average`` overrides
    ``CycleConfig.avg_client_grads`` when not None."""
    use_updated: bool = True
    average: Optional[bool] = None

    def __call__(self, ctx, v):
        params = (v.state.server.params if self.use_updated
                  else v.server_prev)
        avg = (ctx.cycle.avg_client_grads if self.average is None
               else self.average)
        ccfg = replace(ctx.cycle, avg_client_grads=avg)
        v.fgrads = feature_gradients(ctx.task, params, v.feats, v.ys, ccfg,
                                     mask=v.mask)
        v.metrics.update(feat_grad_metrics(v.fgrads, mask=v.mask))


@dataclass(frozen=True)
class ClientUpdate(Phase):
    """Phase 4: pull the feature gradients through each slot's VJP."""
    record_gnorm: bool = False

    def __call__(self, ctx, v):
        v.cohort_clients, gnorms = client_updates(
            ctx.task, v.cohort_clients, ctx.opt_client, v.xs, v.fgrads,
            grad_clip=ctx.cycle.grad_clip, mask=v.mask)
        if self.record_gnorm:
            v.metrics["client_grad_norm_mean"] = masked_mean(gnorms, v.mask)


@dataclass(frozen=True)
class Commit(Phase):
    """Phase 5, ``average`` mode: FedAvg the live cohort slots into the
    shared θ_C."""
    mode: str = "average"

    def __call__(self, ctx, v):
        if self.mode != "average":
            raise NotImplementedError(
                f"Commit mode {self.mode!r} is not ported yet")
        cc = v.cohort_clients
        v.state = v.state._replace(
            client_global=(entity_mean(cc) if v.mask is None
                           else masked_entity_mean(cc, v.mask)))


# ---------------------------------------------------------------- program
@dataclass(frozen=True)
class RoundProgram:
    """A named, declarative composition of phases = one SL algorithm."""
    name: str
    phases: tuple[Phase, ...]
    uses_global_client: bool


def init_train_state(seed: int, n_clients: int, task: SplitTask,
                     opt_server: Optimizer, opt_client: Optimizer,
                     global_client: bool, device="cpu") -> TrainState:
    """Fresh state: the server and the client models drawn in turn from
    one CPU generator seeded with ``seed``, then moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    to_dev = lambda tree: tree_map(lambda t: t.to(device), tree)
    server = init_entity(to_dev(task.init_server(gen)), opt_server)
    client0 = init_entity(to_dev(task.init_client(gen)), opt_client)
    if global_client:
        return TrainState(server, None, client0)
    return TrainState(server, broadcast_entity(client0, n_clients), None)


def build_algorithm(program: RoundProgram, task: SplitTask,
                    opt_server: Optimizer, opt_client: Optimizer,
                    cycle: CycleConfig = CycleConfig(),
                    plan_fn: Optional[PlanFn] = None,
                    device="cpu") -> SLAlgorithm:
    """Bind a RoundProgram to a task and optimizers."""
    ctx = PhaseContext(task, opt_server, opt_client, cycle.check_ported(),
                       plan_fn)

    def init(seed: int, n_clients: int) -> TrainState:
        return init_train_state(seed, n_clients, task, opt_server,
                                opt_client, program.uses_global_client,
                                device)

    def round_fn(state, cohort, xs, ys, key, mask=None):
        v = RoundVars(state=state, cohort=cohort, xs=xs, ys=ys, key=key,
                      mask=mask)
        for phase in program.phases:
            phase(ctx, v)
        return v.state, v.metrics

    return SLAlgorithm(program.name, init, round_fn,
                       program.uses_global_client)
