"""Declarative round programs: every SL algorithm as a composition of
typed phases over one ``TrainState``.

Port of ``repro/api/phases.py``.  An algorithm is a
:class:`RoundProgram`, an ordered tuple of phases drawn from

    ExtractFeatures -> ServerUpdate -> FeatureGradients -> ClientUpdate
    -> Commit

so ``cyclepsl``/``cyclesfl``/``cyclesglr`` are ``psl``/``sflv1``/``sglr``
with ``ServerUpdate`` swapped to the CycleSL inner loop and
``FeatureGradients`` pointed at the updated server (Eq. 5).  The
sequential algorithms (``ssl``, ``sflv2``, ``fedavg``) run as single
fused phases behind the same interface.

The JAX package traces the phases into one jitted round; here they run
eagerly, in order, on the tensors' device.  Its ``vmap`` over cohort
slots is a Python loop over slots whose results are stacked, so that a
stacked entity takes one optimizer step (one fused-Adam launch a leaf,
each slot corrected with its own step), and its ``scan`` along a chain
is a Python loop that carries the entities.  With
``ResilienceConfig.guard`` on, a trailing :class:`HealthGuard` phase
folds the health verdict into the round's metrics; with it off the round
runs the same ops as it always did.

:func:`build_pipelined_algorithm` splits a program at its
ExtractFeatures head into two calls, ``extract`` and ``tail``, whose
composition is the round: the Engine's pipelined schedule runs the
extract of cohort k + L before (async) or after (sync) the tail of
cohort k.  The pair takes the mesh as the round does, and the health
guard runs on a mesh with its verdict agreed over every rank.

On a mesh (``build_algorithm(..., mesh=)``) each rank runs the round on
its own cohort slots (a ``SlotSplit``: ``xs``/``ys`` hold those slots,
``cohort`` and ``mask`` the whole cohort), the PSL family's per-client
store is row-sharded (a ``StoreRows``), and every cross-slot value is
reduced over ranks through the mesh's collectives: FedAvg commits,
cohort-mean gradients, the data-parallel server inner loop, and the
per-slot metrics, which are gathered so every rank reports the same.
The programs that chain along the cohort (``ssl``, ``sflv2``,
``cyclessl``) shard nothing: every rank runs them whole.  At one rank
the mesh round runs the unsharded round's arithmetic, bit for bit.

The task carries the weights' placement (``core.split``): on the
``model`` axis its forwards run on this rank's blocks, and where the
round splits the cohort the server and the shared client model hold
their FSDP blocks over ``data`` (:func:`place_state`).  The server's
inner loop gathers them at use (``core.cyclesl``); a phase that copies
an entity to its slots (the shared client's broadcast, the server's
replicas) gathers it whole over ``data`` first, as a slot's copy is
whole there (the reference's role 'client'), and a mean over the slots
back into it hands each rank its block of the sum.

``build_algorithm(..., donate=True)`` donates the TrainState, the
port's counterpart of the reference's ``donate_argnums=(0,)``: the
round steps the server and the shared client model in place
(``core.protocol.entity_step(..., donate=True)``), and the copies it
makes of them (the server's replicas, the cohort's client models)
likewise, so a round holds each entity's state once; a masked step is
skipped in the kernel instead of selected against a kept copy.  An
entity that a later phase still reads in its pre-step state is stepped
as before: the server of a program whose feature gradients read θ_S^t
(``FeatureGradients(use_updated=False)``: psl, sflv1, sglr).  The
numbers are the undonated round's, bit for bit; the caller reads the
state it passed in no more.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.cyclesl import (CycleConfig, PlanFn, _slot,
                                      _value_and_grad, client_update_one,
                                      client_updates, extract_features,
                                      feature_gradients, server_inner_loop,
                                      server_whole, task_plan)
from repro_torch.core.feature_store import pool_store
from repro_torch.core.protocol import (DataBlocks, EntityState, SlotSplit,
                                       StoreRows, broadcast_entity,
                                       data_blocks, entity_mean, entity_step,
                                       gather_slots, init_entity,
                                       masked_entity_mean, put_entities,
                                       slot_mean, stack_entities,
                                       take_entities)
from repro_torch.core.split import SplitTask
from repro_torch.optim import Optimizer
from repro_torch.resilience.guards import health_vector
from repro_torch.sharding.specs import (Shard, batch_axes,
                                        cohort_shard_axes, gather_entity,
                                        local_slots, shard_entity,
                                        store_rows)
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like


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
    ``round(state, cohort, xs, ys, key, mask=None)``; with the health
    guard on, the round takes the loss-EMA carry as a trailing ``ema``
    argument."""
    name: str
    init: Callable[..., TrainState]
    round: Callable[..., tuple[TrainState, dict]]
    uses_global_client: bool
    # the mesh the round's phases split the cohort over (None: every
    # slot on this rank), and the per-client store rows this rank holds
    mesh: Any = None
    store_rows: Optional[StoreRows] = None
    # the task the round runs: its ``fsdp`` is set only where the round
    # holds FSDP blocks (it splits the cohort over a mesh whose ``data``
    # axis has more than one rank); the state is placed and gathered by it
    task: Optional[SplitTask] = None


@dataclass(frozen=True)
class PhaseContext:
    """Inputs shared by every phase of a round.  ``plan_fn`` replaces the
    server's resample plan (a test seam; None = the port's own plan)."""
    task: SplitTask
    opt_server: Optimizer
    opt_client: Optimizer
    cycle: CycleConfig
    plan_fn: Optional[PlanFn] = None
    # step in place: the round's own copies of an entity (the server's
    # replicas, the cohort's client models), and the TrainState's server
    # and shared client model (the server only where no phase reads
    # θ_S^t after its step)
    donate_copies: bool = False
    donate_server: bool = False
    donate_client: bool = False


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
    store: Any = None                 # pooled D_S^f of a pipelined extract
                                      # (None = pool inline)
    fgrads: Any = None                # [C, b, ...] feature gradients
    ema: Any = None                   # loss-EMA carry (HealthGuard only)
    stale_w: Any = None               # staleness weight w(lag), a scalar
                                      # tensor (None = unweighted); it
                                      # scales the server and feature
                                      # gradients
    split: Optional[SlotSplit] = None  # this rank's slots on a mesh,
    store_rows: Optional[StoreRows] = None  # and its per-client store rows
    shared_client: Optional[EntityState] = None  # the shared θ_C whole
                                      # over data, as ExtractFeatures
                                      # broadcast it (SFL family)
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


def feat_grad_metrics(fgrads, mask=None, split=None) -> dict:
    """Mean and (population) std over slots of the per-slot feature
    gradient norm, scaled by 1/sqrt(features per slot); with ``split``
    over every rank's slots (the norms are gathered)."""
    fg = fgrads.reshape(fgrads.shape[0], -1).float()
    norms = gather_slots(torch.linalg.vector_norm(fg, dim=-1)
                         / fg.shape[-1] ** 0.5, split)
    if mask is None:
        return {"feat_grad_norm_mean": norms.mean(),
                "feat_grad_norm_std": norms.std(correction=0)}
    mu = masked_mean(norms, mask)
    var = masked_mean(torch.square(torch.abs(norms - mu)), mask)
    return {"feat_grad_norm_mean": mu, "feat_grad_norm_std": torch.sqrt(var)}


def whole_entity(task, entity: EntityState, half: str) -> EntityState:
    """``entity`` (the server, or the shared client model: ``half``
    'server' or 'client') whole over ``data``: its FSDP blocks of the
    params and the Adam moments all-gathered, where the round holds
    blocks (``task.fsdp``); else ``entity`` itself."""
    if task.fsdp is None:
        return entity
    return gather_entity(entity, task_plan(task, half), data_comm=task.fsdp)


def mean_into(task, half: str, entity: Optional[EntityState] = None
              ) -> Optional[DataBlocks]:
    """Where a mean over the slots into ``half`` lands: its FSDP blocks
    (an EntityState mean when ``entity`` gives its structure, else a
    params-like tree's), or None off FSDP."""
    return data_blocks(task.fsdp, task_plan(task, half), entity)


def _joint_value_and_grad(task, cp, sp, x, y):
    """(loss, d/d θ_C, d/d θ_S) of the end-to-end loss, both halves in
    one backward; a leaf the loss does not use gets zeros, as under
    jax.grad."""
    loss, (gc, gs) = _value_and_grad(
        lambda p: task.e2e_loss(p[0], p[1], x, y), (cp, sp))
    return loss, gc, gs


def _feature_grad(task, cp, sp, x, y):
    """∇_f of the server loss at the features of ``x``, the server held
    fixed: the ``feat_grad_norm`` metric of the sequential rounds."""
    with torch.no_grad():
        f = task.client_forward(cp, x)
    _, g = _value_and_grad(lambda ff: task.server_loss(sp, ff, y), f)
    return g


# ----------------------------------------------------------------- phases
@dataclass(frozen=True)
class ExtractFeatures(Phase):
    """Phase 1: select the cohort's client models (the per-client store's
    rows, or the shared model broadcast over the slots) and extract the
    smashed data; snapshot θ_S^t for the classic programs."""

    def __call__(self, ctx, v):
        state = v.state
        if state.clients is None:
            v.shared_client = whole_entity(ctx.task, state.client_global,
                                           "client")
            v.cohort_clients = broadcast_entity(v.shared_client,
                                                v.ys.shape[0],
                                                fresh=ctx.donate_copies)
        else:
            v.cohort_clients = take_entities(state.clients, v.cohort,
                                             v.store_rows, v.split)
        v.server_prev = state.server.params
        v.feats = extract_features(ctx.task, v.cohort_clients.params, v.xs)


def _pair_server_losses_and_grads(ctx, v, sp):
    """Per-pair server loss and gradient at θ_S^t (``sp``, whole over
    ``data``) over the cohort's features: [C] losses and a [C, ...]-
    stacked gradient tree."""
    pairs = [_value_and_grad(
        lambda p, c=c: ctx.task.server_loss(p, v.feats[c], _slot(v.ys, c)),
        sp) for c in range(v.feats.shape[0])]
    return (torch.stack([l for l, _ in pairs]),
            stack_entities([g for _, g in pairs]))


@dataclass(frozen=True)
class ServerUpdate(Phase):
    """Phase 2, the axis the zoo varies along:

    ``cycle``        pool the features into D_S^f and run the CycleSL
                     inner loop (E epochs of resampled minibatches, Eq. 3).
    ``replica_avg``  PSL/SFL-V1: one server replica a pair steps on its
                     pair's gradient, then the replicas are averaged.
    ``mean_grad``    SGLR: one server stepped with the cohort-mean
                     gradient.
    """
    mode: str = "cycle"

    def __call__(self, ctx, v):
        if self.mode == "cycle":
            # a pipelined extract hands the finished pool over in v.store;
            # both paths build it with the same pool_store
            store = (v.store if v.store is not None
                     else pool_store(v.feats, v.ys, mask=v.mask))
            server, sloss = server_inner_loop(
                ctx.task, v.state.server, ctx.opt_server, store, v.key,
                ctx.cycle, batch=v.ys.shape[1], plan_fn=ctx.plan_fn,
                grad_scale=v.stale_w, split=v.split,
                donate=ctx.donate_server)
            v.metrics["server_loss"] = sloss
        elif self.mode == "replica_avg":
            whole = whole_entity(ctx.task, v.state.server, "server")
            losses, gs = _pair_server_losses_and_grads(ctx, v, whole.params)
            if v.stale_w is not None:
                gs = tree_map(lambda g: g * v.stale_w, gs)
            # C replicas with a [C] step take one stacked step
            rep = entity_step(broadcast_entity(whole, v.ys.shape[0],
                                               fresh=ctx.donate_copies),
                              gs, ctx.opt_server, donate=ctx.donate_copies)
            into = mean_into(ctx.task, "server", whole)
            server = (entity_mean(rep, v.split, into) if v.mask is None
                      else masked_entity_mean(rep, v.mask, v.split, into))
            v.metrics["server_loss"] = masked_mean(
                gather_slots(losses, v.split), v.mask)
        elif self.mode == "mean_grad":
            losses, gs = _pair_server_losses_and_grads(
                ctx, v, server_whole(ctx.task, v.state.server.params))
            gmean = slot_mean(gs, v.mask, v.split,
                              mean_into(ctx.task, "server"))
            if v.stale_w is not None:
                gmean = tree_map(lambda g: g * v.stale_w, gmean)
            server = entity_step(v.state.server, gmean, ctx.opt_server,
                                 donate=ctx.donate_server)
            v.metrics["server_loss"] = masked_mean(
                gather_slots(losses, v.split), v.mask)
        else:
            raise ValueError(f"unknown ServerUpdate mode {self.mode!r}")
        v.state = v.state._replace(server=server)


@dataclass(frozen=True)
class FeatureGradients(Phase):
    """Phase 3: B_i^g = ∇_{B_i^f} L(θ_S(B_i^f)) with θ_S frozen.

    ``use_updated=True`` reads θ_S^{t+1} (the cyclical part, Eq. 5);
    ``False`` reads the θ_S^t snapshot (classic SL back-prop order).
    ``average`` overrides ``CycleConfig.avg_client_grads`` when not None.
    """
    use_updated: bool = True
    average: Optional[bool] = None

    def __call__(self, ctx, v):
        params = (v.state.server.params if self.use_updated
                  else v.server_prev)
        avg = (ctx.cycle.avg_client_grads if self.average is None
               else self.average)
        ccfg = replace(ctx.cycle, avg_client_grads=avg)
        v.fgrads = feature_gradients(ctx.task, params, v.feats, v.ys, ccfg,
                                     mask=v.mask, split=v.split)
        if v.stale_w is not None:
            v.fgrads = v.fgrads * v.stale_w.to(v.fgrads.dtype)
        v.metrics.update(feat_grad_metrics(v.fgrads, mask=v.mask,
                                           split=v.split))


@dataclass(frozen=True)
class ClientUpdate(Phase):
    """Phase 4: pull the feature gradients through each client's VJP.

    ``chained=True`` runs the sequential-SL variant (``cyclessl``): ONE
    client model carried along the cohort, each slot's update seeing the
    previous one; a padded slot passes the carry through.  Both paths
    share ``client_update_one``'s arithmetic and ``CycleConfig.grad_clip``.
    """
    record_gnorm: bool = False
    chained: bool = False

    def __call__(self, ctx, v):
        clip = ctx.cycle.grad_clip
        if self.chained:
            entity, gnorms = v.state.client_global, []
            for c in range(v.fgrads.shape[0]):
                keep = None if v.mask is None else v.mask[c]
                entity, gn = client_update_one(
                    ctx.task, entity, _slot(v.xs, c), v.fgrads[c],
                    ctx.opt_client, clip, donate=ctx.donate_client,
                    keep=keep)
                if keep is not None:
                    gn = torch.where(keep > 0, gn, 0.0)
                gnorms.append(gn)
            v.cohort_clients, gnorms = entity, torch.stack(gnorms)
        else:
            mask = (v.mask if v.mask is None or v.split is None
                    else v.split.local(v.mask))
            v.cohort_clients, gnorms = client_updates(
                ctx.task, v.cohort_clients, ctx.opt_client, v.xs, v.fgrads,
                grad_clip=clip, mask=mask, donate=ctx.donate_copies)
            gnorms = gather_slots(gnorms, v.split)
        if self.record_gnorm:
            v.metrics["client_grad_norm_mean"] = masked_mean(gnorms, v.mask)


@dataclass(frozen=True)
class Commit(Phase):
    """Phase 5: write the updated cohort back into the train state.

    ``per_client``  scatter into the persistent [N, ...] client store
                    (PSL family: clients are never aggregated); writes at
                    the padded slots' sentinel id N are dropped.
    ``average``     FedAvg the live slots into the shared θ_C (SFL family).
    ``global``      replace the shared θ_C wholesale (sequential chain).
    """
    mode: str = "per_client"

    def __call__(self, ctx, v):
        state, cc = v.state, v.cohort_clients
        if self.mode == "per_client":
            v.state = state._replace(
                clients=put_entities(state.clients, v.cohort, cc,
                                     v.store_rows, v.split))
        elif self.mode == "average":
            into = mean_into(ctx.task, "client", cc)
            v.state = state._replace(
                client_global=(entity_mean(cc, v.split, into)
                               if v.mask is None else
                               masked_entity_mean(cc, v.mask, v.split,
                                                  into)))
        elif self.mode == "global":
            v.state = state._replace(client_global=cc)
        else:
            raise ValueError(f"unknown Commit mode {self.mode!r}")


@dataclass(frozen=True)
class HealthGuard(Phase):
    """Trailing phase: fold the health verdict into the round's metrics.

    Appended by :func:`build_algorithm` only when
    ``ResilienceConfig.guard`` is on, so the guard-free round runs
    exactly the ops it always did.  It reads what the round already
    holds — the committed state, the round loss, the cohort's features
    and feature gradients, the loss-EMA carry (``v.ema``, a device
    scalar the Engine threads round to round) — and reads nothing back
    to the host; the Engine pays one host read of ``metrics['health']``.
    See :mod:`repro_torch.resilience.guards` for the vector layout.

    On a mesh each rank checks its slots and its shards, and the verdict
    is agreed over ``axes`` (the mesh axes the round's slots do not
    split, :func:`guard_axes`) and the slots' split: the vector is the
    same on every rank and the blame whole [C].
    """
    alpha: float = 0.1
    spike_factor: float = 4.0
    axes: tuple = ()

    def __call__(self, ctx, v):
        loss = v.metrics.get("server_loss")
        if loss is None:
            loss = torch.zeros((), device=v.state.server.step.device)
        health, slot_bad = health_vector(
            v.state, loss, v.feats, v.fgrads, v.mask, v.ema,
            self.alpha, self.spike_factor, v.split, self.axes)
        v.metrics["health"] = health
        v.metrics["health_slot_bad"] = slot_bad


# ----------------------------------------------- fused sequential rounds
# ssl / sflv2 / fedavg interleave client and server updates along the
# cohort, so they run as single fused phases.  None of them clips, as in
# the JAX package.
@dataclass(frozen=True)
class SequentialChainRound(Phase):
    """ssl: one shared client model passed client to client, one
    end-to-end step of client and server a slot."""

    def __call__(self, ctx, v):
        task, opt_s, opt_c = ctx.task, ctx.opt_server, ctx.opt_client
        server, client = v.state.server, v.state.client_global
        losses, fgs = [], []
        for c in range(v.ys.shape[0]):
            x, y = _slot(v.xs, c), _slot(v.ys, c)
            loss, gc, gs = _joint_value_and_grad(task, client.params,
                                                 server.params, x, y)
            fgs.append(_feature_grad(task, client.params, server.params,
                                     x, y))
            keep = None if v.mask is None else v.mask[c]
            server = entity_step(server, gs, opt_s,
                                 donate=ctx.donate_server, keep=keep)
            client = entity_step(client, gc, opt_c,
                                 donate=ctx.donate_client, keep=keep)
            if keep is not None:
                loss = torch.where(keep > 0, loss, 0.0)
            losses.append(loss)
        v.metrics.update(server_loss=masked_mean(torch.stack(losses), v.mask),
                         **feat_grad_metrics(torch.stack(fgs), mask=v.mask))
        v.state = v.state._replace(server=server, client_global=client)


@dataclass(frozen=True)
class ServerSequentialRound(Phase):
    """sflv2: one server model stepped slot after slot on the server
    side; the client copies step once each and are FedAvg'd."""

    def __call__(self, ctx, v):
        task, opt_s, opt_c = ctx.task, ctx.opt_server, ctx.opt_client
        cp = v.state.client_global.params     # every slot's θ_C
        server, losses, gcs, fgs = v.state.server, [], [], []
        for c in range(v.ys.shape[0]):
            x, y = _slot(v.xs, c), _slot(v.ys, c)
            loss, gc, gs = _joint_value_and_grad(task, cp, server.params,
                                                 x, y)
            fgs.append(_feature_grad(task, cp, server.params, x, y))
            keep = None if v.mask is None else v.mask[c]
            server = entity_step(server, gs, opt_s,
                                 donate=ctx.donate_server, keep=keep)
            if keep is not None:
                loss = torch.where(keep > 0, loss, 0.0)
            losses.append(loss)
            gcs.append(gc)
        stepped = entity_step(
            broadcast_entity(v.state.client_global, v.ys.shape[0],
                             fresh=ctx.donate_copies),
            stack_entities(gcs), opt_c, donate=ctx.donate_copies)
        client_global = (entity_mean(stepped) if v.mask is None
                         else masked_entity_mean(stepped, v.mask))
        v.metrics.update(server_loss=masked_mean(torch.stack(losses), v.mask),
                         **feat_grad_metrics(torch.stack(fgs), mask=v.mask))
        v.state = v.state._replace(server=server, client_global=client_global)


@dataclass(frozen=True)
class LocalFedAvgRound(Phase):
    """fedavg: each slot trains the FULL composed model locally; both
    halves are averaged (no split traffic: the non-SL yardstick)."""

    def __call__(self, ctx, v):
        task, n = ctx.task, v.ys.shape[0]
        srv = whole_entity(task, v.state.server, "server")
        cli = whole_entity(task, v.state.client_global, "client")
        cp, sp = cli.params, srv.params
        outs = [_joint_value_and_grad(task, cp, sp, _slot(v.xs, c),
                                      _slot(v.ys, c)) for c in range(n)]
        own = ctx.donate_copies
        servers = entity_step(broadcast_entity(srv, n, fresh=own),
                              stack_entities([gs for _, _, gs in outs]),
                              ctx.opt_server, donate=own)
        clients = entity_step(broadcast_entity(cli, n, fresh=own),
                              stack_entities([gc for _, gc, _ in outs]),
                              ctx.opt_client, donate=own)
        s_into = mean_into(task, "server", srv)
        c_into = mean_into(task, "client", cli)
        if v.mask is None:
            server = entity_mean(servers, v.split, s_into)
            client = entity_mean(clients, v.split, c_into)
        else:
            server = masked_entity_mean(servers, v.mask, v.split, s_into)
            client = masked_entity_mean(clients, v.mask, v.split, c_into)
        zero = torch.zeros((), device=v.ys.device)
        losses = gather_slots(torch.stack([l for l, _, _ in outs]), v.split)
        v.metrics.update(
            server_loss=masked_mean(losses, v.mask),
            feat_grad_norm_mean=zero, feat_grad_norm_std=zero)
        v.state = v.state._replace(server=server, client_global=client)


# ---------------------------------------------------------------- program
@dataclass(frozen=True)
class RoundProgram:
    """A named, declarative composition of phases = one SL algorithm."""
    name: str
    phases: tuple[Phase, ...]
    uses_global_client: bool

    def describe(self) -> str:
        return " -> ".join(type(p).__name__ for p in self.phases)


def init_train_state(seed: int, n_clients: int, task: SplitTask,
                     opt_server: Optimizer, opt_client: Optimizer,
                     global_client: bool, device="cpu",
                     rows: Optional[StoreRows] = None) -> TrainState:
    """Fresh state: the server and the client models drawn in turn from
    one CPU generator seeded with ``seed``, then moved to ``device``.
    ``rows`` keeps only those rows of the per-client store (every client
    starts from the same draw, so a rank's rows are that draw
    repeated)."""
    gen = torch.Generator().manual_seed(seed)
    to_dev = lambda tree: tree_map(lambda t: t.to(device), tree)
    server = init_entity(to_dev(task.init_server(gen)), opt_server)
    client0 = init_entity(to_dev(task.init_client(gen)), opt_client)
    if global_client:
        return TrainState(server, None, client0)
    n = n_clients if rows is None else rows.hi - rows.lo
    return TrainState(server, broadcast_entity(client0, n), None)


def shards_cohort(program: RoundProgram) -> bool:
    """False for the programs that chain along the cohort (ssl, sflv2 and
    cyclessl carry one model from slot to slot): on a mesh every rank
    runs those whole."""
    return not any(isinstance(p, (SequentialChainRound,
                                  ServerSequentialRound))
                   or (isinstance(p, ClientUpdate) and p.chained)
                   for p in program.phases)


def slot_split(mesh, n_slots: int) -> Optional[SlotSplit]:
    """This rank's slots of a cohort of ``n_slots`` on ``mesh`` (None off
    the mesh).  The cohort must split evenly over every batch axis, as
    the Engine's shard-aligned capacity makes it; a cohort that does not
    raises rather than run replicated."""
    if mesh is None:
        return None
    axes = batch_axes(mesh)
    if cohort_shard_axes(mesh, n_slots) != axes:
        raise ValueError(
            f"a cohort of {n_slots} slots does not split over the mesh's "
            f"batch axes {dict((a, mesh.shape[a]) for a in axes)}: pad "
            "cohorts (pad_cohorts=True aligns the capacity) or draw a "
            "cohort that divides them")
    lo, hi = local_slots(mesh, n_slots)
    return SlotSplit(mesh, lo, hi, n_slots)


def _cut_data(entity: Optional[EntityState], plan) -> Optional[EntityState]:
    """An entity whole over ``data`` cut to this rank's FSDP blocks; one
    already cut (every leaf ``plan`` splits over ``data`` is the size of
    its block) passes through."""
    if entity is None:
        return entity
    if all(x.shape[s.ddim] == s.dhi - s.dlo
           for x, s in zip(tree_leaves(entity.params), tree_leaves(plan))
           if s.ddim is not None):
        return entity
    return shard_entity(entity, plan, model=False)


def place_state(state: TrainState, rows: Optional[StoreRows],
                task: Optional[SplitTask] = None, model: bool = False
                ) -> TrainState:
    """A whole TrainState cut to this rank's rows of the per-client store
    and, where ``task`` (the round's, ``SLAlgorithm.task``) holds FSDP
    blocks, to this rank's blocks of the server and the shared client
    model (a state already cut passes through).  The ``model`` blocks
    are the task's own: its ``init_*`` keep them, and a state whole over
    ``model`` too (a restored checkpoint) is cut to them with
    ``model``, by the task's plans."""
    if model and task is not None and task.tp is not None \
            and task.tp.size > 1:
        sp, cp = task_plan(task, "server"), task_plan(task, "client")
        state = TrainState(
            shard_entity(state.server, sp, data=False),
            None if state.clients is None else shard_entity(
                state.clients, tree_map(Shard.stacked, cp), data=False),
            None if state.client_global is None else shard_entity(
                state.client_global, cp, data=False))
    if task is not None and task.fsdp is not None:
        state = state._replace(
            server=_cut_data(state.server, task_plan(task, "server")),
            client_global=_cut_data(state.client_global,
                                    task_plan(task, "client")))
    if rows is None or state.clients is None or not rows.sharded:
        return state
    if state.clients.step.shape[0] == rows.hi - rows.lo:
        return state
    if state.clients.step.shape[0] != rows.n:
        raise ValueError(f"a store of {state.clients.step.shape[0]} rows is "
                         f"neither the whole {rows.n} nor this rank's "
                         f"{rows.hi - rows.lo}")
    return state._replace(clients=tree_map(
        lambda x: x[rows.lo:rows.hi].contiguous(), state.clients))


def whole_state(state: TrainState, rows: Optional[StoreRows], comm,
                task: Optional[SplitTask] = None, model: bool = True
                ) -> TrainState:
    """The whole TrainState on every rank: the per-client store's rows
    ``all_gather``ed (one call per dtype) and, with ``task`` (the
    round's, as :func:`place_state` took it), its FSDP blocks of the
    server and the shared client model gathered over ``data`` and with
    ``model`` the task's ``model`` blocks of every entity, over its
    ``model`` axis.  The rest is the same on every rank already."""
    if rows is not None and state.clients is not None and rows.sharded:
        leaves = comm.all_gather_tree(tree_leaves(state.clients), "state")
        state = state._replace(
            clients=tree_unflatten_like(state.clients, leaves))
    if task is None or not task.plans:
        return state
    sp, cp = task_plan(task, "server"), task_plan(task, "client")
    if task.fsdp is not None:
        state = state._replace(
            server=gather_entity(state.server, sp, data_comm=task.fsdp),
            client_global=(None if state.client_global is None else
                           gather_entity(state.client_global, cp,
                                         data_comm=task.fsdp)))
    if model and task.tp is not None and task.tp.size > 1:
        mc = task.tp.comm
        state = TrainState(
            gather_entity(state.server, sp, mc),
            None if state.clients is None else gather_entity(
                state.clients, tree_map(Shard.stacked, cp), mc),
            None if state.client_global is None else gather_entity(
                state.client_global, cp, mc))
    return state


def round_placement(program: RoundProgram, task: SplitTask, mesh: Any,
                    shard_data: bool, n_clients: Optional[int]
                    ) -> tuple[Any, SplitTask, Optional[StoreRows]]:
    """``(ctx_mesh, task, rows)`` of a program on ``mesh``, decided once
    for the whole round and its pipelined pair alike: the mesh the
    phases split the cohort over (None for the programs that chain
    along the cohort and with ``shard_data`` off: every rank runs them
    whole), the task without ``fsdp`` where the cohort does not split
    (weights whole over ``data``), and this rank's rows of the
    per-client store of ``n_clients`` rows (None for the SFL family and
    off the split)."""
    ctx_mesh = mesh if shard_data and shards_cohort(program) else None
    if ctx_mesh is None and task.fsdp is not None:
        task = replace(task, fsdp=None)
    rows = None
    if ctx_mesh is not None and not program.uses_global_client:
        if n_clients is None:
            raise ValueError("a per-client program on a mesh needs "
                             "n_clients, the store's rows")
        rows = StoreRows(*store_rows(ctx_mesh, n_clients), n_clients)
    return ctx_mesh, task, rows


def guard_axes(mesh: Any, ctx_mesh: Any, task: SplitTask) -> tuple:
    """The collectives the health guard sums its non-finite flag over
    beyond the slots' split: the ``model`` axis where the task's weights
    split over it, and the batch axes where every rank runs the whole
    cohort (``ctx_mesh`` None).  Empty off the mesh and at one rank."""
    if mesh is None:
        return ()
    axes = []
    if ctx_mesh is None and mesh.comm.size > 1:
        axes.append(mesh.comm)
    if task.tp is not None and task.tp.size > 1:
        axes.append(task.tp.comm)
    return tuple(axes)


def _guard(resilience: Any, mesh: Any, ctx_mesh: Any, task: SplitTask
           ) -> Optional[HealthGuard]:
    if resilience is None or not resilience.guard:
        return None
    return HealthGuard(resilience.ema_alpha, resilience.spike_factor,
                       guard_axes(mesh, ctx_mesh, task))


def build_algorithm(program: RoundProgram, task: SplitTask,
                    opt_server: Optimizer, opt_client: Optimizer,
                    cycle: CycleConfig = CycleConfig(),
                    plan_fn: Optional[PlanFn] = None,
                    device="cpu", resilience: Any = None, mesh: Any = None,
                    shard_data: bool = True,
                    n_clients: Optional[int] = None,
                    donate: bool = False) -> SLAlgorithm:
    """Bind a RoundProgram to a task and optimizers.

    ``resilience`` (a ``ResilienceConfig`` with ``guard=True``) appends
    the :class:`HealthGuard` phase; the round's trailing ``ema`` is then
    the loss-EMA carry.  ``None`` or guard off: the guard-free round.

    ``mesh`` (a ``launch.mesh.Mesh``) runs the round on this rank's slots
    (see the module's docstring); ``round`` then takes this rank's slots
    of ``xs``/``ys`` and the whole ``cohort`` and ``mask``.  The per-client
    store of ``n_clients`` rows (required for the PSL family) is
    row-sharded unless ``shard_data`` is off, which also keeps the
    phases whole on every rank, as for the programs that chain along
    the cohort; such a round holds its weights whole over ``data`` (the
    algorithm's ``task`` has no ``fsdp``).  On a mesh the guard's
    verdict is agreed over every rank (:class:`HealthGuard`).

    ``donate`` donates the TrainState to every round (see the module's
    docstring; on a mesh each rank its blocks and slots): the caller
    must not read a state it passed to ``round`` again.
    """
    ctx_mesh, task, rows = round_placement(program, task, mesh, shard_data,
                                           n_clients)
    ctx = _context(program, task, opt_server, opt_client, cycle, plan_fn,
                   copies=donate, state=donate)
    guard = _guard(resilience, mesh, ctx_mesh, task)
    init = _init_fn(program, task, opt_server, opt_client, device, rows)

    def round_fn(state, cohort, xs, ys, key, mask=None, ema=None):
        v = RoundVars(state=state, cohort=cohort, xs=xs, ys=ys, key=key,
                      mask=mask, ema=ema,
                      split=slot_split(ctx_mesh, cohort.shape[0]),
                      store_rows=rows)
        for phase in program.phases:
            phase(ctx, v)
        if guard is not None:
            guard(ctx, v)
        return v.state, v.metrics

    return SLAlgorithm(program.name, init, round_fn,
                       program.uses_global_client, ctx_mesh, rows, task)


def _reads_server_before_step(program: RoundProgram) -> bool:
    """Whether a phase reads θ_S^t after the server's step: the classic
    programs' feature gradients at the pre-update server."""
    return any(isinstance(p, FeatureGradients) and not p.use_updated
               for p in program.phases)


def _context(program, task, opt_server, opt_client, cycle, plan_fn, *,
             copies: bool, state: bool) -> PhaseContext:
    """The round's PhaseContext, with what its steps may write in place:
    the round's own copies (``copies``) and the TrainState's entities
    (``state``; the server not where a phase reads θ_S^t after its
    step).  A donated step takes the fused Adam step: an optimizer
    without one (a schedule) is refused here."""
    if (copies or state) and (opt_server.apply_ is None
                              or opt_client.apply_ is None):
        raise ValueError("donation needs the fused Adam step (a constant "
                         "lr) on both sides: pass donate=False with a "
                         "schedule")
    return PhaseContext(
        task, opt_server, opt_client, cycle.check_ported(), plan_fn,
        donate_copies=copies,
        donate_server=state and not _reads_server_before_step(program),
        donate_client=state)


def _init_fn(program, task, opt_server, opt_client, device, rows):
    """``init(seed, n_clients)`` of a program: the fresh state, this
    rank's rows of the per-client store when ``rows`` is given."""
    def init(seed: int, n_clients: int) -> TrainState:
        if rows is not None and n_clients != rows.n:
            raise ValueError(f"built for {rows.n} clients, asked for "
                             f"{n_clients}")
        return init_train_state(seed, n_clients, task, opt_server,
                                opt_client, program.uses_global_client,
                                device, rows)
    return init


# ------------------------------------------------------ pipelined rounds
class PipelineStage(NamedTuple):
    """Everything the extract call hands to the in-flight tail.

    One stage per in-flight cohort: the selected client entities, the
    θ_S^t snapshot (read by non-cycle ``FeatureGradients``), the smashed
    data, and for cycle programs the already pooled D_S^f, so the tail's
    server phase starts on the handoff without pooling again.

    ``clients`` is the [C, ...] gathered stack for per-client programs,
    but the single shared θ_C entity (whole over ``data`` where the
    state holds FSDP blocks) for global-client programs: the tail
    broadcasts it, as the sequential round's ExtractFeatures does.
    ``feats`` is None for cycle programs: the pooled store holds the same
    values and the tail rebuilds the [C, b, ...] view by a reshape.
    """
    clients: Any                      # [C, ...] stack, or shared θ_C entity
    server_prev: Any                  # θ_S^t params snapshot
    feats: Any                        # [C, b, ...] smashed data, or None
    store: Any                        # pooled FeatureStore (cycle) or None


@dataclass(frozen=True)
class PipelinedAlgorithm:
    """A RoundProgram as two calls.

    ``extract(state, cohort, xs, ys[, mask]) -> PipelineStage`` runs the
    ExtractFeatures head; ``tail(state, cohort, xs, ys, key, stage[,
    mask][, ema][, lag=]) -> (state, metrics)`` runs the ServerUpdate ..
    Commit remainder (and the HealthGuard when it is on).  Their
    composition is the round; calling ``extract`` for cohort k + 1
    before ``tail`` of cohort k is the software pipeline.
    """
    name: str
    init: Callable[..., TrainState]
    extract: Callable[..., PipelineStage]
    tail: Callable[..., tuple[TrainState, dict]]
    uses_global_client: bool


def split_program(program: RoundProgram
                  ) -> Optional[tuple[Phase, tuple[Phase, ...]]]:
    """(head, tail) when the program starts with ExtractFeatures; None
    for the fused sequential programs (ssl, sflv2 and fedavg interleave
    client and server updates inside one phase: there is nothing to
    overlap, and the Engine runs their whole rounds)."""
    if program.phases and isinstance(program.phases[0], ExtractFeatures):
        return program.phases[0], program.phases[1:]
    return None


def build_pipelined_algorithm(program: RoundProgram, task: SplitTask,
                              opt_server: Optimizer, opt_client: Optimizer,
                              cycle: CycleConfig = CycleConfig(),
                              plan_fn: Optional[PlanFn] = None,
                              device="cpu", resilience: Any = None,
                              staleness_weighting: str = "none",
                              staleness_lambda: float = 0.5,
                              mesh: Any = None, shard_data: bool = True,
                              n_clients: Optional[int] = None,
                              donate: bool = False, donate_state: bool = True
                              ) -> Optional[PipelinedAlgorithm]:
    """Split a RoundProgram into the (extract, tail) pair.

    The phases are the same objects the whole round runs; the split only
    moves the call boundary to the ExtractFeatures/ServerUpdate seam
    (plus the pooling of D_S^f, which rides the extract side), so
    ``tail(state, ..., extract(state, ...))`` is the round, bit for bit.
    Returns None when the program has no ExtractFeatures head.

    ``staleness_weighting`` != 'none' scales the cohort's server and
    feature gradients by w(lag): ``1 / (1 + lag)`` ('inverse') or
    ``exp(-staleness_lambda * lag)`` ('exp'), computed in float32 on the
    device from the tail's ``lag``; w(0) is exactly 1.

    ``mesh``, ``shard_data`` and ``n_clients`` place the pair as
    :func:`build_algorithm` places the round (:func:`round_placement`,
    decided once): both calls take this rank's slots of ``xs``/``ys``
    and the whole ``cohort`` and ``mask``.  The stage then holds this
    rank's part: the cohort's client rows of its slots, or the shared
    θ_C whole over ``data`` (gathered once, in the extract), and the
    pool of its slots' rows with the whole [T] validity, which the
    tail's server phase reads through the shard-local route or the
    gathered pool, as the whole round does.

    ``donate`` donates the stage into the tail (its copies of the
    cohort's client models are stepped in place; the caller drops the
    stage with the round) and, with ``donate_state``, the TrainState too,
    as :func:`build_algorithm` donates it.  The Engine donates the state
    only in sync mode: an async extract still reads the pre-tail state.
    """
    split = split_program(program)
    if split is None:
        return None
    head, tail_phases = split
    ctx_mesh, task, rows = round_placement(program, task, mesh, shard_data,
                                           n_clients)
    ctx = _context(program, task, opt_server, opt_client, cycle, plan_fn,
                   copies=donate, state=donate and donate_state)
    pools = any(getattr(p, "mode", None) == "cycle" for p in tail_phases)
    guard = _guard(resilience, mesh, ctx_mesh, task)

    def extract(state, cohort, xs, ys, mask=None) -> PipelineStage:
        v = RoundVars(state=state, cohort=cohort, xs=xs, ys=ys, key=None,
                      mask=mask, split=slot_split(ctx_mesh, cohort.shape[0]),
                      store_rows=rows)
        head(ctx, v)
        store = pool_store(v.feats, ys, mask=mask) if pools else None
        clients = (v.shared_client if program.uses_global_client
                   else v.cohort_clients)
        return PipelineStage(clients, v.server_prev,
                             None if pools else v.feats, store)

    def tail(state, cohort, xs, ys, key, stage, mask=None, ema=None,
             lag=None):
        stale_w = None
        if staleness_weighting != "none":
            lg = torch.tensor(float(lag or 0), dtype=torch.float32,
                              device=ys.device)
            stale_w = (1.0 / (1.0 + lg) if staleness_weighting == "inverse"
                       else torch.exp(-staleness_lambda * lg))
        cohort_clients = stage.clients
        if program.uses_global_client:     # to this rank's slots
            cohort_clients = broadcast_entity(stage.clients, ys.shape[0],
                                              fresh=ctx.donate_copies)
        feats = stage.feats
        if feats is None:                 # rebuild the [C, b, ...] view
            pooled = stage.store.features
            feats = pooled.reshape(tuple(ys.shape[:2])
                                   + tuple(pooled.shape[1:]))
        v = RoundVars(state=state, cohort=cohort, xs=xs, ys=ys, key=key,
                      mask=mask, ema=ema, cohort_clients=cohort_clients,
                      server_prev=stage.server_prev, feats=feats,
                      store=stage.store, stale_w=stale_w,
                      split=slot_split(ctx_mesh, cohort.shape[0]),
                      store_rows=rows)
        for phase in tail_phases:
            phase(ctx, v)
        if guard is not None:
            guard(ctx, v)
        if stale_w is not None:
            v.metrics["stale_weight"] = stale_w
        return v.state, v.metrics

    return PipelinedAlgorithm(
        program.name, _init_fn(program, task, opt_server, opt_client, device,
                               rows),
        extract, tail, program.uses_global_client)
