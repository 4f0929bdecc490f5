"""Split-model abstraction: θ_CS = θ_S ∘ θ_C with an explicit cut.

Port of ``repro/core/split.py``: the StageModel zoo's tasks (xent or
mse loss) and the decoder-only transformer cut after ``cfg.cut_layers``
blocks, dense, MoE, SSM and hybrid (whisper's encoder-decoder task,
``WhisperTask``, lives in ``launch/steps.py`` beside its step, as the
reference's does).

On a mesh a task holds its halves' placement (``sharding.specs.shard_plan``
of the whole halves): ``tp``, the ``model`` axis the forwards split
over, ``fsdp``, the ``data`` axis' collectives when it has more than one
rank, and ``plans``, each half's plan (the server's at role 'server',
the client's at 'full').  ``init_server``/``init_client`` draw the whole
model and keep this rank's ``model`` blocks; the ``data`` blocks (FSDP)
are cut where a round places its state (``api.phases.place_state``),
and the round gathers them at use (``sharding.parallel.gather_from_data``):
the task's forwards always take leaves whole over ``data``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.cnn import StageModel
from repro_torch.models.module import SHAPES
from repro_torch.models.transformer import (Transformer, block_kind,
                                            positions_for)
from repro_torch.sharding.parallel import gather_from_model
from repro_torch.sharding.specs import (mesh_placement, shard_params,
                                        shard_plan)
from repro_torch.utils.tree import tree_leaves, tree_slice


@dataclass(frozen=True)
class SplitTask:
    """The split-learning contract (paper Eq. 1)."""

    name: str
    init_client: Callable[[Any], Any]                 # generator -> θ_C
    init_server: Callable[[Any], Any]                 # generator -> θ_S
    client_forward: Callable[[Any, Any], Any]         # (θ_C, x) -> features
    server_apply: Callable[[Any, Any], Any]           # (θ_S, f) -> outputs
    loss: Callable[[Any, Any], torch.Tensor]          # (outputs, y) -> scalar
    metrics: Callable[[Any, Any], dict]               # (outputs, y) -> dict
    # the server head's [D_flat, K] weight when the WHOLE server is one
    # bias-free flatten-matmul + xent, i.e. iff
    # ``server_loss(sp, f, y) == xent(flatten(f) @ server_head(sp), y)``:
    # the contract the fused gather + loss kernel relies on; None
    # disables fusion
    server_head: Any = None                           # (θ_S) -> w, or None
    # the sharding.parallel.TensorParallel the halves' params are split
    # under (their leaves then hold this rank's shards; gradient norms
    # sum the shards over the model axis), or None
    tp: Any = None
    # the data axis' Collectives when the halves' leaves split over it
    # (FSDP), else None
    fsdp: Any = None
    # {"server": plan, "client": plan}: each half's sharding.specs plan
    # (from the whole halves' shapes), or None
    plans: Any = None

    def server_loss(self, sp, features, y):
        return self.loss(self.server_apply(sp, features), y)

    def e2e_loss(self, cp, sp, x, y):
        return self.server_loss(sp, self.client_forward(cp, x), y)

    def predict(self, cp, sp, x):
        return self.server_apply(sp, self.client_forward(cp, x))


def xent_loss(logits, y):
    ll = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.take_along_dim(ll, y[..., None].long(), dim=-1))


def xent_metrics(logits, y):
    pred = torch.argmax(logits, dim=-1)
    return {"accuracy": torch.mean((pred == y).float())}


def mse_loss(pred, y):
    return torch.mean(torch.square(pred.float() - y))


def mse_metrics(pred, y):
    # angular-distance analog used by the paper's gaze task
    p = pred / (torch.linalg.vector_norm(pred, dim=-1, keepdim=True) + 1e-8)
    t = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-8)
    cos = torch.clamp(torch.sum(p * t, dim=-1), -1, 1)
    return {"angular_deg": torch.mean(torch.rad2deg(torch.arccos(cos)))}


def make_stage_task(model: StageModel, cut: int, kind: str = "xent",
                    name: str | None = None, mesh=None) -> SplitTask:
    """Split a StageModel at stage index ``cut`` (paper's block-wise cut).

    The client and the server each draw the whole model from their own
    generator and keep their half, as the JAX package does with keys.

    ``mesh`` (a ``launch.mesh.Mesh``) places the halves by the
    reference's rules: each half's plan comes from the whole model's
    shapes (a shape-only draw, ``models.module.SHAPES``), the halves
    keep their ``model`` blocks (a ``lin/w`` whose columns divide the
    axis), and the dense stages run column-parallel
    (``models.cnn.dense``).
    """
    if not 0 < cut < model.n_stages:
        raise ValueError(f"cut {cut} out of range (1..{model.n_stages - 1})")
    loss, metrics = ((xent_loss, xent_metrics) if kind == "xent"
                     else (mse_loss, mse_metrics))
    tp = fsdp = plans = None
    if mesh is not None:
        tp, fsdp = mesh_placement(mesh)
        whole = model.init(SHAPES)
        plans = {"server": shard_plan(whole[cut:], mesh.shape, mesh.coords,
                                      "server"),
                 "client": shard_plan(whole[:cut], mesh.shape, mesh.coords,
                                      "full")}

    def keep(half, key):
        return half if plans is None else shard_params(half, plans[key],
                                                       data=False)

    def init_client(gen):
        return keep(model.init(gen)[:cut], "client")

    def init_server(gen):
        return keep(model.init(gen)[cut:], "server")

    def client_forward(cp, x):
        return model.apply_range(cp, x, 0, cut, tp)

    def server_apply(sp, f):
        x = f
        for i in range(cut, model.n_stages):
            x = model.apply_stage(i, sp[i - cut], x, tp)
        return x

    # the fused gather + loss contract: the whole server half is the
    # model's final flatten-matmul head (last cut) under xent; a head
    # split over the model axis is gathered whole for the kernel, as the
    # reference's shard-local loss takes it (in_specs P(None, None))
    server_head = None
    if kind == "xent" and cut == model.n_stages - 1 and model.head_is_linear:
        head_dim = (None if plans is None
                    else tree_leaves(plans["server"][-1])[0].dim)

        def server_head(sp):
            w = tree_leaves(sp[-1])[0]
            if head_dim is None:
                return w
            return gather_from_model(tp, w, "head", head_dim)

    return SplitTask(name or f"{model.name}@cut{cut}",
                     init_client, init_server, client_forward,
                     server_apply, loss, metrics, server_head=server_head,
                     tp=tp, fsdp=fsdp, plans=plans)


# -------------------------------------------------- Transformer builder
def make_transformer_task(cfg: ArchConfig, mesh=None) -> SplitTask:
    """Cut a decoder-only arch after ``cfg.cut_layers`` blocks.

    θ_C = embedding + blocks[:cut] (the smashed data is the block-`cut`
    activation); θ_S = blocks[cut:] + final norm + head.  Labels are the
    next-token ids; the server also owns the MoE aux losses and, for the
    hybrid family, the shared attention block (a client cut must end
    before its first position).  Each side draws the whole model from its
    own generator and keeps its half, as the JAX package does with keys.

    ``mesh`` (a ``launch.mesh.Mesh``) places both halves on it
    (:func:`mesh_placement`): each rank still draws the whole model (the
    same on every rank, from one seed) and keeps its ``model`` shard of
    each leaf (``sharding.specs.shard_plan``), and the forwards run on
    the shards over ``tp``; the plans also hold each leaf's FSDP block
    over ``data``.  The plans read the halves' shapes from a shape-only
    draw (``models.module.SHAPES``).
    """
    cut = cfg.cut_layers
    tp = fsdp = plans = None

    def client_half(p):
        return {"embed": p["embed"], "blocks": tree_slice(p["blocks"], 0, cut)}

    def server_half(p):
        out = {"blocks": tree_slice(p["blocks"], cut, None),
               "final_norm": p["final_norm"]}
        if not cfg.tie_embeddings:
            out["lm_head"] = p["lm_head"]
        else:
            out["embed"] = p["embed"]    # unembedding copy server-side
        if block_kind(cfg) == "hybrid":
            out["shared_attn"] = p["shared_attn"]
        return out

    if mesh is not None:
        tp, fsdp = mesh_placement(mesh, cfg)
        shapes = Transformer.init(SHAPES, cfg)
        plans = {"client": shard_plan(client_half(shapes), mesh.shape,
                                      mesh.coords, "full", cfg),
                 "server": shard_plan(server_half(shapes), mesh.shape,
                                      mesh.coords, "server", cfg)}

    def keep(half, key):
        return half if plans is None else shard_params(half, plans[key],
                                                       data=False)

    def init_client(gen):
        return keep(client_half(Transformer.init(gen, cfg)), "client")

    def init_server(gen):
        return keep(server_half(Transformer.init(gen, cfg)), "server")

    def client_forward(cp, batch):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        patch = batch.get("patch_embeds") if isinstance(batch, dict) else None
        B, S = tokens.shape
        x = Transformer.embed_inputs(cp, cfg, tokens, patch, tp)
        x, _ = Transformer.stack_forward(cp, cfg, x,
                                         positions_for(B, S, tokens.device),
                                         first_block=0, n_blocks=cut, tp=tp)
        return x

    def server_apply(sp, features):
        """Final hidden states + MoE aux; the loss computes the
        cross-entropy chunked from hidden, so the [S, vocab] logits are
        never materialized at once."""
        B, S = features.shape[:2]
        x, metrics = Transformer.stack_forward(
            sp, cfg, features, positions_for(B, S, features.device),
            first_block=cut, n_blocks=cfg.n_layers - cut, tp=tp)
        return {"hidden": x, "aux": metrics, "params": sp}

    def loss(outputs, labels):
        nll, _ = Transformer.chunked_lm_loss(
            outputs["params"], cfg, outputs["hidden"], labels, tp=tp)
        if cfg.moe is not None:
            nll = (nll + cfg.moe.aux_weight * outputs["aux"]["aux_loss"]
                   + cfg.moe.router_z_weight * outputs["aux"]["z_loss"])
        return nll

    def metrics(outputs, labels):
        _, acc = Transformer.chunked_lm_loss(
            outputs["params"], cfg, outputs["hidden"], labels, tp=tp)
        return {"accuracy": acc}

    return SplitTask(f"{cfg.name}@cut{cut}", init_client, init_server,
                     client_forward, server_apply, loss, metrics, tp=tp,
                     fsdp=fsdp, plans=plans)
