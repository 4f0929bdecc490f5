"""Split-model abstraction: θ_CS = θ_S ∘ θ_C with an explicit cut.

Port of ``repro/core/split.py``: the StageModel zoo's tasks and the
decoder-only transformer cut after ``cfg.cut_layers`` blocks (whisper's
encoder-decoder task is not ported yet).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.cnn import StageModel
from repro_torch.models.transformer import Transformer, positions_for
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


def make_stage_task(model: StageModel, cut: int, kind: str = "xent",
                    name: str | None = None) -> SplitTask:
    """Split a StageModel at stage index ``cut`` (paper's block-wise cut).

    The client and the server each draw the whole model from their own
    generator and keep their half, as the JAX package does with keys.
    """
    if not 0 < cut < model.n_stages:
        raise ValueError(f"cut {cut} out of range (1..{model.n_stages - 1})")
    if kind != "xent":
        raise NotImplementedError(f"loss kind {kind!r} is not ported yet")

    def init_client(gen):
        return model.init(gen)[:cut]

    def init_server(gen):
        return model.init(gen)[cut:]

    def client_forward(cp, x):
        return model.apply_range(cp, x, 0, cut)

    def server_apply(sp, f):
        x = f
        for i in range(cut, model.n_stages):
            x = model.stages[i][1](sp[i - cut], x)
        return x

    server_head = None
    if cut == model.n_stages - 1 and model.head_is_linear:
        server_head = lambda sp: tree_leaves(sp[-1])[0]

    return SplitTask(name or f"{model.name}@cut{cut}",
                     init_client, init_server, client_forward,
                     server_apply, xent_loss, xent_metrics,
                     server_head=server_head)


# -------------------------------------------------- Transformer builder
def make_transformer_task(cfg: ArchConfig) -> SplitTask:
    """Cut a decoder-only arch after ``cfg.cut_layers`` blocks.

    θ_C = embedding + blocks[:cut] (the smashed data is the block-`cut`
    activation); θ_S = blocks[cut:] + final norm + head.  Labels are the
    next-token ids; the server also owns the MoE aux losses.  Each side
    draws the whole model from its own generator and keeps its half, as
    the JAX package does with keys.
    """
    cut = cfg.cut_layers

    def init_client(gen):
        p = Transformer.init(gen, cfg)
        return {"embed": p["embed"], "blocks": tree_slice(p["blocks"], 0, cut)}

    def init_server(gen):
        p = Transformer.init(gen, cfg)
        out = {"blocks": tree_slice(p["blocks"], cut, None),
               "final_norm": p["final_norm"]}
        if not cfg.tie_embeddings:
            out["lm_head"] = p["lm_head"]
        else:
            out["embed"] = p["embed"]    # unembedding copy server-side
        return out

    def client_forward(cp, batch):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        patch = batch.get("patch_embeds") if isinstance(batch, dict) else None
        B, S = tokens.shape
        x = Transformer.embed_inputs(cp, cfg, tokens, patch)
        x, _ = Transformer.stack_forward(cp, cfg, x,
                                         positions_for(B, S, tokens.device),
                                         first_block=0, n_blocks=cut)
        return x

    def server_apply(sp, features):
        """Final hidden states + MoE aux; the loss computes the
        cross-entropy chunked from hidden, so the [S, vocab] logits are
        never materialized at once."""
        B, S = features.shape[:2]
        x, metrics = Transformer.stack_forward(
            sp, cfg, features, positions_for(B, S, features.device),
            first_block=cut, n_blocks=cfg.n_layers - cut)
        return {"hidden": x, "aux": metrics, "params": sp}

    def loss(outputs, labels):
        nll, _ = Transformer.chunked_lm_loss(
            outputs["params"], cfg, outputs["hidden"], labels)
        if cfg.moe is not None:
            nll = (nll + cfg.moe.aux_weight * outputs["aux"]["aux_loss"]
                   + cfg.moe.router_z_weight * outputs["aux"]["z_loss"])
        return nll

    def metrics(outputs, labels):
        _, acc = Transformer.chunked_lm_loss(
            outputs["params"], cfg, outputs["hidden"], labels)
        return {"accuracy": acc}

    return SplitTask(f"{cfg.name}@cut{cut}", init_client, init_server,
                     client_forward, server_apply, loss, metrics)
