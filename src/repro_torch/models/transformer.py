"""Decoder-only transformer assembly (dense / MoE / VLM).

Port of ``repro/models/transformer.py`` for the dense and moe block
kinds:

  embed -> [client blocks] -> CUT -> [server blocks] -> final_norm -> head

Blocks are stacked along a leading layer dim.  The JAX package scans
over groups of ``period`` blocks (2 for gemma2's local/global pair, else
1) under ``jax.checkpoint``; here a Python loop runs the groups and
nothing is checkpointed: each block's activations stay for the backward
(a few GB at the full-width olmoe round, B = 2, S = 2048), and every
attention and router kernel launches once per block per forward, with
no recompute.  The attention backward recomputes the plain attention
(``kernels.ops.flash_attention``), which launches no kernel.  The
split-learning cut is a leading-dim slice of the stacked block params,
so client and server halves run the same code (``core.split``).

The mamba and hybrid stacks and the decode methods are not ported yet
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (embedding, rmsnorm, rmsnorm_init,
                                       softcap, unembed)
from repro_torch.models.module import embed_init, normal, stacked_init
from repro_torch.utils.tree import tree_leaves, tree_map


def _zero_metrics(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"aux_loss": z, "z_loss": z}


def _ssm_later(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the port of the SSM family "
        f"(mamba2.py, the hybrid stack, ssd_scan)")


# ---------------------------------------------------------------- helpers
def block_kind(cfg: ArchConfig) -> str:
    if cfg.family == "ssm":
        return "mamba"
    if cfg.family == "hybrid":
        return "hybrid"
    if cfg.moe is not None:
        return "moe"
    return "dense"


def pattern_period(cfg: ArchConfig) -> int:
    return 2 if cfg.attn.pattern == "local_global" else 1


def _is_local(cfg: ArchConfig, slot: int) -> bool:
    """gemma2 convention: even layer indices are local (sliding window)."""
    return cfg.attn.pattern == "local_global" and slot % 2 == 0


def positions_for(B: int, S: int, device) -> torch.Tensor:
    """Causal index positions arange(S) broadcast to [B, S]."""
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


# ------------------------------------------------------------- block init
def _dense_block_init(gen, cfg: ArchConfig, dtype):
    dev = gen.device
    p = {
        "attn": attn_lib.attn_init(gen, cfg, dtype),
        "ffn": ffn_lib.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype),
        "norm_attn": rmsnorm_init(cfg.d_model, dtype, dev),
        "norm_ffn": rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if cfg.sandwich_norm:
        p["post_attn"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["post_ffn"] = rmsnorm_init(cfg.d_model, dtype, dev)
    return p


def _moe_block_init(gen, cfg: ArchConfig, dtype):
    dev = gen.device
    p = {
        "attn": attn_lib.attn_init(gen, cfg, dtype),
        "moe": moe_lib.moe_init(gen, cfg.d_model, cfg.moe, dtype),
        "norm_attn": rmsnorm_init(cfg.d_model, dtype, dev),
        "norm_ffn": rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if cfg.moe.n_shared_experts:
        f = cfg.moe.n_shared_experts * cfg.moe.d_ff_expert
        p["shared_ffn"] = ffn_lib.swiglu_init(gen, cfg.d_model, f, dtype)
    return p


def block_init(gen, cfg: ArchConfig, dtype):
    kind = block_kind(cfg)
    if kind in ("mamba", "hybrid"):
        raise _ssm_later(f"the {kind} block")
    if kind == "moe":
        return _moe_block_init(gen, cfg, dtype)
    return _dense_block_init(gen, cfg, dtype)


# ---------------------------------------------------------- block forward
def dense_or_moe_block(params, cfg: ArchConfig, x, positions, window):
    """One attention block (full-seq).  Returns (x, metrics)."""
    h = rmsnorm(params["norm_attn"], x, cfg.norm_eps)
    a, _ = attn_lib.attend_full(params["attn"], cfg, h, positions, window)
    if cfg.sandwich_norm:
        a = rmsnorm(params["post_attn"], a, cfg.norm_eps)
    x = x + a
    h = rmsnorm(params["norm_ffn"], x, cfg.norm_eps)
    metrics = _zero_metrics(x.device)
    if "moe" in params:
        f, m = moe_lib.moe_apply(params["moe"], cfg.moe, h)
        if "shared_ffn" in params:
            f = f + ffn_lib.swiglu(params["shared_ffn"], h)
        metrics = {"aux_loss": m["aux_loss"], "z_loss": m["z_loss"]}
    else:
        f = ffn_lib.swiglu(params["ffn"], h)
        if cfg.sandwich_norm:
            f = rmsnorm(params["post_ffn"], f, cfg.norm_eps)
    return x + f, metrics


def mamba_block(params, cfg: ArchConfig, x):
    raise _ssm_later("mamba_block")


# --------------------------------------------------------------- the model
class Transformer:
    """Namespace of functions for decoder-only models."""

    # ---------------- init ----------------
    @staticmethod
    def init(gen: torch.Generator, cfg: ArchConfig):
        """Random params drawn on ``gen``'s device."""
        dtype = cfg.torch_dtype
        params = {
            "embed": {"table": embed_init(gen, cfg.vocab_padded, cfg.d_model,
                                          dtype)},
            "blocks": stacked_init(lambda g: block_init(g, cfg, dtype), gen,
                                   cfg.n_layers),
            "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": normal(gen, (cfg.d_model,
                                                   cfg.vocab_padded),
                                             0.02, dtype)}
        return params

    # -------------- stacks -----------------
    @staticmethod
    def _run_stack(blocks, cfg: ArchConfig, x, positions, *, layer_offset: int,
                   long_context: bool):
        """Blocks in order, in groups of ``period``.  Returns
        (x, metrics summed over the blocks)."""
        period = pattern_period(cfg)
        n = tree_leaves(blocks)[0].shape[0]
        metrics = _zero_metrics(x.device)
        if n == 0:
            return x, metrics
        assert n % period == 0, f"stack of {n} not divisible by period {period}"
        for i in range(n):
            bp = tree_map(lambda a: a[i], blocks)
            slot = i % period
            local = _is_local(cfg, (layer_offset + slot) % period
                              if period > 1 else 0)
            window = attn_lib.layer_window(cfg, local, long_context)
            x, m = dense_or_moe_block(bp, cfg, x, positions, window)
            metrics = {k: metrics[k] + m[k] for k in metrics}
        return x, metrics

    @staticmethod
    def _hybrid_stack(blocks, shared_attn, cfg: ArchConfig, x, positions, *,
                      first_block: int, n_blocks: int, long_context: bool):
        raise _ssm_later("the hybrid stack")

    # -------------- forward -----------------
    @staticmethod
    def embed_inputs(params, cfg: ArchConfig, tokens, patch_embeds=None):
        x = embedding(params["embed"], tokens)
        if cfg.family == "vlm" and patch_embeds is not None:
            npt = patch_embeds.shape[1]
            x = torch.cat([patch_embeds.to(x.dtype), x[:, npt:]], dim=1)
        # the factor rounds to x's dtype first, as in the JAX package
        return x * torch.tensor(math.sqrt(float(cfg.d_model)), dtype=x.dtype,
                                device=x.device)

    @staticmethod
    def stack_forward(params, cfg: ArchConfig, x, positions, *,
                      first_block: int, n_blocks: int,
                      long_context: bool = False):
        """Run blocks [first, first+n) of a (possibly sliced) stack."""
        if n_blocks == 0:
            return x, _zero_metrics(x.device)
        if block_kind(cfg) == "hybrid":
            return Transformer._hybrid_stack(
                params["blocks"], params.get("shared_attn"), cfg, x,
                positions, first_block=first_block, n_blocks=n_blocks,
                long_context=long_context)
        return Transformer._run_stack(
            params["blocks"], cfg, x, positions, layer_offset=first_block,
            long_context=long_context)

    @staticmethod
    def head(params, cfg: ArchConfig, x, keep_padded: bool = False):
        """Final norm + unembedding.  Returns float32 logits [..., vocab]
        (padded columns sliced off unless ``keep_padded``)."""
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(params["embed"], x) if cfg.tie_embeddings \
            else x @ params["lm_head"]["w"]
        logits = softcap(logits.float(), cfg.attn.final_softcap)
        if keep_padded or cfg.vocab_padded == cfg.vocab:
            return logits
        return logits[..., :cfg.vocab]

    @staticmethod
    def chunked_lm_loss(params, cfg: ArchConfig, hidden, labels,
                        chunk: int = 512):
        """Cross-entropy from final hidden states over sequence chunks of
        ``chunk`` positions, each a [B, chunk, vocab_padded] logits tile;
        padded vocab columns are masked to -1e30 and label -1 (sequence
        padding) is left out.  Returns (mean nll, mean accuracy)."""
        B, S, d = hidden.shape
        chunk = min(chunk, S)
        if S % chunk:
            pad = chunk - S % chunk
            hidden = F.pad(hidden, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=-1)
            S += pad
        n_pad = cfg.vocab_padded - cfg.vocab
        pad_cols = torch.arange(cfg.vocab_padded,
                                device=hidden.device) >= cfg.vocab
        nll_sum = correct_sum = count = 0.0
        for lo in range(0, S, chunk):
            h, l = hidden[:, lo:lo + chunk], labels[:, lo:lo + chunk]
            logits = Transformer.head(params, cfg, h, keep_padded=True)
            if n_pad:
                logits = logits.masked_fill(pad_cols, -1e30)
            ll = torch.log_softmax(logits, dim=-1)
            valid = (l >= 0).float()
            lc = torch.clamp(l, min=0).long()
            nll = -torch.gather(ll, -1, lc[..., None])[..., 0]
            correct = (torch.argmax(ll, -1) == lc).float()
            nll_sum = nll_sum + torch.sum(nll * valid)
            correct_sum = correct_sum + torch.sum(correct * valid)
            count = count + torch.sum(valid)
        n = torch.clamp(count, min=1.0)
        return nll_sum / n, correct_sum / n

    @staticmethod
    def forward(params, cfg: ArchConfig, tokens, patch_embeds=None,
                long_context: bool = False):
        """Full forward.  tokens [B, S] -> (logits float32 [B, S, V],
        metrics)."""
        B, S = tokens.shape
        positions = positions_for(B, S, tokens.device)
        x = Transformer.embed_inputs(params, cfg, tokens, patch_embeds)
        x, metrics = Transformer.stack_forward(
            params, cfg, x, positions, first_block=0, n_blocks=cfg.n_layers,
            long_context=long_context)
        return Transformer.head(params, cfg, x), metrics

    # -------------- loss -----------------
    @staticmethod
    def loss_fn(params, cfg: ArchConfig, tokens, labels, patch_embeds=None):
        logits, metrics = Transformer.forward(params, cfg, tokens, patch_embeds)
        ll = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(ll, -1, labels[..., None].long())[..., 0]
        loss = torch.mean(nll)
        if cfg.moe is not None:
            loss = (loss + cfg.moe.aux_weight * metrics["aux_loss"]
                    + cfg.moe.router_z_weight * metrics["z_loss"])
        return loss, metrics

    # -------------- serving -----------------
    @staticmethod
    def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int,
                          long_context: bool = False):
        raise NotImplementedError(
            "decode state (KVCache) is not ported yet: it comes with the "
            "port of the serving path")

    @staticmethod
    def decode_step(params, cfg: ArchConfig, token, state,
                    long_context: bool = False):
        raise NotImplementedError(
            "decode_step is not ported yet: it comes with the port of the "
            "serving path")
