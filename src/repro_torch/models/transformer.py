"""Decoder-only transformer assembly (dense / MoE / SSM / hybrid / VLM).

Port of ``repro/models/transformer.py`` for the full-sequence path:

  embed -> [client blocks] -> CUT -> [server blocks] -> final_norm -> head

Blocks are stacked along a leading layer dim.  As the JAX package
scans over groups of ``period`` blocks (2 for gemma2's local/global
pair, else 1) under ``jax.checkpoint``, a Python loop here runs each
group under ``module.remat``: a training step keeps each group's input
[B, S, d] for the backward and recomputes the group's forward there, so
its activations live one group at a time.  Each loss chunk of
:meth:`Transformer.chunked_lm_loss` is recomputed the same way, so no
[B, chunk, vocab_padded] tile lives until the backward.  The recompute
launches the group's attention, router and SSD-scan kernels and issues
its ``model``-axis collectives again (up to the group's last op that
saves a tensor); under ``no_grad`` (extraction, evaluation, prefill)
every group runs once.  The attention and scan backwards recompute
their plain versions (``kernels.ops``), which launch no kernel.  The
hybrid family (zamba2) applies ONE shared attention block after each
listed mamba block.  The full-sequence functions take ``tp``, a
``sharding.parallel.TensorParallel``: on a mesh's ``model`` axis the
attention, FFN and MoE blocks, the Mamba-2 blocks (on whole SSD heads),
the hybrid's shared block, the embedding and the head run on this
rank's shards of their weights.  The split-learning
cut is a leading-dim slice of the stacked block params, so client and
server halves run the same code (``core.split``).

Serving (``init_decode_state``, ``decode_step``) steps one token through
the same blocks against a ring-buffer KV cache (attention blocks) and
the carried SSM state (mamba blocks), in plain torch but for the MoE
router's ``topk_gating``.  The decode position is one per row, a scalar
or [B] ``state["pos"]``, so the serving runtime advances slots at
different positions in one call.  Decode takes ``tp`` as the
full-sequence functions do: each rank holds its heads of the cache and
the SSM state (its block under ``sharding.specs.decode_state_plan``)
and its shards of the weights, and every rank returns the whole logits
of its rows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import module
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (embedding, rmsnorm, rmsnorm_init,
                                       softcap, unembed)
from repro_torch.models.module import embed_init, normal, stacked_init
from repro_torch.sharding.parallel import copy_to_model, gather_from_model
from repro_torch.utils.tree import tree_leaves, tree_map


def _zero_metrics(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"aux_loss": z, "z_loss": z}


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


def _mamba_block_init(gen, cfg: ArchConfig, dtype):
    return {
        "mamba": mamba_lib.mamba_init(gen, cfg, dtype),
        "norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
    }


def block_init(gen, cfg: ArchConfig, dtype):
    kind = block_kind(cfg)
    if kind in ("mamba", "hybrid"):
        return _mamba_block_init(gen, cfg, dtype)
    if kind == "moe":
        return _moe_block_init(gen, cfg, dtype)
    return _dense_block_init(gen, cfg, dtype)


# ---------------------------------------------------------- block forward
def dense_or_moe_block(params, cfg: ArchConfig, x, positions, window,
                       tp=None):
    """One attention block (full-seq).  Returns (x, metrics)."""
    h = rmsnorm(params["norm_attn"], x, cfg.norm_eps)
    a, _ = attn_lib.attend_full(params["attn"], cfg, h, positions, window,
                                tp)
    if cfg.sandwich_norm:
        a = rmsnorm(params["post_attn"], a, cfg.norm_eps)
    x = x + a
    h = rmsnorm(params["norm_ffn"], x, cfg.norm_eps)
    metrics = _zero_metrics(x.device)
    if "moe" in params:
        f, m = moe_lib.moe_apply(params["moe"], cfg.moe, h, tp=tp)
        if "shared_ffn" in params:
            f = f + ffn_lib.swiglu(params["shared_ffn"], h, tp, "shared_ffn")
        metrics = {"aux_loss": m["aux_loss"], "z_loss": m["z_loss"]}
    else:
        f = ffn_lib.swiglu(params["ffn"], h, tp)
        if cfg.sandwich_norm:
            f = rmsnorm(params["post_ffn"], f, cfg.norm_eps)
    return x + f, metrics


def mamba_block(params, cfg: ArchConfig, x, tp=None):
    """One mamba2 block (pre-norm, residual); its final SSD state is
    dropped.  Returns (x, metrics)."""
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    y, _ = mamba_lib.mamba_forward(params["mamba"], cfg, h, tp)
    return x + y, _zero_metrics(x.device)


def _moe_decode(params, cfg: ArchConfig, h, group_size, tp, rows):
    """The MoE of one decode step over ``h`` [B_r, 1, d], this rank's
    rows.  A dispatch group holds ``group_size`` rows in batch order
    (default the config's), with a capacity of its own: where a group of
    the whole batch would span the ranks of ``rows`` (the batch axes'
    collectives, None when the rows are whole), the rows are gathered
    over them first (census ``all_gather/moe_rows``), every rank routes
    and runs them all, and keeps its own, so the step computes the
    unsharded batch's function.  Where the groups fall inside a rank's
    rows (the serving runtime's group of 1), no row moves."""
    gs = cfg.moe.group_size if group_size is None else group_size
    n = h.shape[0]
    if rows is None or n % min(gs, n * rows.size) == 0:
        return moe_lib.moe_apply(params, cfg.moe, h, group_size=group_size,
                                 tp=tp)[0]
    every = rows.all_gather(h, "moe_rows")
    f, _ = moe_lib.moe_apply(params, cfg.moe, every, group_size=group_size,
                             tp=tp)
    return f[rows.rank * n:(rows.rank + 1) * n]


def _group(x, metrics, gparams, cfg: ArchConfig, positions,
           layer_offset: int, long_context: bool, tp=None):
    """One group of blocks (``gparams``, one block's params each), the
    body that ``Transformer._run_stack`` rematerialises: the JAX
    package's ``group_body``, the metrics carried through it.  Returns
    (x, metrics plus the group's)."""
    kind = block_kind(cfg)
    period = pattern_period(cfg)
    for slot, bp in enumerate(gparams):
        if kind in ("mamba", "hybrid"):
            x, m = mamba_block(bp, cfg, x, tp)
        else:
            local = _is_local(cfg, (layer_offset + slot) % period
                              if period > 1 else 0)
            window = attn_lib.layer_window(cfg, local, long_context)
            x, m = dense_or_moe_block(bp, cfg, x, positions, window, tp)
        metrics = {k: metrics[k] + m[k] for k in metrics}
    return x, metrics


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
        if block_kind(cfg) == "hybrid":
            # one SHARED attention block (zamba2), reused at each position
            params["shared_attn"] = _dense_block_init(gen, cfg, dtype)
        return params

    # -------------- stacks -----------------
    @staticmethod
    def _run_stack(blocks, cfg: ArchConfig, x, positions, *, layer_offset: int,
                   long_context: bool, tp=None):
        """Blocks in order, in groups of ``period``, each group under
        ``module.remat`` (:func:`_group`).  Returns (x, metrics summed
        over the blocks)."""
        period = pattern_period(cfg)
        n = tree_leaves(blocks)[0].shape[0]
        metrics = _zero_metrics(x.device)
        if n == 0:
            return x, metrics
        assert n % period == 0, f"stack of {n} not divisible by period {period}"
        for g in range(0, n, period):
            gparams = [tree_map(lambda a: a[i], blocks)
                       for i in range(g, g + period)]
            x, metrics = module.remat(_group, x, metrics, gparams, cfg,
                                      positions, layer_offset, long_context,
                                      tp)
        return x, metrics

    @staticmethod
    def _hybrid_stack(blocks, shared_attn, cfg: ArchConfig, x, positions, *,
                      first_block: int, n_blocks: int, long_context: bool,
                      tp=None):
        """Mamba blocks [first, first + n), each a group of its own under
        ``module.remat``, with the shared attention block applied after
        every block index listed in ``cfg.ssm.shared_attn_positions``,
        outside any checkpoint, as the JAX package applies it between
        its checkpointed runs of mamba blocks."""
        window = attn_lib.layer_window(cfg, False, long_context)
        metrics = _zero_metrics(x.device)
        for i in range(n_blocks):
            x, metrics = module.remat(_group, x, metrics,
                                      [tree_map(lambda a: a[i], blocks)],
                                      cfg, None, 0, long_context, tp)
            if first_block + i in cfg.ssm.shared_attn_positions:
                x, m = dense_or_moe_block(shared_attn, cfg, x, positions,
                                          window, tp)
                metrics = {k: metrics[k] + m[k] for k in metrics}
        return x, metrics

    # -------------- forward -----------------
    @staticmethod
    def embed_inputs(params, cfg: ArchConfig, tokens, patch_embeds=None,
                     tp=None):
        x = embedding(params["embed"], tokens, tp)
        if cfg.family == "vlm" and patch_embeds is not None:
            npt = patch_embeds.shape[1]
            x = torch.cat([patch_embeds.to(x.dtype), x[:, npt:]], dim=1)
        # the factor rounds to x's dtype first, as in the JAX package
        return x * torch.tensor(math.sqrt(float(cfg.d_model)), dtype=x.dtype,
                                device=x.device)

    @staticmethod
    def stack_forward(params, cfg: ArchConfig, x, positions, *,
                      first_block: int, n_blocks: int,
                      long_context: bool = False, tp=None):
        """Run blocks [first, first+n) of a (possibly sliced) stack."""
        if n_blocks == 0:
            return x, _zero_metrics(x.device)
        if block_kind(cfg) == "hybrid":
            shared = params.get("shared_attn")
            if shared is None and any(
                    first_block <= p < first_block + n_blocks
                    for p in cfg.ssm.shared_attn_positions):
                # a split-client stack holds no shared block
                raise ValueError(
                    f"blocks [{first_block}, {first_block + n_blocks}) "
                    f"cross a shared-attention position "
                    f"{cfg.ssm.shared_attn_positions} but the params hold "
                    f"no shared_attn block")
            return Transformer._hybrid_stack(
                params["blocks"], shared, cfg, x, positions,
                first_block=first_block, n_blocks=n_blocks,
                long_context=long_context, tp=tp)
        return Transformer._run_stack(
            params["blocks"], cfg, x, positions, layer_offset=first_block,
            long_context=long_context, tp=tp)

    @staticmethod
    def head(params, cfg: ArchConfig, x, keep_padded: bool = False,
             tp=None):
        """Final norm + unembedding.  Returns float32 logits [..., vocab]
        (padded columns sliced off unless ``keep_padded``).  When ``tp``
        splits the vocab, each rank's logits are its columns, gathered
        over the ``model`` axis before the softcap."""
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        split = tp is not None and tp.on("vocab")
        if split:
            x = copy_to_model(tp, x)
        logits = unembed(params["embed"], x) if cfg.tie_embeddings \
            else x @ params["lm_head"]["w"]
        if split:
            logits = gather_from_model(tp, logits, "logits")
        logits = softcap(logits.float(), cfg.attn.final_softcap)
        if keep_padded or cfg.vocab_padded == cfg.vocab:
            return logits
        return logits[..., :cfg.vocab]

    @staticmethod
    def chunked_lm_loss(params, cfg: ArchConfig, hidden, labels,
                        chunk: int = 512, tp=None):
        """Cross-entropy from final hidden states over sequence chunks of
        ``chunk`` positions, each a [B, chunk, vocab_padded] logits tile
        under ``module.remat`` (recomputed in the backward, as the JAX
        package checkpoints each chunk); padded vocab columns are masked
        to -1e30 and label -1 (sequence padding) is left out.  Returns
        (mean nll, mean accuracy).  On a ``model`` axis each tile is
        gathered whole (``head``), in the chunk and so again in its
        recompute, and the arithmetic is the same."""
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

        def one(h, l):
            logits = Transformer.head(params, cfg, h, keep_padded=True,
                                      tp=tp)
            if n_pad:
                logits = logits.masked_fill(pad_cols, -1e30)
            ll = torch.log_softmax(logits, dim=-1)
            valid = (l >= 0).float()
            lc = torch.clamp(l, min=0).long()
            nll = -torch.gather(ll, -1, lc[..., None])[..., 0]
            correct = (torch.argmax(ll, -1) == lc).float()
            return (torch.sum(nll * valid), torch.sum(correct * valid),
                    torch.sum(valid))

        nll_sum = correct_sum = count = 0.0
        for lo in range(0, S, chunk):
            nll, correct, valid = module.remat(one, hidden[:, lo:lo + chunk],
                                               labels[:, lo:lo + chunk])
            nll_sum = nll_sum + nll
            correct_sum = correct_sum + correct
            count = count + valid
        n = torch.clamp(count, min=1.0)
        return nll_sum / n, correct_sum / n

    @staticmethod
    def forward(params, cfg: ArchConfig, tokens, patch_embeds=None,
                long_context: bool = False, tp=None):
        """Full forward.  tokens [B, S] -> (logits float32 [B, S, V],
        metrics)."""
        B, S = tokens.shape
        positions = positions_for(B, S, tokens.device)
        x = Transformer.embed_inputs(params, cfg, tokens, patch_embeds, tp)
        x, metrics = Transformer.stack_forward(
            params, cfg, x, positions, first_block=0, n_blocks=cfg.n_layers,
            long_context=long_context, tp=tp)
        return Transformer.head(params, cfg, x, tp=tp), metrics

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
    def cache_capacity(cfg: ArchConfig, seq_len: int, long_context: bool):
        if long_context:
            w = cfg.long_context_window
            if cfg.attn.pattern in ("local", "local_global") and cfg.attn.window:
                w = max(w, cfg.attn.window)
            return min(seq_len, w)
        return seq_len

    @staticmethod
    def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int,
                          long_context: bool = False, device=None):
        """KV caches / SSM state for decode at a given context, on
        ``device``; ``pos`` (and the cache's ``idx``) is a scalar, which
        the caller may replace by one per row.  Whole: on a mesh a rank
        holds its block of it (``sharding.specs.decode_state_zeros``)."""
        dtype = cfg.torch_dtype
        kind = block_kind(cfg)
        state = {}
        if kind in ("mamba", "hybrid"):
            state["mamba"] = mamba_lib.mamba_state_init(
                cfg, cfg.n_layers, batch, dtype, device)
        if kind != "mamba":
            n = (len(cfg.ssm.shared_attn_positions) if kind == "hybrid"
                 else cfg.n_layers)
            cap = Transformer.cache_capacity(cfg, seq_len, long_context)
            state["kv"] = attn_lib.kv_cache_init(cfg, n, batch, cap, dtype,
                                                 device)
        state["pos"] = torch.zeros((), dtype=torch.int32, device=device)
        return state

    @staticmethod
    def decode_step(params, cfg: ArchConfig, token, state,
                    long_context: bool = False, moe_group_size=None,
                    tp=None, rows=None):
        """One-token decode.  token [B, 1] -> (logits [B, 1, V], state').

        ``moe_group_size`` is the MoE dispatch group (default the
        config's): ``launch.serve`` routes the batch as one group, as the
        JAX package does, and the serving runtime passes 1, the group its
        ``vmap`` over slots gives each slot.  ``state`` is left as it
        was.  With ``tp`` (see the module's docstring) the embedding and
        the head run vocab-parallel (the logits gathered whole), the
        attention and the Mamba blocks head-parallel, the FFNs on hidden
        columns and the MoE on experts, its router whole on every
        rank.  ``rows`` (the batch axes' collectives, where the rows
        split over them) lets an MoE dispatch group span the ranks'
        rows: see :func:`_moe_decode`."""
        x = Transformer.embed_inputs(params, cfg, token, tp=tp)
        kind = block_kind(cfg)
        if kind in ("mamba", "hybrid"):
            return Transformer._ssm_decode(params, cfg, x, state,
                                           long_context, tp)
        pos, kv = state["pos"], state["kv"]
        ks, vs = [], []
        for li in range(cfg.n_layers):
            bp = tree_map(lambda a: a[li], params["blocks"])
            window = attn_lib.layer_window(cfg, _is_local(cfg, li),
                                           long_context)
            h = rmsnorm(bp["norm_attn"], x, cfg.norm_eps)
            a, nk, nv = attn_lib.attend_decode(bp["attn"], cfg, h, kv.k[li],
                                               kv.v[li], pos, window, tp)
            ks.append(nk)
            vs.append(nv)
            if cfg.sandwich_norm:
                a = rmsnorm(bp["post_attn"], a, cfg.norm_eps)
            x = x + a
            h = rmsnorm(bp["norm_ffn"], x, cfg.norm_eps)
            if "moe" in bp:
                f = _moe_decode(bp["moe"], cfg, h, moe_group_size, tp,
                                rows)
                if "shared_ffn" in bp:
                    f = f + ffn_lib.swiglu(bp["shared_ffn"], h, tp,
                                           "shared_ffn")
            else:
                f = ffn_lib.swiglu(bp["ffn"], h, tp)
                if cfg.sandwich_norm:
                    f = rmsnorm(bp["post_ffn"], f, cfg.norm_eps)
            x = x + f
        state = dict(state, kv=attn_lib.KVCache(
            torch.stack(ks), torch.stack(vs), kv.idx + 1), pos=pos + 1)
        return Transformer.head(params, cfg, x, tp=tp), state

    @staticmethod
    def _ssm_decode(params, cfg: ArchConfig, x, state, long_context,
                    tp=None):
        """The mamba stack, and for the hybrid family the shared attention
        block after each listed block, each application with its own
        cache (``kv.k[i]`` for the i-th position)."""
        pos, ms = state["pos"], state["mamba"]
        kv = state.get("kv")
        positions = (list(cfg.ssm.shared_attn_positions)
                     if kv is not None else [])
        window = attn_lib.layer_window(cfg, False, long_context)
        hs, cvs, ks, vs = [], [], [], []
        for li in range(cfg.n_layers):
            bp = tree_map(lambda a: a[li], params["blocks"])
            hn = rmsnorm(bp["norm"], x[:, 0], cfg.norm_eps)[:, None]
            y, h2, cv2 = mamba_lib.mamba_decode(bp["mamba"], cfg, hn,
                                                ms.h[li], ms.conv[li], tp)
            x = x + y
            hs.append(h2)
            cvs.append(cv2)
            if li in positions:
                app = positions.index(li)
                bp = params["shared_attn"]
                h = rmsnorm(bp["norm_attn"], x, cfg.norm_eps)
                a, nk, nv = attn_lib.attend_decode(
                    bp["attn"], cfg, h, kv.k[app], kv.v[app], pos, window,
                    tp)
                ks.append(nk)
                vs.append(nv)
                x = x + a
                h = rmsnorm(bp["norm_ffn"], x, cfg.norm_eps)
                x = x + ffn_lib.swiglu(bp["ffn"], h, tp)
        state = dict(state, mamba=mamba_lib.MambaState(torch.stack(hs),
                                                       torch.stack(cvs)),
                     pos=pos + 1)
        if kv is not None:
            state["kv"] = attn_lib.KVCache(torch.stack(ks), torch.stack(vs),
                                           kv.idx + 1)
        return Transformer.head(params, cfg, x, tp=tp), state
