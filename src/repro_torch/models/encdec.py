"""Encoder-decoder transformer (the whisper-base backbone).

Port of ``repro/models/encdec.py``.  The mel-spectrogram and conv
feature extractor is a stub: the inputs are precomputed frame
embeddings [B, T_frames, d].  This module is the transformer backbone:
a bidirectional encoder, and a causal decoder with cross-attention.

Split-learning mapping: the encoder is the client part, the decoder the
server part; the enc/dec boundary is the cut.

Attention follows the port's rule: every full-sequence attention goes
through ``kernels.ops.flash_attention`` (the kernel on the card, its
plain version on the CPU).
  - encoder self-attention: non-causal over the T frames (the JAX
    package's ``sdpa`` / ``sdpa_qchunked(chunk=512)`` split computes one
    function, so the port makes one call);
  - decoder self-attention: ``attention.attend_full`` (causal);
  - cross-attention, in training, prefill and decode: non-causal, the
    decoder's S queries (1 in decode) against the T encoder states.
The full-sequence functions take ``tp``, a
``sharding.parallel.TensorParallel``: on a mesh's ``model`` axis the
three attentions run on this rank's heads (the cross-attention computes
K/V of ``enc_out`` for them alone), the GELU MLPs column/row-parallel,
and the tied embedding and logits vocab-parallel; the layernorms and
position tables stay whole on every rank.  Decode takes ``tp`` too: the
self-attention's cache holds the rank's heads (its block under
``sharding.specs.decode_state_plan``), and ``enc_out`` is whole on
every rank (the cross-attention reads all of its width).
The decode self-attention is ``attention.attend_decode`` (the plain
ring-cache product), and ``decode_step`` recomputes the cross K/V of
``enc_out`` at every step, as the JAX package does.  As the JAX package
scans each side's blocks under ``jax.checkpoint``, :meth:`EncDec.encode`
and :meth:`EncDec.decode_train` run each block under ``module.remat``:
a training step keeps each block's input (and the decoder's
``enc_out``) for the backward and recomputes the block there, its
``flash_attention`` launches and ``model``-axis collectives with it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import module
from repro_torch.models.attention import KVCache, kv_cache_init
from repro_torch.models.layers import (embedding, embedding_init, layernorm,
                                       layernorm_init)
from repro_torch.models.module import normal, stacked_init
from repro_torch.models.transformer import positions_for
from repro_torch.sharding.parallel import (copy_to_model, gather_from_model,
                                           reduce_from_model)
from repro_torch.utils.tree import tree_map

N_AUDIO_FRAMES = 1500  # whisper: 30 s at 50 frames/s after the conv stub
N_TEXT_POSITIONS = 448  # the decoder's learned position table


def _enc_block_init(gen, cfg: ArchConfig, dtype):
    dev = gen.device
    return {
        "attn": attn_lib.attn_init(gen, cfg, dtype),
        "ffn": ffn_lib.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
        "norm_attn": layernorm_init(cfg.d_model, dtype, dev),
        "norm_ffn": layernorm_init(cfg.d_model, dtype, dev),
    }


def _dec_block_init(gen, cfg: ArchConfig, dtype):
    dev = gen.device
    return {
        "self_attn": attn_lib.attn_init(gen, cfg, dtype),
        "cross_attn": attn_lib.attn_init(gen, cfg, dtype),
        "ffn": ffn_lib.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
        "norm_self": layernorm_init(cfg.d_model, dtype, dev),
        "norm_cross": layernorm_init(cfg.d_model, dtype, dev),
        "norm_ffn": layernorm_init(cfg.d_model, dtype, dev),
    }


def _heads(x, B, S, cfg: ArchConfig, n):
    return x.reshape(B, S, n, cfg.hd)


def _attend(bp, cfg: ArchConfig, h, kv_in, tp=None):
    """Non-causal attention of ``h``'s queries over ``kv_in`` (``h``
    itself for the encoder's self-attention, ``enc_out`` for the
    cross-attention).  Head-parallel when ``tp`` splits the attention
    unit: both inputs enter through one ``copy_to_model``, the rank's
    heads are projected and attended, and ``wo``'s rows give a partial
    sum reduced over the ``model`` axis."""
    B, S, _ = h.shape
    T = kv_in.shape[1]
    n_h, n_kv = cfg.n_heads, cfg.n_kv_heads
    split = tp is not None and tp.on("attn")
    if split:
        if kv_in is h:
            h = kv_in = copy_to_model(tp, h)
        else:
            h, kv_in = copy_to_model(tp, h, kv_in)
        n_h, n_kv = n_h // tp.size, n_kv // tp.size
    q = _heads(h @ bp["wq"], B, S, cfg, n_h)
    k = _heads(kv_in @ bp["wk"], B, T, cfg, n_kv)
    v = _heads(kv_in @ bp["wv"], B, T, cfg, n_kv)
    a = ops.flash_attention(q, k, v, causal=False)
    out = a.reshape(B, S, -1) @ bp["wo"]
    return reduce_from_model(tp, out, "attn") if split else out


class EncDec:
    """Namespace of functions for the encoder-decoder family."""

    @staticmethod
    def init(gen: torch.Generator, cfg: ArchConfig):
        """Random params drawn on ``gen``'s device."""
        dtype = cfg.torch_dtype
        dev = gen.device
        enc = {
            "pos": normal(gen, (N_AUDIO_FRAMES, cfg.d_model), 0.01, dtype),
            "blocks": stacked_init(lambda g: _enc_block_init(g, cfg, dtype),
                                   gen, cfg.enc_layers),
            "final_norm": layernorm_init(cfg.d_model, dtype, dev),
        }
        dec = {
            "embed": embedding_init(gen, cfg.vocab_padded, cfg.d_model, dtype),
            "pos": normal(gen, (N_TEXT_POSITIONS, cfg.d_model), 0.01, dtype),
            "blocks": stacked_init(lambda g: _dec_block_init(g, cfg, dtype),
                                   gen, cfg.n_layers),
            "final_norm": layernorm_init(cfg.d_model, dtype, dev),
        }
        return {"encoder": enc, "decoder": dec}

    # ---------------- encoder (client part) ----------------
    @staticmethod
    def encode(enc_params, cfg: ArchConfig, frames, tp=None):
        """frames [B, T, d] (the stub's conv output) -> encoder states."""
        T = frames.shape[1]
        x = frames + enc_params["pos"][:T][None]
        n = enc_params["blocks"]["norm_attn"]["scale"].shape[0]

        def block(x, bp):
            h = layernorm(bp["norm_attn"], x, cfg.norm_eps)
            x = x + _attend(bp["attn"], cfg, h, h, tp)
            h = layernorm(bp["norm_ffn"], x, cfg.norm_eps)
            return x + ffn_lib.gelu_mlp(bp["ffn"], h, tp)

        for i in range(n):
            x = module.remat(block, x,
                             tree_map(lambda a: a[i], enc_params["blocks"]))
        return layernorm(enc_params["final_norm"], x, cfg.norm_eps)

    # ---------------- decoder (server part) ----------------
    @staticmethod
    def decode_train(dec_params, cfg: ArchConfig, tokens, enc_out,
                     tp=None):
        """Teacher-forced decoder forward.  tokens [B, S] -> float32
        logits [B, S, vocab]."""
        B, S = tokens.shape
        x = embedding(dec_params["embed"], tokens, tp)
        x = x + dec_params["pos"][:S][None]
        positions = positions_for(B, S, tokens.device)
        n = dec_params["blocks"]["norm_self"]["scale"].shape[0]

        def block(x, enc_out, bp):
            h = layernorm(bp["norm_self"], x, cfg.norm_eps)
            a, _ = attn_lib.attend_full(bp["self_attn"], cfg, h, positions,
                                        None, tp)
            x = x + a
            h = layernorm(bp["norm_cross"], x, cfg.norm_eps)
            x = x + _attend(bp["cross_attn"], cfg, h, enc_out, tp)
            h = layernorm(bp["norm_ffn"], x, cfg.norm_eps)
            return x + ffn_lib.gelu_mlp(bp["ffn"], h, tp)

        for i in range(n):
            x = module.remat(block, x, enc_out,
                             tree_map(lambda a: a[i], dec_params["blocks"]))
        x = layernorm(dec_params["final_norm"], x, cfg.norm_eps)
        return EncDec._logits(dec_params, cfg, x, tp)

    @staticmethod
    def _logits(dec_params, cfg: ArchConfig, x, tp=None):
        """Unembed against the padded table in the model's dtype, widen to
        float32, and slice the padded columns off.  When ``tp`` splits
        the vocab, each rank's logits are its rows' columns, gathered
        over the ``model`` axis."""
        split = tp is not None and tp.on("vocab")
        if split:
            x = copy_to_model(tp, x)
        logits = x @ dec_params["embed"]["table"].T
        if split:
            logits = gather_from_model(tp, logits, "logits")
        return logits.float()[..., :cfg.vocab]

    @staticmethod
    def forward(params, cfg: ArchConfig, frames, tokens, tp=None):
        enc_out = EncDec.encode(params["encoder"], cfg, frames, tp)
        return EncDec.decode_train(params["decoder"], cfg, tokens, enc_out,
                                   tp)

    @staticmethod
    def loss_fn(params, cfg: ArchConfig, frames, tokens, labels):
        logits = EncDec.forward(params, cfg, frames, tokens)
        ll = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(ll, -1, labels[..., None].long())[..., 0]
        return torch.mean(nll), {}

    # ---------------- serving ----------------
    @staticmethod
    def decode_cache(cfg: ArchConfig, batch: int, seq_len: int,
                     long_context: bool = False, device=None):
        """The empty self-attention ring cache (windowed in long-context
        mode) and position of a decode at ``batch`` rows, on
        ``device``."""
        cap = (seq_len if not long_context
               else min(seq_len, cfg.long_context_window))
        kv = kv_cache_init(cfg, cfg.n_layers, batch, cap, cfg.torch_dtype,
                           device=device)
        return {"kv": kv, "pos": torch.zeros((), dtype=torch.int32,
                                             device=device)}

    @staticmethod
    def init_decode_state(params, cfg: ArchConfig, frames, seq_len: int,
                          long_context: bool = False):
        """Encode once; allocate the self-attention ring cache
        (:meth:`decode_cache`) on the frames' device.  On a mesh,
        ``launch.steps.build_decode_step`` encodes on the rank's shards
        and allocates the rank's block of the cache."""
        enc_out = EncDec.encode(params["encoder"], cfg, frames)
        return {"enc_out": enc_out,
                **EncDec.decode_cache(cfg, frames.shape[0], seq_len,
                                      long_context, frames.device)}

    @staticmethod
    def decode_step(params, cfg: ArchConfig, token, state,
                    long_context: bool = False, tp=None):
        """One-token decode.  token [B, 1] -> (float32 logits [B, 1,
        vocab], state').  ``state["pos"]`` is a scalar or one position a
        row; the learned position is clamped to the table's last row.
        ``state`` is left as it was.  With ``tp`` the self-attention
        (``attention.attend_decode``), the cross-attention, the MLPs
        and the logits run on this rank's shards, as in
        :meth:`decode_train`, and the logits come back whole."""
        dec = params["decoder"]
        pos, kv, enc_out = state["pos"], state["kv"], state["enc_out"]
        B = token.shape[0]
        x = embedding(dec["embed"], token, tp)
        row = torch.clamp(torch.broadcast_to(pos, (B,)),
                          max=dec["pos"].shape[0] - 1).long()
        x = x + dec["pos"][row][:, None]
        window = cfg.long_context_window if long_context else None
        ks, vs = [], []
        for li in range(cfg.n_layers):
            bp = tree_map(lambda a: a[li], dec["blocks"])
            h = layernorm(bp["norm_self"], x, cfg.norm_eps)
            a, nk, nv = attn_lib.attend_decode(bp["self_attn"], cfg, h,
                                               kv.k[li], kv.v[li], pos,
                                               window, tp)
            ks.append(nk)
            vs.append(nv)
            x = x + a
            h = layernorm(bp["norm_cross"], x, cfg.norm_eps)
            x = x + _attend(bp["cross_attn"], cfg, h, enc_out, tp)
            h = layernorm(bp["norm_ffn"], x, cfg.norm_eps)
            x = x + ffn_lib.gelu_mlp(bp["ffn"], h, tp)
        x = layernorm(dec["final_norm"], x, cfg.norm_eps)
        logits = EncDec._logits(dec, cfg, x, tp)
        state = dict(state, kv=KVCache(torch.stack(ks), torch.stack(vs),
                                       kv.idx + 1), pos=pos + 1)
        return logits, state
