"""Plain PyTorch versions of the ported kernels (the correctness contract).

Each mirrors the JAX package's oracle of the same name.  The kernel
wrappers run these for tensors on the CPU; on the card they are used
only to check the kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0e38

# Above this many query positions the plain attention runs in query
# chunks of QCHUNK rows, so the [Sq, Sk] scores never exist at once (the
# JAX package's attend_full switches to sdpa_qchunked at the same point).
QCHUNK_THRESHOLD = 2048
QCHUNK = 1024


def feature_resample_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather: out[i] = src[idx[i]].  src [T, D], idx [M] -> [M, D]."""
    return torch.index_select(src, 0, idx)


def gather_loss_microbatch_ref(src, labels, idx, w,
                               b: Optional[torch.Tensor] = None):
    """Fused gather + linear-head cross-entropy (float32 math).

    ``out[i] = xent(src[idx[i]] @ w (+ b), labels[idx[i]])``: src [T, D],
    labels [T] int, idx [M], w [D, K], b [K] or None -> [M] float32.
    """
    f = torch.index_select(src, 0, idx).float()
    logits = f @ w.float()
    if b is not None:
        logits = logits + b.float()
    ll = torch.log_softmax(logits, dim=-1)
    y = torch.index_select(labels, 0, idx).long()
    return -torch.take_along_dim(ll, y[:, None], dim=1)[:, 0]


def fused_adam_ref(p, g, m, v, step, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                   weight_decay=0.0):
    """One Adam step, bias-corrected at t = step + 1 in float32.

    ``step`` is an int tensor: a scalar, or one count per entity when the
    leaves are stacked [C, ...] (each row is corrected with its own t).
    Returns (p', m', v') and leaves the inputs untouched.
    """
    t = step.float() + 1.0
    t = t.reshape(t.shape + (1,) * (p.dim() - t.dim()))
    gf = g.float()
    m2 = b1 * m + (1 - b1) * gf
    v2 = b2 * v + (1 - b2) * gf * gf
    mh = m2 / (1 - torch.pow(b1, t))
    vh = v2 / (1 - torch.pow(b2, t))
    upd = -lr * mh / (torch.sqrt(vh) + eps)
    if weight_decay:
        upd = upd - lr * weight_decay * p.float()
    return (p.float() + upd).to(p.dtype), m2, v2


# ------------------------------------------------------------ attention
def mask_bias(q_pos, k_pos, window: Optional[int], causal: bool = True):
    """Additive float32 mask bias [..., Sq, Sk] from absolute positions:
    0 where key k is visible from query q, else -2e38."""
    delta = q_pos[..., :, None] - k_pos[..., None, :]
    valid = torch.ones(delta.shape, dtype=torch.bool, device=delta.device)
    if causal:
        valid &= delta >= 0
    if window is not None:
        valid &= delta < window
    return torch.where(valid, 0.0, NEG_INF)


def sdpa(q, k, v, bias, cap: Optional[float] = None):
    """Attention in float32 math.  q [B, Sq, H, Dh], k/v [B, Sk, Hkv, Dh]
    (query head h reads kv head h // (H / Hkv)), bias [B?, Sq, Sk]."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qf = (q.float() / math.sqrt(Dh)).reshape(B, Sq, Hkv, g, Dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    logits = logits + (bias[:, None, None] if bias.dim() == 3 else bias)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def query_chunks(q_pos, k_pos, window: Optional[int], causal: bool = True,
                 chunk: Optional[int] = None):
    """(lo, hi, bias [B?, hi - lo, Sk]) for each chunk of ``chunk`` query
    rows; by default one chunk up to QCHUNK_THRESHOLD rows and chunks of
    QCHUNK rows above it.  The one place that chunking rule lives: the
    plain attention and its recomputing backward both iterate it."""
    Sq = q_pos.shape[-1]
    if chunk is None:
        chunk = QCHUNK if Sq > QCHUNK_THRESHOLD else Sq
    for lo in range(0, Sq, chunk):
        hi = min(lo + chunk, Sq)
        bias = mask_bias(q_pos[..., lo:hi], k_pos, window, causal)
        yield lo, hi, bias[None] if bias.dim() == 2 else bias


def sdpa_qchunked(q, k, v, q_pos, k_pos, window: Optional[int],
                  cap: Optional[float], causal: bool = True,
                  chunk: int = QCHUNK):
    """``sdpa`` over query chunks of ``chunk`` rows (each query row's
    softmax is its own, so the values are those of one call).  q_pos
    [B?, Sq], k_pos [B?, Sk]."""
    return torch.cat([sdpa(q[:, lo:hi], k, v, bias, cap) for lo, hi, bias
                      in query_chunks(q_pos, k_pos, window, causal, chunk)],
                     dim=1)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """q [B, Sq, H, D], k/v [B, Sk, Hkv, D] -> [B, Sq, H, D] in q's dtype.

    Masks by index (query i, key j: causal j <= i, window i - j <
    window), which is the position mask of every caller, whose positions
    are arange(S).  Runs ``sdpa``, or ``sdpa_qchunked`` above
    QCHUNK_THRESHOLD query rows, as the JAX package's attend_full does.
    """
    q_pos = torch.arange(q.shape[1], device=q.device)[None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None]
    outs = [sdpa(q[:, lo:hi], k, v, bias, softcap) for lo, hi, bias
            in query_chunks(q_pos, k_pos, window, causal)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# --------------------------------------------------------------- gating
def topk_gating_ref(logits, k: int):
    """Softmax over E, then k rounds of argmax-and-mask (a tie goes to
    the lower index, as torch.argmax and the TPU kernel take it), then
    the k weights renormalized by max(sum, 1e-9).  logits [T, E] ->
    (weights [T, k] float32, ids [T, k] int32)."""
    probs = torch.softmax(logits.float(), dim=-1)
    masked = probs
    ws, ids = [], []
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1, keepdim=True)
        ws.append(torch.gather(masked, -1, idx))
        ids.append(idx)
        masked = masked.scatter(-1, idx, NEG_INF)
    w = torch.cat(ws, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, torch.cat(ids, dim=-1).to(torch.int32)
