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


def fused_adam_ref_(p, g, m, v, step, *, keep=None, lr, b1=0.9, b2=0.999,
                    eps=1e-8, weight_decay=0.0):
    """:func:`fused_adam_ref` written back into ``p``, ``m`` and ``v``
    (``copy_``); returns them, the same objects.  ``keep`` (None, or an
    int32 flag an entity, shaped as ``step``) keeps an entity whose flag
    is 0 as it was: the out-of-place result selected by ``keep`` against
    the inputs, as ``core.protocol.select_entities`` selects."""
    new = fused_adam_ref(p, g, m, v, step, lr=lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay)
    if keep is not None:
        k = keep.reshape(tuple(keep.shape) + (1,) * (p.dim() - keep.dim()))
        new = [torch.where(k > 0, n, o) for n, o in zip(new, (p, m, v))]
    for dst, src in zip((p, m, v), new):
        dst.copy_(src)
    return p, m, v


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


# ------------------------------------------------------------------ SSD
# Layouts of the JAX package's mamba2.py: x [B, L, H, P], dt [B, L, H],
# A [H] (negative), B and C [B, L, G, N] with head h reading group
# h // (H / G); G = H is the TPU kernel's per-head contract.

def check_ssd(x, dt, A, Bm, Cm):
    """Raise ValueError unless the five SSD inputs have the layouts
    above; return H // G."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4:
        raise ValueError(f"expected x [B, L, H, P], dt [B, L, H], A [H], "
                         f"B/C [B, L, G, N], got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}")
    Bsz, L, H, _ = x.shape
    G = Bm.shape[2]
    if (tuple(dt.shape) != (Bsz, L, H) or tuple(A.shape) != (H,)
            or Bm.shape != Cm.shape or tuple(Bm.shape[:2]) != (Bsz, L)
            or G == 0 or H % G):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(Bm.shape)}, C "
                         f"{tuple(Cm.shape)} do not match (H % G == 0)")
    return H // G


def ssd_scan_ref(x, dt, A, Bm, Cm):
    """The sequential SSD recurrence, one position at a time:
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T and y_t = C_t h_t.

    Returns (y [B, L, H, P] in x's dtype, the final state h [B, H, N, P]
    float32); float32 math.  The oracle of the tests."""
    rep = check_ssd(x, dt, A, Bm, Cm)
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf = Bm.float().repeat_interleave(rep, dim=2)
    Cf = Cm.float().repeat_interleave(rep, dim=2)
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t] * Af)                          # [B, H]
        h = (dA[..., None, None] * h
             + torch.einsum("bh,bhn,bhp->bhnp", dtf[:, t], Bf[:, t], xf[:, t]))
        ys.append(torch.einsum("bhn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def _chunk_inputs(x, dt, A, Bm, rep):
    """float32 x, dt, B repeated to heads, and the within-chunk cumulative
    decay cum_i = sum_{k <= i} dt_k A."""
    dtf = dt.float()
    return (x.float(), dtf, Bm.float().repeat_interleave(rep, dim=2),
            torch.cumsum(dtf * A.float(), dim=1))


def _chunk_state(h, xf, dtf, bf, cum):
    """The state leaving a chunk: the carried h decayed over the chunk
    plus each row's dt_j B_j x_j^T decayed from row j to the chunk's end
    (exp of a non-positive sum, so nothing overflows)."""
    last = cum[:, -1:, :]                                       # [B, 1, H]
    u = dtf * torch.exp(last - cum)                             # [B, Q, H]
    return (torch.exp(last[:, 0])[:, :, None, None] * h
            + torch.einsum("bqhn,bqhp->bhnp", bf, u[..., None] * xf))


def ssd_chunk(h, x, dt, A, Bm, Cm):
    """One chunk of the SSD dual form (float32 math) on the state ``h``
    [B, H, N, P] carried in: x [B, Q, H, P], dt [B, Q, H], B/C
    [B, Q, G, N].  Returns (y [B, Q, H, P] float32, h' float32).

    y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j (the
    diagonal j = i included) + exp(cum_i) C_i h.  The decay is taken as
    exp(where(j <= i, cum_i - cum_j, 0)) and then masked, as the JAX
    package's double where: the masked differences are positive and
    would overflow exp."""
    rep = x.shape[2] // Bm.shape[2]
    xf, dtf, bf, cum = _chunk_inputs(x, dt, A, Bm, rep)
    cf = Cm.float().repeat_interleave(rep, dim=2)
    Q = x.shape[1]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    diff = cum[:, :, None, :] - cum[:, None, :, :]              # [B, Qi, Qj, H]
    lmat = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    w = torch.einsum("bqhn,bkhn->bqkh", cf, bf) * lmat * dtf[:, None, :, :]
    y = torch.einsum("bqkh,bkhp->bqhp", w, xf)
    y = y + torch.einsum("bqhn,bhnp->bqhp", cf * torch.exp(cum)[..., None], h)
    return y, _chunk_state(h, xf, dtf, bf, cum)


def fold_chunks(t, chunk: int):
    """[B, L, ...] -> [B * L / chunk, chunk, ...]: chunks folded into the
    batch dim (a view of the model's column slices too)."""
    return t.reshape((t.shape[0] * (t.shape[1] // chunk), chunk)
                     + tuple(t.shape[2:]))


def ssd_chunk_states(x, dt, A, Bm, chunk: int):
    """The state entering each chunk, [B, L / chunk, H, N, P] float32 (the
    first is zero): every chunk's own contribution at once, with the
    chunks folded into the batch, then the carry h_{c+1} = exp(cum_last)
    h_c + S_c in order."""
    rep = check_ssd(x, dt, A, Bm, Bm)
    Bsz, L, H, P = x.shape
    nc, N = L // chunk, Bm.shape[-1]
    xf, dtf, bf, cum = _chunk_inputs(fold_chunks(x, chunk),
                                     fold_chunks(dt, chunk), A,
                                     fold_chunks(Bm, chunk), rep)
    zero = torch.zeros((Bsz * nc, H, N, P), dtype=torch.float32,
                       device=x.device)
    own = _chunk_state(zero, xf, dtf, bf, cum).reshape(Bsz, nc, H, N, P)
    decay = torch.exp(cum[:, -1]).reshape(Bsz, nc, H)[..., None, None]
    states = [torch.zeros_like(own[:, 0])]
    for c in range(nc - 1):
        states.append(decay[:, c] * states[-1] + own[:, c])
    return torch.stack(states, dim=1)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """The chunked SSD scan, the ``ssd_scan`` kernel's plain version and
    the port of the JAX package's ``models/mamba2.ssd_chunked``: the
    state entering each chunk from ``ssd_chunk_states``, then every chunk
    at once in the dual form of ``ssd_chunk``, the chunks folded into the
    batch.  L % chunk == 0.  ``ops.ssd_scan``'s backward differentiates
    this same function under autograd.

    Returns (y [B, L, H, P] in x's dtype, the final state h [B, H, N, P]
    float32, the state leaving the last chunk)."""
    check_ssd(x, dt, A, Bm, Cm)
    Bsz, L, H, P = x.shape
    if chunk < 1 or L % chunk:
        raise ValueError(f"L={L} not divisible by chunk={chunk}")
    nc, N = L // chunk, Bm.shape[-1]
    states = ssd_chunk_states(x, dt, A, Bm, chunk)
    y, h_out = ssd_chunk(states.reshape(Bsz * nc, H, N, P),
                         *(fold_chunks(t, chunk) for t in (x, dt)), A,
                         fold_chunks(Bm, chunk), fold_chunks(Cm, chunk))
    return (y.reshape(x.shape).to(x.dtype),
            h_out.reshape(Bsz, nc, H, N, P)[:, -1])


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
