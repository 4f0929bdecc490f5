"""LEAF Shakespeare LSTM (paper Table 12) as a StageModel.

Port of ``repro/models/lstm.py``.  Stage layout mirrors the paper's
cut: embeddings + LSTM cells on the client, projection head on the
server (cut = 2).  The JAX package scans the cell in plain jnp, so the
port runs plain torch ops: one input projection for every step, then a
loop over the steps for the recurrent product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import module
from repro_torch.models.cnn import StageModel


def _lstm_cell_init(gen: torch.Generator, d_in: int, d_h: int):
    return {
        "w_x": module.dense_init(gen, d_in, 4 * d_h),
        "w_h": module.dense_init(gen, d_h, 4 * d_h),
        "b": torch.zeros((4 * d_h,)),
    }


def _lstm_layer(params, x):
    """x [B, S, d_in] -> hidden sequence [B, S, d_h]; gates (i, f, g, o)
    in that order along the 4 d_h axis, as the reference splits them."""
    B, S = x.shape[:2]
    d_h = params["w_h"].shape[0]
    zx = x @ params["w_x"] + params["b"]
    h = c = torch.zeros((B, d_h), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(S):
        z = torch.addmm(zx[:, t], h, params["w_h"])
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def shakespeare_lstm(vocab: int = 80, d_embed: int = 8,
                     d_h: int = 256, n_lstm: int = 2) -> StageModel:
    """Stages: [embed, lstm-stack, head].  Cut=2 keeps embed+LSTM on the
    client, the linear head on the server: the paper's Shakespeare cut."""

    def emb_init(g):
        return {"table": module.embed_init(g, vocab, d_embed)}

    def emb(p, ids):
        return F.embedding(ids, p["table"])

    def lstm_init(g):
        return {"cells": [
            _lstm_cell_init(g, d_embed if i == 0 else d_h, d_h)
            for i in range(n_lstm)]}

    def lstm(p, x):
        for cell in p["cells"]:
            x = _lstm_layer(cell, x)
        return x[:, -1]                     # last hidden state

    def head_init(g):
        return {"w": module.dense_init(g, d_h, vocab)}

    def head(p, x):
        return x @ p["w"]

    return StageModel("shakespeare_lstm",
                      [(emb_init, emb), (lstm_init, lstm), (head_init, head)],
                      vocab)
