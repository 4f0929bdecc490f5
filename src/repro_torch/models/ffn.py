"""Dense feed-forward blocks: SwiGLU (default) and the GeLU MLP
(whisper).  Port of ``repro/models/ffn.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import module
from repro_torch.sharding.parallel import copy_to_model, reduce_from_model


def swiglu_init(gen, d: int, f: int, dtype):
    return {
        "w_gate": module.dense_init(gen, d, f, dtype),
        "w_up": module.dense_init(gen, d, f, dtype),
        "w_down": module.dense_init(gen, f, d, dtype),
    }


def swiglu(params, x, tp=None, unit: str = "ffn"):
    """SwiGLU; tensor-parallel when ``tp`` splits ``unit`` (``w_gate`` and
    ``w_up`` column-parallel, ``w_down`` row-parallel, its partial sums
    reduced over the ``model`` axis)."""
    split = tp is not None and tp.on(unit)
    if split:
        x = copy_to_model(tp, x)
    g = F.silu(x @ params["w_gate"])
    y = (g * (x @ params["w_up"])) @ params["w_down"]
    return reduce_from_model(tp, y, unit) if split else y


def gelu_mlp_init(gen, d: int, f: int, dtype):
    return {
        "w_in": module.dense_init(gen, d, f, dtype),
        "b_in": torch.zeros((f,), dtype=dtype, device=gen.device),
        "w_out": module.dense_init(gen, f, d, dtype),
        "b_out": torch.zeros((d,), dtype=dtype, device=gen.device),
    }


def gelu_mlp(params, x, tp=None):
    """The GELU MLP; tensor-parallel when ``tp`` splits the ``ffn`` unit
    (``w_in`` and ``b_in`` column-parallel, ``w_out`` row-parallel, its
    partial sums reduced over the ``model`` axis, ``b_out`` added once,
    after the reduce)."""
    split = tp is not None and tp.on("ffn")
    if split:
        x = copy_to_model(tp, x)
    # jax.nn.gelu defaults to the tanh approximation; F.gelu to erf
    h = F.gelu(x @ params["w_in"] + params["b_in"], approximate="tanh")
    y = h @ params["w_out"]
    if split:
        y = reduce_from_model(tp, y, "ffn")
    return y + params["b_out"]
