"""Dense feed-forward block: SwiGLU.  Port of ``repro/models/ffn.py``
(the GeLU MLP comes with the port of the encoder-decoder family)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models import module


def swiglu_init(gen, d: int, f: int, dtype):
    return {
        "w_gate": module.dense_init(gen, d, f, dtype),
        "w_up": module.dense_init(gen, d, f, dtype),
        "w_down": module.dense_init(gen, f, d, dtype),
    }


def swiglu(params, x):
    g = F.silu(x @ params["w_gate"])
    return (g * (x @ params["w_up"])) @ params["w_down"]
