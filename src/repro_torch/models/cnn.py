"""The paper's LEAF FEMNIST CNN as a stage-list model.

Port of the ``femnist_cnn`` part of ``repro/models/cnn.py``.  Params and
activations keep the JAX package's layout at every stage boundary:
activations NHWC, conv weights HWIO, dense weights [d_in, d_out].  The
convolutions run NCHW inside ``conv2d``/``maxpool`` and permute back, so
the dense stage flattens in NHWC order and the smashed data at the cut
is NHWC, exactly as in the reference.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.models import module


# --------------------------------------------------------------- conv ops
def conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              dtype=torch.float32):
    fan_in = kh * kw * cin
    return {"w": module.truncated_normal(gen, (kh, kw, cin, cout),
                                         1.0 / math.sqrt(fan_in), dtype),
            "b": torch.zeros((cout,), dtype=dtype)}


def conv2d(params, x, stride: int = 1, padding: str = "SAME"):
    """NHWC input, HWIO weights -> NHWC output."""
    if padding == "SAME" and stride != 1:
        raise NotImplementedError("SAME padding is ported for stride 1 only")
    y = F.conv2d(x.permute(0, 3, 1, 2), params["w"].permute(3, 2, 0, 1),
                 params["b"], stride=stride, padding=padding.lower())
    return y.permute(0, 2, 3, 1)


def maxpool(x, k: int = 2, s: int = 2):
    """VALID max pooling over NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


# ------------------------------------------------------- stage-list models
class StageModel:
    """A model = ordered stages; stage i: (init_fn(gen) -> params, apply_fn).

    ``cut`` splits stages into client [0:cut] / server [cut:] — the
    paper's block-wise cut point.
    """

    def __init__(self, name: str, stages: Sequence[tuple[Callable, Callable]],
                 n_classes: int, head_is_linear: bool = False):
        self.name = name
        self.stages = list(stages)
        self.n_classes = n_classes
        self.n_stages = len(stages)
        # True iff the FINAL stage is a bias-free flatten-matmul
        # (``x.reshape(B, -1) @ w``), the contract that lets a last-cut
        # split expose the head to the fused gather + loss kernel
        self.head_is_linear = head_is_linear

    def init(self, gen: torch.Generator):
        return [init(gen) for init, _ in self.stages]

    def apply_range(self, params, x, lo: int, hi: int):
        for i in range(lo, hi):
            x = self.stages[i][1](params[i], x)
        return x

    def apply(self, params, x):
        return self.apply_range(params, x, 0, self.n_stages)


# ------------------------------------------------------------ LEAF FEMNIST
def femnist_cnn(n_classes: int = 62, width: int = 32) -> StageModel:
    """LEAF FEMNIST CNN (paper Table 11).  Input [B, 28, 28, 1].
    Cut in the middle (stage 2 of 4) matches the paper's setup."""
    w = width

    def s0_init(g):
        return {"conv": conv_init(g, 5, 5, 1, w)}

    def s0(p, x):
        return maxpool(torch.relu(conv2d(p["conv"], x)))

    def s1_init(g):
        return {"conv": conv_init(g, 5, 5, w, 2 * w)}

    def s1(p, x):
        return maxpool(torch.relu(conv2d(p["conv"], x)))

    def s2_init(g):
        return {"lin": {"w": module.dense_init(g, 7 * 7 * 2 * w, 2048)}}

    def s2(p, x):
        x = x.reshape(x.shape[0], -1)
        return torch.relu(x @ p["lin"]["w"])

    def s3_init(g):
        return {"lin": {"w": module.dense_init(g, 2048, n_classes)}}

    def s3(p, x):
        return x @ p["lin"]["w"]

    return StageModel("femnist_cnn", [(s0_init, s0), (s1_init, s1),
                                      (s2_init, s2), (s3_init, s3)], n_classes,
                      head_is_linear=True)
