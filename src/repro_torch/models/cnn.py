"""The paper's own model zoo as stage-list models: the LEAF FEMNIST and
CelebA CNNs, ResNet9 and the gaze MLP.

Port of ``repro/models/cnn.py``.  Params and activations keep the JAX
package's layout at every stage boundary: activations NHWC, conv
weights HWIO, dense weights [d_in, d_out].  The convolutions run NCHW
inside ``conv2d``/``maxpool``/``batchnorm`` and permute back, so a
dense stage flattens in NHWC order and the smashed data at the cut is
NHWC, exactly as in the reference.

On a mesh's ``model`` axis (``tp``, a ``sharding.parallel.TensorParallel``)
a dense stage's ``lin/w`` [d_in, n_out] is column-parallel where its
columns divide the axis (:func:`dense`): the rank holds its block of
columns, multiplies it and gathers the product's columns before the
next stage or the loss.  Conv, BatchNorm and pool stages run whole.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.models import module
from repro_torch.sharding.parallel import copy_to_model, gather_from_model


# --------------------------------------------------------------- conv ops
def conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              dtype=torch.float32):
    fan_in = kh * kw * cin
    return {"w": module.truncated_normal(gen, (kh, kw, cin, cout),
                                         1.0 / math.sqrt(fan_in), dtype),
            "b": torch.zeros((cout,), dtype=dtype)}


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: ceil(size / stride)
    outputs, the total pad split with the smaller half before."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(params, x, stride: int = 1, padding: str = "SAME"):
    """NHWC input, HWIO weights -> NHWC output.  torch's ``"same"`` takes
    stride 1 only, so a strided SAME convolution pads explicitly."""
    xc = x.permute(0, 3, 1, 2)
    w = params["w"].permute(3, 2, 0, 1)
    pad = padding.lower()
    if padding == "SAME" and stride != 1:
        (t, b), (l, r) = (_same_pads(x.shape[1], w.shape[2], stride),
                          _same_pads(x.shape[2], w.shape[3], stride))
        xc, pad = F.pad(xc, (l, r, t, b)), 0
    y = F.conv2d(xc, w, params["b"], stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def maxpool(x, k: int = 2, s: int = 2):
    """VALID max pooling over NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


def batchnorm_init(c: int):
    return {"scale": torch.ones((c,)), "bias": torch.zeros((c,))}


def batchnorm(params, x, eps: float = 1e-5):
    """Batch-statistics norm over axes (0, 1, 2) of NHWC with the biased
    variance, in training and evaluation alike (SL benchmarks always
    train; there are no running statistics).  A constant channel, as in
    an all-zero padded slot, gives its ``bias``."""
    y = F.batch_norm(x.permute(0, 3, 1, 2), None, None, params["scale"],
                     params["bias"], training=True, eps=eps)
    return y.permute(0, 2, 3, 1)


def dense(w, x, n_out: int, tp=None):
    """``x @ w`` for a ``lin/w`` of ``n_out`` columns.  Where ``tp``
    splits its columns (``tp.splits(n_out)``), ``w`` is this rank's
    block of them: the input's gradient is summed over the axis
    (``copy_to_model``) and the product's columns are gathered in rank
    order (``gather_from_model``), so the stage's output is whole."""
    if tp is None or not tp.splits(n_out):
        return x @ w
    return gather_from_model(tp, copy_to_model(tp, x) @ w, "act", dim=-1)


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

    def apply_stage(self, i: int, p, x, tp=None):
        """Stage ``i`` on its params ``p``; a dense stage (its params
        hold ``lin``) takes the model axis ``tp``."""
        fn = self.stages[i][1]
        if tp is not None and isinstance(p, dict) and "lin" in p:
            return fn(p, x, tp)
        return fn(p, x)

    def apply_range(self, params, x, lo: int, hi: int, tp=None):
        for i in range(lo, hi):
            x = self.apply_stage(i, params[i], x, tp)
        return x

    def apply(self, params, x, tp=None):
        return self.apply_range(params, x, 0, self.n_stages, tp)


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

    def s2(p, x, tp=None):
        x = x.reshape(x.shape[0], -1)
        return torch.relu(dense(p["lin"]["w"], x, 2048, tp))

    def s3_init(g):
        return {"lin": {"w": module.dense_init(g, 2048, n_classes)}}

    def s3(p, x, tp=None):
        return dense(p["lin"]["w"], x, n_classes, tp)

    return StageModel("femnist_cnn", [(s0_init, s0), (s1_init, s1),
                                      (s2_init, s2), (s3_init, s3)], n_classes,
                      head_is_linear=True)


# ------------------------------------------------------------- LEAF CelebA
def celeba_cnn(n_classes: int = 2, width: int = 32, img: int = 84) -> StageModel:
    """LEAF CelebA CNN (paper Table 13): 4 conv-bn-pool stages + head.
    Input [B, img, img, 3]; cut after stage 1 (paper: middle)."""
    w = width

    def conv_stage_init(cin, cout):
        def init(g):
            return {"conv": conv_init(g, 3, 3, cin, cout),
                    "bn": batchnorm_init(cout)}
        return init

    def conv_stage(p, x):
        x = conv2d(p["conv"], x)
        x = batchnorm(p["bn"], x)
        return torch.relu(maxpool(x))     # pool, then ReLU

    final_hw = img // 16

    def head_init(g):
        return {"lin": {"w": module.dense_init(g, final_hw * final_hw * w,
                                               n_classes)}}

    def head(p, x, tp=None):
        return dense(p["lin"]["w"], x.reshape(x.shape[0], -1), n_classes,
                     tp)

    stages = [(conv_stage_init(3, w), conv_stage)]
    for _ in range(3):
        stages.append((conv_stage_init(w, w), conv_stage))
    stages.append((head_init, head))
    return StageModel("celeba_cnn", stages, n_classes, head_is_linear=True)


# ----------------------------------------------------------------- ResNet9
def bias_before_batchnorm(path: tuple) -> bool:
    """Whether a key path of a ``celeba_cnn``/``resnet9`` tree (params or
    an Adam moment over them) ends at a conv bias that a BatchNorm
    follows.  The norm removes any per-channel constant, so that bias's
    exact gradient is 0 and nothing downstream sees it: training steps
    it on rounding noise (Adam makes that +-lr of a random sign), and
    two runs that sum in other orders need not agree on it."""
    return (len(path) >= 2 and path[-1] == "b"
            and path[-2] in ("conv", "c1", "c2"))


def resnet9(n_classes: int = 100, width: int = 64, img: int = 32) -> StageModel:
    """ResNet9 (paper Table 4 ablation: 4 conv blocks, 2 residual blocks,
    1 head = 6 cut positions).  Input [B, img, img, 3]."""
    w = width

    def convblock_init(cin, cout):
        def init(g):
            return {"conv": conv_init(g, 3, 3, cin, cout),
                    "bn": batchnorm_init(cout)}
        return init

    def convblock(pool, p, x):
        x = torch.relu(batchnorm(p["bn"], conv2d(p["conv"], x)))
        return maxpool(x) if pool else x  # ReLU, then pool

    def resblock_init(c):
        def init(g):
            c1 = conv_init(g, 3, 3, c, c)
            c2 = conv_init(g, 3, 3, c, c)
            return {"c1": c1, "b1": batchnorm_init(c),
                    "c2": c2, "b2": batchnorm_init(c)}
        return init

    def resblock(p, x):
        h = torch.relu(batchnorm(p["b1"], conv2d(p["c1"], x)))
        h = torch.relu(batchnorm(p["b2"], conv2d(p["c2"], h)))
        return x + h

    def head_init(g):
        return {"lin": {"w": module.dense_init(g, 8 * w, n_classes)}}

    def head(p, x, tp=None):
        # global max pool; amax splits a tie's gradient evenly, as JAX does
        x = torch.amax(x, dim=(1, 2))
        return dense(p["lin"]["w"], x, n_classes, tp)

    stages = [
        (convblock_init(3, w), partial(convblock, False)),          # conv1
        (convblock_init(w, 2 * w), partial(convblock, True)),       # conv2
        (resblock_init(2 * w), resblock),                           # res1
        (convblock_init(2 * w, 4 * w), partial(convblock, True)),   # conv3
        (convblock_init(4 * w, 8 * w), partial(convblock, True)),   # conv4
        (resblock_init(8 * w), resblock),                           # res2
        (head_init, head),                                          # head
    ]
    return StageModel("resnet9", stages, n_classes)


# -------------------------------------------------------------------- MLP
def mlp(d_in: int, hidden: Sequence[int], d_out: int) -> StageModel:
    """Generic MLP (gaze-estimator head analog / quick tasks)."""
    dims = [d_in] + list(hidden)

    def lin_init(a, b):
        def init(g):
            return {"w": module.dense_init(g, a, b)}
        return init

    def lin(act, p, x):
        y = x.reshape(x.shape[0], -1) @ p["w"]
        return torch.relu(y) if act else y

    stages = [(lin_init(a, b), partial(lin, True))
              for a, b in zip(dims[:-1], dims[1:])]
    stages.append((lin_init(dims[-1], d_out), partial(lin, False)))
    return StageModel("mlp", stages, d_out, head_is_linear=True)
