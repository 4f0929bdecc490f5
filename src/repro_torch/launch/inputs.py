"""Shapes of every model input, and batches of them drawn from a seed.

Port of ``repro/launch/inputs.py``.  The specs are plain (shape, dtype)
pairs where the JAX package has ``ShapeDtypeStruct``s; the batch makers
draw numpy arrays from ``np.random.default_rng(seed)``, so both packages
can be fed one batch.

Modality stub: vlm feeds ``patch_embeds`` [B, n_patch_tokens, d],
precomputed patch embeddings (vision encoder + projector stubbed).  The
audio (whisper) inputs come with the port of the encoder-decoder family.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape


class Spec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def _no_audio(cfg: ArchConfig):
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: audio inputs are not ported yet: they come with "
            f"the port of the encoder-decoder family")


def train_batch_specs(cfg: ArchConfig, shape: InputShape, cohort: int):
    """(xs, ys) cohort-stacked batch specs [C, b, ...] for the CycleSL
    train step."""
    _no_audio(cfg)
    if shape.global_batch % cohort:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into a cohort of {cohort}")
    b = shape.global_batch // cohort
    xs = {"tokens": Spec((cohort, b, shape.seq_len), torch.int32)}
    if cfg.family == "vlm":
        xs["patch_embeds"] = Spec((cohort, b, cfg.n_patch_tokens, cfg.d_model),
                                  cfg.torch_dtype)
    ys = Spec((cohort, b, shape.seq_len), torch.int32)
    return xs, ys


def prefill_specs(cfg: ArchConfig, shape: InputShape):
    _no_audio(cfg)
    B = shape.global_batch
    out = {"tokens": Spec((B, shape.seq_len), torch.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = Spec((B, cfg.n_patch_tokens, cfg.d_model),
                                   cfg.torch_dtype)
    return out


def decode_token_spec(cfg: ArchConfig, shape: InputShape):
    """The decode step's token input [B, 1]."""
    _no_audio(cfg)
    return Spec((shape.global_batch, 1), torch.int32)


def _draw(rng, cfg: ArchConfig, specs: dict, labels_shape=None):
    """Tokens uniform over the vocab (one position longer when next-token
    labels are wanted), patch embeddings standard normal in float32."""
    tok_shape = specs["tokens"].shape
    n = tok_shape[-1] + (labels_shape is not None)
    stream = rng.integers(0, cfg.vocab, size=tok_shape[:-1] + (n,),
                          dtype=np.int32)
    out = {"tokens": stream[..., :tok_shape[-1]]}
    if "patch_embeds" in specs:
        out["patch_embeds"] = rng.standard_normal(
            specs["patch_embeds"].shape).astype(np.float32)
    if labels_shape is None:
        return out
    return out, stream[..., 1:]


def make_train_batch(cfg: ArchConfig, shape: InputShape, cohort: int,
                     seed: int):
    """Numpy (xs, ys) of ``train_batch_specs``: ys are the next tokens of
    xs["tokens"]."""
    xs, ys = train_batch_specs(cfg, shape, cohort)
    return _draw(np.random.default_rng(seed), cfg, xs, ys.shape)


def make_prefill_batch(cfg: ArchConfig, shape: InputShape, seed: int):
    """Numpy batch of ``prefill_specs``."""
    return _draw(np.random.default_rng(seed), cfg, prefill_specs(cfg, shape))


def to_device(batch, cfg: ArchConfig, device):
    """A numpy batch tree -> tensors on ``device``: token ids int32,
    patch embeddings in the model's dtype."""
    def one(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.is_floating_point():
            t = t.to(cfg.torch_dtype)
        return t.to(device)
    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)
