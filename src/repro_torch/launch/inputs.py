"""Shapes of every model input, and batches of them drawn from a seed.

Port of ``repro/launch/inputs.py``.  The specs are plain (shape, dtype)
pairs where the JAX package has ``ShapeDtypeStruct``s; the batch makers
draw numpy arrays from ``np.random.default_rng(seed)``, so both packages
can be fed one batch.

Modality stubs:
  * vlm   — ``patch_embeds`` [B, n_patch_tokens, d] precomputed patch
            embeddings (vision encoder + projector stubbed);
  * audio — ``frames`` [B, 1500, d] precomputed conv/mel frame
            embeddings (whisper's front end stubbed), with the decoder's
            ``tokens`` and ``labels`` at most 448 positions long.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape


WHISPER_FRAMES = 1500
WHISPER_TEXT_CAP = 448      # whisper decoder positional horizon


class Spec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def train_batch_specs(cfg: ArchConfig, shape: InputShape, cohort: int):
    """(xs, ys) cohort-stacked batch specs [C, b, ...] for the CycleSL
    train step."""
    if shape.global_batch % cohort:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into a cohort of {cohort}")
    b = shape.global_batch // cohort
    if cfg.family == "audio":
        s = min(shape.seq_len, WHISPER_TEXT_CAP)
        xs = {"frames": Spec((cohort, b, WHISPER_FRAMES, cfg.enc_d_model),
                             cfg.torch_dtype)}
        ys = {"tokens": Spec((cohort, b, s), torch.int32),
              "labels": Spec((cohort, b, s), torch.int32)}
        return xs, ys
    xs = {"tokens": Spec((cohort, b, shape.seq_len), torch.int32)}
    if cfg.family == "vlm":
        xs["patch_embeds"] = Spec((cohort, b, cfg.n_patch_tokens, cfg.d_model),
                                  cfg.torch_dtype)
    ys = Spec((cohort, b, shape.seq_len), torch.int32)
    return xs, ys


def prefill_specs(cfg: ArchConfig, shape: InputShape):
    B = shape.global_batch
    if cfg.family == "audio":
        s = min(shape.seq_len, WHISPER_TEXT_CAP)
        return {"frames": Spec((B, WHISPER_FRAMES, cfg.enc_d_model),
                               cfg.torch_dtype),
                "tokens": Spec((B, s), torch.int32)}
    out = {"tokens": Spec((B, shape.seq_len), torch.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = Spec((B, cfg.n_patch_tokens, cfg.d_model),
                                   cfg.torch_dtype)
    return out


def decode_token_spec(cfg: ArchConfig, shape: InputShape):
    """The decode step's token input [B, 1]."""
    return Spec((shape.global_batch, 1), torch.int32)


def _draw(rng, cfg: ArchConfig, specs: dict, labels: bool = False):
    """Tokens uniform over the vocab (one position longer when next-token
    labels are wanted), patch embeddings and audio frames standard
    normal in float32.  Returns the drawn dict, and with ``labels`` the
    next tokens too."""
    tok_shape = specs["tokens"].shape
    n = tok_shape[-1] + labels
    stream = rng.integers(0, cfg.vocab, size=tok_shape[:-1] + (n,),
                          dtype=np.int32)
    out = {"tokens": stream[..., :tok_shape[-1]]}
    for name in ("patch_embeds", "frames"):
        if name in specs:
            out[name] = rng.standard_normal(specs[name].shape).astype(
                np.float32)
    if not labels:
        return out
    return out, stream[..., 1:]


def make_train_batch(cfg: ArchConfig, shape: InputShape, cohort: int,
                     seed: int):
    """Numpy (xs, ys) of ``train_batch_specs``: ys are the next tokens of
    xs["tokens"].  For audio, xs is ``{"frames"}`` and ys the decoder's
    ``{"tokens", "labels"}``, labels the next tokens."""
    xs, ys = train_batch_specs(cfg, shape, cohort)
    if cfg.family == "audio":
        drawn, labels = _draw(np.random.default_rng(seed), cfg,
                              {**xs, "tokens": ys["tokens"]}, labels=True)
        return ({"frames": drawn["frames"]},
                {"tokens": drawn["tokens"], "labels": labels})
    return _draw(np.random.default_rng(seed), cfg, xs, labels=True)


def make_prefill_batch(cfg: ArchConfig, shape: InputShape, seed: int):
    """Numpy batch of ``prefill_specs``."""
    return _draw(np.random.default_rng(seed), cfg, prefill_specs(cfg, shape))


def meta_batch(specs):
    """Empty ``meta`` tensors of a spec tree (a Spec, a dict or a tuple
    of them): the shapes a dry run traces, with no draw."""
    if isinstance(specs, Spec):
        return torch.empty(specs.shape, dtype=specs.dtype, device="meta")
    if isinstance(specs, dict):
        return {k: meta_batch(v) for k, v in specs.items()}
    return tuple(meta_batch(v) for v in specs)


def to_device(batch, cfg: ArchConfig, device):
    """A numpy batch tree -> tensors on ``device``: token ids int32,
    patch embeddings and frames in the model's dtype."""
    def one(a):
        if isinstance(a, torch.Tensor):        # a meta batch: as it is
            return a
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.is_floating_point():
            t = t.to(cfg.torch_dtype)
        return t.to(device)
    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)
