"""Architecture / input-shape config dataclasses.

Port of ``repro/configs/base.py`` as pure data: every config module
exports ``CONFIG: ArchConfig`` with the published hyper-parameters (its
source in the module docstring) plus ``smoke()``, a reduced variant for
the CPU tests.  ``ArchConfig.torch_dtype`` replaces ``jnp_dtype``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass(frozen=True)
class AttnConfig:
    """Attention hyper-parameters (GQA + RoPE + gemma2 extras)."""

    rope: bool = True               # whisper uses learned abs. positions
    rope_theta: float = 10_000.0
    logit_softcap: Optional[float] = None        # gemma2: 50.0 on attn logits
    final_softcap: Optional[float] = None        # gemma2: 30.0 on lm logits
    window: Optional[int] = None                 # sliding-window size (local attn)
    # 'global' | 'local' | 'local_global' (gemma2 alternating, even=local)
    pattern: str = "global"
    qk_norm: bool = False


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0            # per-expert hidden dim
    capacity_factor: float = 1.25
    router_z_weight: float = 1e-3   # router z-loss
    aux_weight: float = 1e-2        # load-balance aux loss
    n_shared_experts: int = 0       # moonshot/deepseek-style always-on experts
    # the JAX package's expert-dim sharding on its mesh ('expert' or
    # 'ffn'); kept so configs carry across, unused on one card
    shard_mode: str = "expert"
    group_size: int = 4096          # dispatch group (tokens) to bound buffers


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block hyper-parameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256                # SSD chunk length
    # hybrid (zamba2): block indices after which the shared attention
    # block is applied; empty for pure SSM
    shared_attn_positions: tuple[int, ...] = ()


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    attn: AttnConfig = field(default_factory=AttnConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # split-learning cut: number of transformer blocks on the client side
    # (embedding is always client-side; final norm + head always server-side)
    cut_layers: int = 2
    dtype: str = "float32"
    # enc-dec (whisper): encoder depth/width (decoder uses the main fields)
    enc_layers: int = 0
    enc_d_model: int = 0
    # vlm: number of prefix patch-embedding positions fed by the stub
    n_patch_tokens: int = 0
    # serving: sliding-window override used for the long_500k carve-out
    long_context_window: int = 16_384
    tie_embeddings: bool = False
    sandwich_norm: bool = False     # gemma2 pre+post block norms
    norm_eps: float = 1e-5
    source: str = ""                # citation

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Embedding/head vocab padded to a multiple of 128, as in the
        JAX package (the padded columns are masked in the loss)."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs)."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab, self.hd
        qkv = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + self.n_heads * hd * d
        per_layer = qkv + 2 * d  # attn + norms
        if self.moe is not None:
            per_layer += self.moe.n_experts * 3 * d * self.moe.d_ff_expert
            per_layer += d * self.moe.n_experts  # router
        elif self.ssm is not None and self.family in ("ssm", "hybrid"):
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            per_layer = (d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state + nh)
                         + di * self.ssm.d_conv + di * d + 2 * d)
        if f and self.moe is None and self.family not in ("ssm", "hybrid"):
            per_layer += 3 * d * f  # swiglu
        total = self.n_layers * per_layer + v * d + d
        if self.family == "hybrid":
            # one SHARED attention+ffn block (zamba2), counted once
            total += qkv + 3 * d * f
        if not self.tie_embeddings:
            total += v * d
        if self.enc_layers:
            ed = self.enc_d_model or d
            total += self.enc_layers * (4 * ed * ed + 2 * ed * self.d_ff + 2 * ed)
        return int(total)

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top_k experts; zamba2: the
        shared block once per application site)."""
        full = self.n_params()
        d = self.d_model
        if self.family == "hybrid" and self.ssm is not None:
            n_apps = len(self.ssm.shared_attn_positions)
            hd = self.hd
            qkv = (d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads
                   + self.n_heads * hd * d)
            shared = qkv + 3 * d * self.d_ff
            return int(full + (n_apps - 1) * shared)
        if self.moe is None:
            return full
        moe_all = self.n_layers * self.moe.n_experts * 3 * d * self.moe.d_ff_expert
        moe_act = self.n_layers * self.moe.top_k * 3 * d * self.moe.d_ff_expert
        return int(full - moe_all + moe_act)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
