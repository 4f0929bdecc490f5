"""phi3-mini-3.8b [arXiv:2404.14219].

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064, RoPE + SwiGLU.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32_064,
    head_dim=96,
    attn=AttnConfig(rope_theta=10_000.0),
    cut_layers=2,
    dtype="bfloat16",
    source="arXiv:2404.14219",
)


def smoke() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab=512, cut_layers=1, dtype="float32")
