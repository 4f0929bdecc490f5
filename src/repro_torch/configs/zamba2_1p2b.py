"""zamba2-1.2b [arXiv:2411.15242] — Mamba2 backbone + shared attention.

38 mamba2 blocks, d_model=2048, ssm_state=64; ONE shared transformer
block (32H attention + d_ff=8192 SwiGLU) applied at two interleave
points (we use block indices 12 and 25), vocab=32000.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32_000,
    head_dim=64,
    attn=AttnConfig(rope_theta=10_000.0),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256, shared_attn_positions=(12, 25)),
    cut_layers=4,
    tie_embeddings=True,
    dtype="bfloat16",
    source="arXiv:2411.15242",
)


def smoke() -> ArchConfig:
    return CONFIG.with_(
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab=512, cut_layers=1, dtype="float32",
        ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=32,
                      n_groups=1, chunk=32, shared_attn_positions=(1,)))
