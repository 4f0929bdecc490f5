"""grok-1-314b [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072; MoE 8 experts
top-2.  The JAX package shards the 8 experts' hidden dim on its mesh
(shard_mode='ffn'); on one card the mode is unused.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab=131_072,
    head_dim=128,
    attn=AttnConfig(rope_theta=10_000.0),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32_768,
                  shard_mode="ffn"),
    cut_layers=1,
    dtype="bfloat16",
    source="hf:xai-org/grok-1",
)


def smoke() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab=512, cut_layers=1, dtype="float32",
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, shard_mode="ffn"))
