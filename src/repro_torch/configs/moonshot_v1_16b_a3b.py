"""moonshot-v1-16b-a3b — Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (GQA kv=16) vocab=163840; MoE 64 experts top-6 with
d_ff_expert=1408 and 2 shared experts (DeepSeek-V3-style).  Assignment
tag: [dense] (dense attention + MoE FFN).
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="dense",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163_840,
    head_dim=128,
    attn=AttnConfig(rope_theta=50_000.0),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared_experts=2, shard_mode="expert"),
    cut_layers=2,
    dtype="bfloat16",
    source="hf:moonshotai/Moonlight-16B-A3B",
)


def smoke() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=128, vocab=512, cut_layers=1, dtype="float32",
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128,
                      n_shared_experts=1, shard_mode="expert"))
