"""olmoe-1b-7b [arXiv:2409.02060].

16L d_model=2048 16H (GQA kv=16) vocab=50304; MoE 64 experts top-8,
d_ff_expert=1024, qk-norm.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50_304,
    head_dim=128,
    attn=AttnConfig(rope_theta=10_000.0, qk_norm=True),
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024,
                  shard_mode="expert"),
    cut_layers=2,
    dtype="bfloat16",
    source="arXiv:2409.02060",
)


def smoke() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=128, vocab=512, cut_layers=1, dtype="float32",
        attn=AttnConfig(qk_norm=True),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128,
                      shard_mode="expert"))
