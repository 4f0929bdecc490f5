"""glm4-9b [hf:THUDM/glm-4-9b].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552, RoPE.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13_696,
    vocab=151_552,
    head_dim=128,
    attn=AttnConfig(rope_theta=10_000.0),
    cut_layers=2,
    dtype="bfloat16",
    source="hf:THUDM/glm-4-9b",
)


def smoke() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab=512, cut_layers=1, dtype="float32")
