"""pixtral-12b [hf:mistralai/Pixtral-12B-2409].

Language backbone = Mistral-Nemo-12B: 40L d_model=5120 32H (GQA kv=8,
head_dim=128) d_ff=14336 vocab=131072.  The Pixtral-ViT vision encoder +
projector is a STUB: ``input_specs`` feeds precomputed patch embeddings
for the first ``n_patch_tokens`` positions (assignment carve-out).
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab=131_072,
    head_dim=128,
    attn=AttnConfig(rope_theta=1_000_000.0),
    n_patch_tokens=1024,
    cut_layers=2,
    dtype="bfloat16",
    source="hf:mistralai/Pixtral-12B-2409",
)


def smoke() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab=512, n_patch_tokens=8, cut_layers=1, dtype="float32")
