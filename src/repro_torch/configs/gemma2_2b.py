"""gemma2-2b [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000.
Alternating local(4096-window)/global attention, logit softcap 50 /
final softcap 30, sandwich (pre+post) norms, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab=256_000,
    head_dim=256,
    attn=AttnConfig(rope_theta=10_000.0, logit_softcap=50.0,
                    final_softcap=30.0, window=4096, pattern="local_global"),
    cut_layers=2,       # one local/global pair (period=2)
    tie_embeddings=True,
    sandwich_norm=True,
    dtype="bfloat16",
    source="arXiv:2408.00118",
)


def smoke() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab=512, cut_layers=2, dtype="float32",
        attn=AttnConfig(logit_softcap=50.0, final_softcap=30.0,
                        window=16, pattern="local_global"))
