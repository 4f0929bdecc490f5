"""mamba2-2.7b [arXiv:2405.21060] — SSD (state-space duality).

64L d_model=2560, attention-free, ssm_state=128, vocab=50280.
d_inner = 2*2560 = 5120, head_dim 64 -> 80 SSD heads.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,          # attention-free; SSD heads live in SSMConfig
    n_kv_heads=1,
    d_ff=0,
    vocab=50_280,
    attn=AttnConfig(),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    cut_layers=4,
    tie_embeddings=True,
    dtype="bfloat16",
    source="arXiv:2405.21060",
)


def smoke() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, vocab=512, cut_layers=1, dtype="float32",
        ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=32,
                      n_groups=1, chunk=32))
