"""whisper-base [arXiv:2212.04356]: encoder-decoder, conv front end stubbed.

6L encoder + 6L decoder, d_model=512 8H d_ff=2048 vocab=51865, tied
embeddings.  The mel-spectrogram and conv feature extractor is a stub:
the inputs are precomputed frame embeddings [B, 1500, 512].

Split-learning cut: the encoder is the client, the decoder the server.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51_865,
    head_dim=64,
    attn=AttnConfig(rope=False),
    enc_layers=6,
    enc_d_model=512,
    cut_layers=0,       # cut at the enc/dec boundary, not inside a stack
    tie_embeddings=True,
    dtype="bfloat16",
    source="arXiv:2212.04356",
)


def smoke() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, enc_layers=2, d_model=128, enc_d_model=128,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
        dtype="float32")
