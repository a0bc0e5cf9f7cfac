"""SeamlessM4T-large v2 — encoder-decoder, multimodal [arXiv:2308.11596].
Speech frontend is a stub: input_specs() provides precomputed frame
embeddings (B, enc_len, d)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206, head_dim=64, frontend_stub=True,
)
