"""InternVL2-2B — VLM: InternViT frontend (stub) + InternLM2-1.8B backbone
[arXiv:2404.16821].  input_specs() feeds precomputed patch embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92553, head_dim=128, rope_theta=1000000.0,
    n_patches=256, frontend_stub=True,
)
