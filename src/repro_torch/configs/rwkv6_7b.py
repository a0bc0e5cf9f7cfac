"""RWKV-6 (Finch) 7B — attention-free, data-dependent decay
[arXiv:2404.05892].  head size 64 -> 64 heads at d_model 4096."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=0, d_ff=14336,
    vocab_size=65536, head_dim=64, ssm_head_dim=64,
)
