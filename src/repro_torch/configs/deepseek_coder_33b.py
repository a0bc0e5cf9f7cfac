"""DeepSeek-Coder 33B — dense llama-arch [arXiv:2401.14196].

56 heads is not divisible by the 16-way model axis; heads are padded to 64
for tensor parallelism (head_pad_to=16, see DESIGN.md §4).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
    vocab_size=32256, head_dim=128, rope_theta=100000.0, head_pad_to=16,
)
