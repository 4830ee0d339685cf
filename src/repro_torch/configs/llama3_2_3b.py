"""llama3.2-3b [dense]: small llama3, GQA kv=8.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B; unverified]

Copy of ``src/repro/configs/llama3_2_3b.py``, dimension for dimension.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=5e5,
    source="[hf:meta-llama/Llama-3.2-1B; unverified]",
)
