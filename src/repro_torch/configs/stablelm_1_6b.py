"""stablelm-1.6b [dense].

24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352
[hf:stabilityai/stablelm-2-1_6b; unverified]

Copy of ``src/repro/configs/stablelm_1_6b.py``, dimension for dimension.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    rope_theta=1e4,
    source="[hf:stabilityai/stablelm-2-1_6b; unverified]",
)
