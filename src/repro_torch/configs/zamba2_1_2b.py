"""zamba2-1.2b [hybrid]: Mamba2 backbone + 2 shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]

Copy of ``src/repro/configs/zamba2_1_2b.py``, dimension for dimension.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,                 # shared-block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,       # 6 shared-attention sites over 38 blocks
    num_shared_attn_blocks=2,  # A/B round-robin, weights shared across sites
    source="[arXiv:2411.15242; hf]",
)
