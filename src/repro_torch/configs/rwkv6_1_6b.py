"""rwkv6-1.6b [ssm]: Finch — attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536 [arXiv:2404.05892; unverified]

Copy of ``src/repro/configs/rwkv6_1_6b.py``, dimension for dimension.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,              # time-mix heads (d_model / ssm_head_dim)
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    ssm_state=0,               # 0 => RWKV6 (matrix state), not Mamba2
    ssm_head_dim=64,
    rope_theta=0.0,            # attention-free
    source="[arXiv:2404.05892; unverified]",
)
