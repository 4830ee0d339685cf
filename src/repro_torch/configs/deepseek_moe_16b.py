"""deepseek-moe-16b [moe]: fine-grained experts, 2 shared + 64 routed top-6.

28L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=102400
[arXiv:2401.06066; hf]

Copy of ``src/repro/configs/deepseek_moe_16b.py``, dimension for dimension.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                 # per-expert intermediate
    vocab_size=102400,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    rope_theta=1e4,
    source="[arXiv:2401.06066; hf]",
)
