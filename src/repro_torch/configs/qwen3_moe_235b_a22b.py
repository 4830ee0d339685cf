"""qwen3-moe-235b-a22b [moe]: 128 experts, top-8.

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936
[hf:Qwen/Qwen3-30B-A3B; hf]

Copy of ``src/repro/configs/qwen3_moe_235b_a22b.py``, dimension for dimension.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                 # per-expert intermediate
    vocab_size=151936,
    num_experts=128,
    num_experts_per_tok=8,
    rope_theta=1e6,
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
)
