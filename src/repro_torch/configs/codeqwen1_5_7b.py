"""codeqwen1.5-7b [dense]: qwen1.5 arch (MHA kv=32).

32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B; hf]

Copy of ``src/repro/configs/codeqwen1_5_7b.py``, dimension for dimension.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1e6,
    source="[hf:Qwen/CodeQwen1.5-7B; hf]",
)
