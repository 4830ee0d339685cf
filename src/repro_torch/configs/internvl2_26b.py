"""internvl2-26b [vlm]: InternLM2-20B language backbone (InternViT stubbed).

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf]
Vision frontend is a STUB per assignment: input_specs() provides precomputed
patch embeddings (B, S, d_model) for train/prefill.

Copy of ``src/repro/configs/internvl2_26b.py``, dimension for dimension.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    embedding_input=True,
    rope_theta=1e6,
    source="[arXiv:2404.16821; hf]",
)
