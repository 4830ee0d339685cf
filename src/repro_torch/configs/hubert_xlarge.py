"""hubert-xlarge [audio]: encoder-only, wav2vec2-style backbone.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 [arXiv:2106.07447; unverified]
Modality frontend (conv feature extractor) is a STUB per assignment:
input_specs() provides precomputed frame embeddings (B, S, d_model).

Copy of ``src/repro/configs/hubert_xlarge.py``, dimension for dimension.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,            # masked-unit prediction targets
    causal=False,              # bidirectional encoder: no decode shapes
    embedding_input=True,
    rope_theta=1e4,
    source="[arXiv:2106.07447; unverified]",
)
