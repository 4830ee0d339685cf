"""Model zoo registry: family -> model class.

Port of ``src/repro/models/__init__.py`` for the transformer families.
The state-space families wait for ROADMAP module item 12b: ``get_model``
raises for them, naming the item.
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerModel

_FAMILIES = {
    "dense": TransformerModel,
    "moe": TransformerModel,
    "audio": TransformerModel,   # encoder backbone; stub frontend
    "vlm": TransformerModel,     # decoder backbone; stub frontend
}

# what is left out of this slice, by the ROADMAP module item that ports it
NOT_PORTED = {
    "ssm": "the state-space models (models/mamba2.py, rwkv6.py) are ROADMAP "
           "module item 12b",
    "hybrid": "the hybrid model (models/zamba2.py, Mamba2 with shared "
              "attention) is ROADMAP module item 12b",
}


def get_model(cfg: ArchConfig, device=None):
    """The model of ``cfg``'s family on ``device`` (CUDA by default; raises
    without a card), without weights: call ``init`` or load them."""
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {NOT_PORTED[cfg.family]}")
    return _FAMILIES[cfg.family](cfg, device=device)


__all__ = ["NOT_PORTED", "TransformerModel", "get_model"]
