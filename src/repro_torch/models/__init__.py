"""Model zoo registry: family -> model class.

Port of ``src/repro/models/__init__.py``.  Every model has the same API
(``init``/``forward``/``init_cache``/``prefill``/``decode``/
``cache_specs``/``param_logical_axes``/``cache_logical_axes``), so the
training and serving steps and the launchers are arch-agnostic.
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.models.mamba2 import Mamba2Model
from repro_torch.models.rwkv6 import RWKV6Model
from repro_torch.models.transformer import TransformerModel
from repro_torch.models.zamba2 import Zamba2Model

_FAMILIES = {
    "dense": TransformerModel,
    "moe": TransformerModel,
    "audio": TransformerModel,   # encoder backbone; stub frontend
    "vlm": TransformerModel,     # decoder backbone; stub frontend
    "ssm": None,                 # resolved below per ssm kind
    "hybrid": Zamba2Model,
}

# the families left out of the port, by the ROADMAP module item that ports
# them: none since item 12b
NOT_PORTED: dict = {}


def get_model(cfg: ArchConfig, device=None, shard_ec=None,
              weight_gather=None, shard_assign=None):
    """The model of ``cfg``'s family on ``device`` (CUDA by default; raises
    without a card), without weights: call ``init`` or load them.  The
    hooks are the reference's (``models.base.ZooModel``)."""
    if cfg.family == "ssm":
        cls = Mamba2Model if cfg.ssm_state else RWKV6Model
    else:
        cls = _FAMILIES[cfg.family]
    return cls(cfg, device=device, shard_ec=shard_ec,
               weight_gather=weight_gather, shard_assign=shard_assign)


__all__ = ["Mamba2Model", "NOT_PORTED", "RWKV6Model", "TransformerModel",
           "Zamba2Model", "get_model"]
