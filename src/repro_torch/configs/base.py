"""Architecture + run configuration.

Port of ``src/repro/configs/base.py``.  One ``ArchConfig`` per assigned
architecture (exact published dims) lives in ``configs/<id>.py``; the
registry resolves ``--arch <id>``.  Input shapes are the assignment's four
LM shapes.  ``pdtype``/``adtype`` name torch dtypes.  ``input_specs``
gives the dry-run's stand-ins of every model input: tensors without data,
on the ``meta`` device (or fake ones under ``launch.dryrun``'s
``FakeTensorMode``), in place of the reference's ``jax.ShapeDtypeStruct``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / rwkv6) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # --- hybrid (zamba2): shared attention block applied every k-th layer ---
    shared_attn_every: int = 0
    num_shared_attn_blocks: int = 2
    # --- misc ---
    qkv_bias: bool = False
    causal: bool = True            # False => encoder-only (no decode shapes)
    embedding_input: bool = False  # audio/vlm: stub frontend supplies embeds
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    # --- execution policy (hillclimb knobs) ---
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    remat: bool = True             # recompute each layer in the backward
    block_q: int = 512             # attention q-block
    microbatch: int = 1            # gradient-accumulation steps
    moe_groups: Optional[int] = None
    # scan_layers: the reference's choice between lax.scan over stacked
    # layers and unrolled python loops (its dry-run's cost mode).  The
    # port's models always loop over their layers in python, but the state-
    # space blocks honour what the reference ties to it: off, Mamba2 bounds
    # its chunk count (chunk >= S // 8) and RWKV6 takes the associative WKV
    # instead of the chunked one.
    scan_layers: bool = True
    source: str = ""               # provenance note [source; tier]

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.act_dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return self.replace(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 8) if self.is_moe else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            shared_attn_every=2 if self.shared_attn_every else 0,
            num_shared_attn_blocks=1 if self.shared_attn_every else 0,
            param_dtype="float32",
            act_dtype="float32",
            block_q=16,
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "zamba2-1.2b",
    "hubert-xlarge",
    "qwen2.5-3b",
    "codeqwen1.5-7b",
    "stablelm-1.6b",
    "llama3.2-3b",
    "rwkv6-1.6b",
    "qwen3-moe-235b-a22b",
    "deepseek-moe-16b",
    "internvl2-26b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def cell_is_supported(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(supported, reason-if-not) for an (arch × shape) cell — DESIGN.md §5."""
    if shape.kind == "decode" and not cfg.causal:
        return False, "encoder-only arch has no autoregressive decode step"
    sub_quadratic = cfg.family in ("ssm", "hybrid")
    if shape.name == "long_500k" and not sub_quadratic:
        return False, "pure full-attention arch; 500k decode needs sub-quadratic backbone"
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                device="meta") -> Dict[str, torch.Tensor]:
    """Data-free stand-ins (``torch.empty`` on ``device``: ``meta``, or a
    fake device under a ``FakeTensorMode``) for every model input of this
    cell, in the reference's shapes and dtypes.

    train:   tokens/labels (B, S) int32 (or frame/patch embeddings for
             stubbed-frontend archs: (B, S, D) act_dtype + labels).
    prefill: tokens (B, S).
    decode:  tokens (B,); the cache's stand-ins come from the model itself
             (``cache_specs``).
    """
    B, S = shape.global_batch, shape.seq_len
    spec = lambda *dims, dtype=torch.int32: torch.empty(  # noqa: E731
        dims, dtype=dtype, device=device)
    if shape.kind in ("train", "prefill"):
        inputs = spec(B, S, cfg.d_model, dtype=cfg.adtype) \
            if cfg.embedding_input else spec(B, S)
        if shape.kind == "prefill":
            return {"inputs": inputs}
        return {"inputs": inputs, "labels": spec(B, S)}
    # decode: one new token against a cache of max length S.  Even
    # stubbed-frontend VLMs decode *text* tokens (the frontend only feeds
    # prefill), so decode inputs are always token ids.
    return {"inputs": spec(B)}
