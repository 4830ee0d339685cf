"""Logical-axis sharding over ``torch.distributed`` device meshes.

Port of ``src/repro/distributed`` (its sharding half; the dry-run's HLO
analysis and roofline, ``hlo_analysis``, are ROADMAP module item 13b).
"""

from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    SERVE_RULES,
    P,
    PartitionSpec,
    batch_spec,
    constrain,
    distribute,
    logical_to_spec,
    make_weight_gather,
    mesh_shape,
    placements,
    tree_shardings,
    tree_specs,
)

__all__ = [
    "DEFAULT_RULES", "P", "PartitionSpec", "SERVE_RULES", "batch_spec",
    "constrain", "distribute", "logical_to_spec", "make_weight_gather",
    "mesh_shape", "placements", "tree_shardings", "tree_specs",
]
