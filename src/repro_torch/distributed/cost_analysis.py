"""Per-device cost of one traced step: flops, bytes, collectives, peak
memory and the roofline they bound.

Port of ``src/repro/distributed/hlo_analysis.py``.  The reference compiles
the step with XLA and reads the compiled program: ``cost_analysis()`` for
flops and bytes accessed, the HLO text for every collective and its
replica groups.  PyTorch has no compiler between the model and the card:
the step runs eagerly, op by op, and what it runs on one rank is exactly
what that rank's card would run.  So there is no HLO to parse.  The
dry-run (``launch.dryrun``) runs the step itself on fake tensors
(``FakeTensorMode``) and fake ranks, and :class:`CostMode` records, for
the ops rank 0 runs (each DTensor op as its local shards' ops):

  * flops, by ``torch.utils.flop_counter``'s formulas (the ones
    ``FlopCounterMode`` uses, kernel 2's passes at their own work,
    registered in ``kernels.flash_attention``);
  * bytes: every op's inputs read and outputs written.  Eager PyTorch does
    not fuse, so this is what the step moves through device memory, op by
    op.  It is not XLA's post-fusion "bytes accessed", which counts a
    fused chain's intermediates not at all; the two do not compare;
  * every functional collective (``_c10d_functional``: what DTensor's
    redistributions and the port's explicit gathers run), with its
    group's size, weighted by the reference's ring factors
    (:func:`ring_wire_bytes`);
  * the peak of live device storage (:attr:`CostMode.peak_bytes`), the
    counterpart of XLA's ``memory_analysis``.

Hardware constants are the NVIDIA H100 SXM's (data sheet, dense, at the
700 W limit), in place of the reference's TPU v5e: 989 TFLOP/s bf16 on the
tensor cores, 3.35 TB/s HBM3, NVLink 450 GB/s each way to the other cards
of a host (eight cards a host: a model axis of 16 spans two NVLink
domains, whose second hop the 450 GB/s does not price), and the device
memory ``torch.cuda.get_device_properties(0).total_memory`` reports on an
H100 80GB HBM3.  :class:`Roofline` takes the rates as fields with these
defaults, so that the TPU's reproduce the reference's rows.
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores, per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # NVLink bytes/s each way, per card
HBM_BYTES = 85_017_493_504   # total_memory of an H100 80GB HBM3

# functional collective op -> the reference's collective kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
    "broadcast_": "collective-broadcast",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional")

# ops that read or write no tensor data
_NO_DATA = {
    "detach", "alias", "lift_fresh", "empty", "empty_strided", "new_empty",
    "new_empty_strided", "empty_like", "wait_tensor",
    "_local_scalar_dense", "set_",
}
# metadata queries, which FlopCounterMode passes over too
_META = {
    "sym_is_contiguous", "is_contiguous", "is_strides_like_format",
    "is_non_overlapping_and_dense", "size", "sym_size", "stride",
    "sym_stride", "storage_offset", "sym_storage_offset", "numel",
    "sym_numel", "dim", "layout", "device",
}


def ring_wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Per-device wire bytes of one collective on a ring of ``n`` ranks
    whose result holds ``result_bytes`` (the reference's factors)."""
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        # the result is the scattered (small) shape; the input is n of it
        return result_bytes * (n - 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (n - 1) / n
    if kind in ("all-to-all", "ragged-all-to-all"):
        return result_bytes * (n - 1) / n
    if kind in ("collective-permute", "collective-broadcast"):
        return float(result_bytes)
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, kind: str, b: float):
        self.wire_bytes += b
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + b
        self.counts[kind] = self.counts.get(kind, 0) + 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]
    return _resolve_process_group(names[-1]).size()


def _propagation_codes() -> tuple:
    """The code of DTensor's output-metadata propagation, which runs each
    new op once more on global-shaped fake tensors: ops run from it are
    not the rank's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    codes = tuple(getattr(ShardingPropagator, n).__code__ for n in (
        "_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
        if hasattr(ShardingPropagator, n))
    if not codes:
        raise RuntimeError("this torch's DTensor has no "
                           "ShardingPropagator._propagate_tensor_meta*: "
                           "cannot tell its metadata runs from a rank's ops")
    return codes


class CostMode(TorchDispatchMode):
    """Records what each op run under it costs one rank (see the module
    docstring): ``flops``, ``bytes``, ``collectives`` (a
    :class:`CollectiveStats`) and the live and peak bytes of storage on
    ``device_type``.  DTensor ops are passed on to DTensor, whose local
    ops come back here.  :meth:`reset` zeroes the counts and starts the
    peak from what is live (``reset_peak_memory_stats``)."""

    def __init__(self, device_type: str = "cuda"):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.device_type = device_type
        self._registry = flop_registry
        self._skip_codes = _propagation_codes()
        self._refs: Dict[int, list] = {}
        self._infos: Dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.reset()

    def reset(self) -> None:
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives = CollectiveStats()
        self.peak_bytes = self.live_bytes

    # ------------------------------------------------------------ memory
    def _track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = st._cdata
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [0, st.nbytes()]
            self.live_bytes += ref[1]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        ref[0] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            self.live_bytes -= ref[1]
            del self._refs[key]

    def _in_propagation(self) -> bool:
        f = sys._getframe(2)
        for _ in range(12):
            if f is None:
                return False
            if f.f_code in self._skip_codes:
                return True
            f = f.f_back
        return False

    def _info(self, func):
        """(counted, flop formula, decomposes, collective kind) of an op,
        looked up once."""
        info = self._infos.get(func)
        if info is None:
            name = getattr(func, "_opname", str(func))
            ns = getattr(func, "namespace", "")
            formula = self._registry.get(func._overloadpacket)
            # as FlopCounterMode: an op without a formula that decomposes
            # is counted as its decomposition
            decomposes = ns == "aten" and formula is None and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd")
            counted = not (func.is_view or name in _NO_DATA)
            kind = _KINDS.get(name) if ns in _COLLECTIVE_NS else None
            info = self._infos[func] = (name in _META, counted, formula,
                                        decomposes, kind)
        return info

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        meta, counted, formula, decomposes, kind = self._info(func)
        if meta or self._in_propagation():
            return func(*args, **kwargs)
        if decomposes:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if not counted:
            return out
        self.ops += 1
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if kind is not None:
            self.collectives.add(kind, ring_wire_bytes(
                kind, sum(map(_nbytes, outs)), _group_size(args)))
        return out


@dataclasses.dataclass
class Roofline:
    """Three-term roofline for one (arch x shape x mesh) cell, at the
    NVIDIA H100 SXM's rates unless others are given."""

    flops: float                 # per-device flops
    hbm_bytes: float             # per-device bytes moved
    wire_bytes: float            # per-device collective bytes
    chips: int
    model_flops: float = 0.0     # 6·N·D (or 6·N_active·D) global
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips * flops): remat/redundancy waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step runs at
        the dominant-term time: t_compute / t_bound."""
        return self.t_compute / self.t_bound if self.t_bound else 0.0

    def row(self) -> Dict[str, float]:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops_estimate(n_params_active: float, tokens: float,
                         training: bool) -> float:
    """6·N·D for training, 2·N·D for inference forward."""
    return (6.0 if training else 2.0) * n_params_active * tokens

