"""Multi-pod dry-run: trace one step of every (arch x shape x mesh) cell on
fake ranks and fake tensors.

Port of ``src/repro/launch/dryrun.py``.  The reference lowers and compiles
each cell's step with XLA on 256 or 512 forced host devices and reads the
compiled program: compile success proves the distribution config coherent,
``memory_analysis()`` the per-chip working set, ``cost_analysis()`` and the
HLO text the flops, bytes and collectives.  PyTorch has no such compiler:
the step runs eagerly, and what one rank runs is what its card would run.
So the port's proof is the step itself, run once by rank 0 of a fake
process group of 256 (16 x 16) or 512 (2 x 16 x 16) ranks
(``torch.testing``'s ``FakeStore``, backend ``"fake"``: every collective
returns at once, nothing moves) on fake tensors (``FakeTensorMode``: shapes,
dtypes and devices, no data, no allocation) that claim the card
(``cuda``; on a CPU build of torch, ``cpu``: :func:`trace_device`), at
full width and depth, under
``distributed.cost_analysis.CostMode``, which records each op's flops and
bytes, each collective with its group, and the peak of live device
storage.  The sharded model, its train state and its hooks are the port's
own (``models``, ``distributed.sharding``, ``training.steps``); kernel 2
takes the card's branch as a fake operator that launches nothing and is
counted at its own work.

The reference also compiles each cell unrolled at two or three reduced
depths and extrapolates, because XLA's ``cost_analysis`` counts a scanned
layer's body once.  An eager trace runs every layer, so the full-depth
counts are read directly: ``cost_points`` and ``_cost_depths`` have no
port.  ``collective_counts_scan_body`` holds the whole step's collective
counts (the port has no scan body).  A cell that raises is a FAIL with its
traceback: a bug, as in the reference.

The module touches no process group and sets no environment variable
when imported.  :func:`run_cell` brings up its fake group itself, in a
process where no group is up (it refuses otherwise), and tears it down.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
  ... [--microbatch N] [--no-remat] [--block-q N] [--no-master]
      [--proof-only] [--no-weight-gather]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs import (ARCH_IDS, SHAPES, cell_is_supported,
                                 get_arch, input_specs)
from repro_torch.distributed import (SERVE_RULES, constrain,
                                     make_weight_gather, tree_shardings)
from repro_torch.distributed.cost_analysis import (
    HBM_BYTES, CostMode, Roofline, model_flops_estimate)
from repro_torch.launch.mesh import PRODUCTION_MESH, make_production_mesh
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import steps as tsteps



def trace_device() -> str:
    """The fake tensors' device: the card's (``cuda``) where torch is built
    for it, whether or not a card is present.  A CPU build of torch cannot
    trace even fake ``cuda`` tensors through autograd or DTensor's masked
    embedding (both ask for the card's device guard), so there the step
    traces on fake ``cpu`` tensors and a ``cpu`` mesh: the same model ops,
    but kernel 2 runs as its plain version's ops (not one fake operator
    counted at its own work), and DTensor's shard-to-shard
    redistributions run as all-gathers, where a card's mesh runs
    all-to-alls.  The artifact's ``trace_device`` says which."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _shard_ec_hook(mesh):
    """Constraint for MoE (G, E, C, D) dispatch activations."""
    def hook(t):
        return constrain(t, ("batch", "experts", None, None), mesh)
    return hook


def _shard_assign_hook(mesh):
    """Constraint pinning MoE (G, E, C, D) buffers to model-replicated at
    the dispatch/combine boundaries (see the reference's moe_apply)."""
    def hook(t):
        return constrain(t, ("batch",) + (None,) * (t.ndim - 1), mesh)
    return hook


def _leaves(tree):
    if isinstance(tree, torch.Size):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def count_params(shapes_tree) -> int:
    """Elements of every leaf of a tree (dicts and lists) of tensors (the
    global shapes of DTensors) or shapes."""
    return int(sum(math.prod(getattr(s, "shape", s))
                   for s in _leaves(shapes_tree)))


def active_params(cfg, named: Dict[str, torch.Tensor]) -> int:
    """MoE: count routed-expert params at top_k/E utilization.  ``named``
    maps parameter names (``layers.0.moe.w_up``) to tensors or shapes."""
    total = count_params(named)
    if not cfg.is_moe:
        return total
    expert = sum(math.prod(getattr(p, "shape", p)) for k, p in named.items()
                 if "moe" in k and "shared" not in k and "router" not in k)
    frac = cfg.num_experts_per_tok / cfg.num_experts
    return int(total - expert + expert * frac)


def _serve_rules_if_fits(param_sds, mesh, budget=int(1.5 * 2**30)):
    """Serving: TP-only weight sharding when params fit comfortably per
    chip (no per-step FSDP gather); 2-D sharding otherwise.  The budget
    leaves HBM headroom for the KV cache (the reference's 1.5 GiB).
    ``mesh`` needs only a ``.shape`` mapping (or is a ``DeviceMesh``)."""
    from repro_torch.distributed import mesh_shape
    bytes_total = sum(math.prod(s.shape) * s.element_size()
                      for s in _leaves(param_sds))
    if bytes_total / mesh_shape(mesh)["model"] <= budget:
        return SERVE_RULES
    return None


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks in this process (this
    process is rank 0), torn down on exit.  Refuses where a group is up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up: the dry-run "
                           "brings up a fake one of its own, so run it in "
                           "a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _to_device(model, device) -> None:
    """Every parameter of ``model`` (fake CPU tensors, drawn by ``init``)
    made again on ``device`` (fake too: there is no data to copy, and a
    CPU build of torch cannot copy to ``cuda``), and the model's device
    set to it."""
    for name, p in list(model.named_parameters()):
        owner, leaf = name.rsplit(".", 1)
        p = model.get_submodule(owner)[leaf] = nn.Parameter(
            torch.empty_like(p, device=device),
            requires_grad=p.requires_grad)
    model.device = p.device


def _placed_batch(x, mesh):
    """``x`` with dim 0 sharded over the pod/data axes where they divide
    it, replicated otherwise (the reference's ``bspec``)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.spmd import group_placements
    return distribute_tensor(x, mesh, group_placements(mesh, x.shape[0]),
                             src_data_rank=None)


def _trace(cfg, shape, mesh, use_master, microbatch, weight_gather,
           cost: CostMode, device: str) -> Dict:
    """Builds the sharded model and its state on fake tensors and runs one
    step under ``cost``; returns the model's parameter shapes by name (no
    tensor: the unsharded weights must not outlive the sharding)."""
    wg = make_weight_gather(mesh) if weight_gather else None
    rep_hook = _shard_assign_hook(mesh) if shape.kind == "train" else None
    model = get_model(cfg, device="cpu", shard_ec=_shard_ec_hook(mesh),
                      weight_gather=wg, shard_assign=rep_hook)
    model.init(torch.Generator().manual_seed(0))
    _to_device(model, device)
    named = {k: p.shape for k, p in model.named_parameters()}
    batch = {k: _placed_batch(v, mesh)
             for k, v in input_specs(cfg, shape, device=device).items()}
    if shape.kind == "train":
        opt_cfg = AdamWConfig(use_master=use_master)
        state = tsteps.shard_train_state(model, mesh, opt_cfg)
        step = tsteps.build_train_step(model, opt_cfg, microbatch,
                                       unroll=not cfg.scan_layers)
        cost.reset()
        step(state, batch)
        return named
    rules = _serve_rules_if_fits(list(model.parameters()), mesh)
    if rules is not None:
        # serving with TP-only weights needs no per-step gather; archs that
        # stay 2-D-sharded in serving (params too big) keep the FSDP gather
        model.weight_gather = None
    model.shard(mesh, rules)
    if shape.kind == "prefill":
        cache_sds = model.cache_specs(shape.global_batch, shape.seq_len)
        step = tsteps.build_prefill_step(
            model, max_len=shape.seq_len, cache_shardings=tree_shardings(
                model.cache_logical_axes(), cache_sds, mesh))
        cost.reset()
        step(batch["inputs"])
        return named
    cache = model._prefill_cache(shape.global_batch, shape.seq_len)
    cost.reset()
    tsteps.build_decode_step(model)(cache, batch["inputs"])
    return named


def trace_cell(cfg, shape, mesh, overrides: Optional[Dict] = None,
               proof_only: bool = False) -> Dict:
    """One step of ``cfg`` at ``shape`` on ``mesh`` (a ``DeviceMesh`` of
    the fake group that is up), traced on fake tensors on the mesh's
    device: the artifact's keys past the cell's names.  ``overrides`` of
    the config are applied by the caller; ``use_master``, ``microbatch``
    and ``weight_gather`` are read here."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    overrides = overrides or {}
    chips = mesh.size()
    use_master = overrides.get("use_master", True)
    microbatch = overrides.get("microbatch") or cfg.microbatch
    weight_gather = overrides.get("weight_gather", True)
    device = mesh.device_type
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), \
            CostMode(device) as cost:
        named = _trace(cfg, shape, mesh, use_master, microbatch,
                       weight_gather, cost, device)
    n_params = count_params(named)
    n_active = active_params(cfg, named)
    art = {
        "status": "OK", "chips": chips, "trace_device": device,
        "n_params": n_params, "n_params_active": n_active,
        "device_hbm_bytes": int(cost.peak_bytes),
        "fits_hbm": bool(cost.peak_bytes <= HBM_BYTES),
        "trace_s": round(time.time() - t0, 2),
        "collective_counts_scan_body": dict(cost.collectives.counts),
        "overrides": {k: v for k, v in overrides.items() if v is not None},
    }
    if proof_only:
        return art
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch)
    rl = Roofline(flops=float(cost.flops), hbm_bytes=float(cost.bytes),
                  wire_bytes=cost.collectives.wire_bytes, chips=chips,
                  model_flops=model_flops_estimate(
                      n_active, tokens, shape.kind == "train"))
    art.update({
        "tokens": tokens,
        "flops_per_device": float(cost.flops),
        "bytes_per_device": float(cost.bytes),
        "wire_bytes_per_device": cost.collectives.wire_bytes,
        "collectives": {k: int(v)
                        for k, v in cost.collectives.by_kind.items()},
        "model_flops": rl.model_flops,
        "roofline": rl.row(),
    })
    return art


def _mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, PRODUCTION_MESH[multi_pod][0]))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: Optional[Dict] = None,
             proof_only: bool = False) -> Dict:
    """One cell's trace on a fake group of 256 (16x16) or 512 (2x16x16)
    ranks, in a process where no process group is up."""
    overrides = overrides or {}
    cfg = get_arch(arch)
    cfg_over = {k: v for k, v in overrides.items()
                if k in cfg.__dataclass_fields__ and v is not None}
    cfg = cfg.replace(**cfg_over)
    shape = SHAPES[shape_name]
    names = {"arch": arch, "shape": shape_name,
             "mesh": _mesh_name(multi_pod)}
    ok, why = cell_is_supported(cfg, shape)
    if not ok:
        return {**names, "status": "SKIP", "reason": why}
    with fake_world(math.prod(PRODUCTION_MESH[multi_pod][0])):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=trace_device())
        return {**names, **trace_cell(cfg, shape, mesh, overrides,
                                       proof_only)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--proof-only", action="store_true",
                    help="record the trace's proof keys only (status, "
                         "parameters, peak memory, collective counts)")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose artifact JSON already exists")
    # hillclimb overrides
    ap.add_argument("--microbatch", type=int)
    ap.add_argument("--block-q", dest="block_q", type=int)
    ap.add_argument("--moe-groups", dest="moe_groups", type=int)
    ap.add_argument("--no-remat", dest="remat", action="store_false",
                    default=None)
    ap.add_argument("--no-master", dest="use_master", action="store_false",
                    default=True)
    ap.add_argument("--no-weight-gather", dest="weight_gather",
                    action="store_false", default=True,
                    help="disable the FSDP point-of-use weight all-gather")
    args = ap.parse_args(argv)

    overrides = {"microbatch": args.microbatch, "block_q": args.block_q,
                 "moe_groups": args.moe_groups, "use_master": args.use_master,
                 "weight_gather": args.weight_gather}
    if args.remat is False:
        overrides["remat"] = False

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    for arch, shape in cells:
        for mp in meshes:
            # the multi-pod pass is a shardability proof only; the
            # roofline table is single-pod, as in the reference
            proof_only = args.proof_only or mp
            name = f"{arch}__{shape}__{'multi' if mp else 'single'}"
            if args.tag:
                name += f"__{args.tag}"
            path = os.path.join(args.out, name + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[SKIP-EXISTING] {name}", flush=True)
                continue
            t_cell = time.time()
            try:
                art = run_cell(arch, shape, mp, overrides,
                               proof_only=proof_only)
            except Exception as e:  # a failing cell is a bug: record it
                art = {"arch": arch, "shape": shape,
                       "mesh": _mesh_name(mp), "status": "FAIL",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            art["wall_s"] = round(time.time() - t_cell, 1)
            with open(path, "w") as f:
                json.dump(art, f, indent=1)
            status = art["status"]
            extra = ""
            if status == "OK":
                extra = (f" hbm={art['device_hbm_bytes'] / 2**30:.2f}GiB"
                         f" fits={art['fits_hbm']}"
                         f" trace={art['trace_s']}s")
                if "roofline" in art:
                    r = art["roofline"]
                    extra += (f" bottleneck={r['bottleneck']}"
                              f" frac={r['roofline_fraction']:.3f}")
            elif status == "SKIP":
                extra = f" ({art['reason']})"
            else:
                extra = f" ({art['error'][:200]})"
            print(f"[{status}] {name}{extra} ({art['wall_s']}s)", flush=True)


if __name__ == "__main__":
    main()
