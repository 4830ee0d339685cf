"""End-to-end training driver with checkpoint/restart.

Port of ``src/repro/launch/train.py``: the same flags, plus ``--device``
(default ``cuda``, which raises without a card; ``cpu`` runs on the host).
The loop, its logging, the periodic async checkpoints, ``--resume auto``
(restore the latest valid checkpoint and seek the data to its cursor, so no
sample is lost or seen twice) and the ``--total-steps`` horizon of the
learning-rate schedule are the reference's.  A run checkpointed and
resumed gives the losses of an uninterrupted one (the data is a pure
function of the step).  Batches are pinned in the prefetch thread and
copied to the card without a host wait.

Under ``torchrun`` (or with ``--mesh on``) the run is the reference's
sharded one: the default process group comes up (``launch.mesh``; NCCL on
cards, gloo on ``--device cpu``), :func:`make_local_mesh` lays the ranks
out as a (data, model) mesh, the train state is DTensors placed by
``tree_shardings`` (FSDP x TP), each rank takes its batch rows, and the
weights are gathered at their point of use when the world has more than
one rank.  Every rank draws the same weights and the same batches; rank 0
prints.  Without torchrun's variables the run is on one device with plain
tensors, as before.

Usage:
  python -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
      --steps 50 --batch 8 --seq 128 --device cpu
  python -m repro_torch.launch.train --arch stablelm-1.6b --steps 20 \\
      --batch 8 --seq 512 --ckpt-dir /tmp/ckpt --resume auto
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch stablelm-1.6b --smoke --device cpu      # 2 x 2 on gloo
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.runtime import resolve_device
from repro_torch.data import Prefetcher, SyntheticSource
from repro_torch.distributed import (batch_spec, make_weight_gather,
                                     placements)
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import steps as tsteps


class PinnedSource:
    """``source``'s batches as tensors in pinned host memory (made in the
    prefetch thread), ready for a copy to the card that does not block."""

    def __init__(self, source):
        self.source = source

    def batch_at(self, *args):
        return {k: torch.from_numpy(v).pin_memory()
                for k, v in self.source.batch_at(*args).items()}


def make_local_mesh():
    """A 2-D (data, model) mesh over the world's ranks: the model axis the
    largest of 4, 2, 1 that divides the world (the default group must be
    up)."""
    n = dist.get_world_size()
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return make_mesh((n // model, model), ("data", "model"))


def to_device(batch, dev: torch.device, mesh=None):
    """The batch on ``dev``; on a mesh, each tensor a DTensor of which this
    rank holds its batch rows (every rank holds the same full batch)."""
    if dev.type == "cpu":
        out = {k: torch.as_tensor(v) for k, v in batch.items()}
    else:
        out = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
    if mesh is None:
        return out
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(v, mesh, placements(
        batch_spec(mesh, v.dim()), mesh), src_data_rank=None)
        for k, v in out.items()}


def value(x) -> float:
    """A 0-dim tensor's value (a DTensor's replicated value)."""
    return float(x.full_tensor() if hasattr(x, "full_tensor") else x)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Trains; returns ``final_loss``, ``losses`` and ``step_s`` (each
    step's host seconds, which end in the loss's read back), with the
    ``model``, its train ``state``, the ``train_step``, the data
    ``source``, the ``device`` and the ``mesh`` (None unless sharded) for
    a caller that measures more steps.  A sharded run leaves the process
    group up (``launch.mesh.shutdown`` tears it down)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--total-steps", type=int, default=0,
                    help="LR-schedule horizon (defaults to --steps); set it "
                         "when an interrupted run will be resumed past "
                         "--steps so the schedule is restart-invariant")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", choices=["auto", "none"], default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M-param example)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    ap.add_argument("--mesh", choices=["auto", "on", "off"], default="auto",
                    help="sharded run on a (data, model) mesh: on under "
                         "torchrun (auto), or at any world size (on)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.d_model:
        cfg = cfg.replace(d_model=args.d_model,
                          head_dim=args.d_model // cfg.num_heads)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    cfg = cfg.replace(microbatch=args.microbatch)

    sharded = args.mesh == "on" or (args.mesh == "auto"
                                    and "WORLD_SIZE" in os.environ)
    mesh, rank = None, 0
    if sharded:
        dev = init_distributed(args.device)
        mesh, rank = make_local_mesh(), dist.get_rank()
        gather = make_weight_gather(mesh) if dist.get_world_size() > 1 \
            else None
    else:
        dev, gather = resolve_device(args.device, "--device"), None
    model = get_model(cfg, device=dev, weight_gather=gather)
    total = args.total_steps or args.steps
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=total,
                          warmup_steps=max(1, total // 10))
    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    state = tsteps.shard_train_state(model, mesh, opt_cfg) if sharded \
        else tsteps.train_state(model, opt_cfg)
    train_step = tsteps.build_train_step(model, opt_cfg, args.microbatch)
    say = print if rank == 0 else (lambda *a, **k: None)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if mgr and args.resume == "auto" and mgr.latest_step() is not None:
        step0 = mgr.latest_step()
        state, cursor = mgr.restore(step0, state)
        start_step = cursor
        say(f"[resume] restored step {step0}, data cursor {cursor}")

    source = SyntheticSource(cfg.vocab_size, seed=args.seed)
    prefetch = Prefetcher(PinnedSource(source) if dev.type == "cuda"
                          else source, args.batch, args.seq,
                          start_step=start_step)
    n_params = sum(p.numel() for p in state["params"].values())
    where = f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}" if sharded \
        else f"device={dev}"
    say(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
        f"{where} steps={start_step}..{args.steps}")

    losses, step_s = [], []
    _sync(dev)
    t0 = t_prev = time.perf_counter()
    try:
        for step in range(start_step, args.steps):
            got_step, batch = next(prefetch)
            assert got_step == step, (got_step, step)
            state, metrics = train_step(state, to_device(batch, dev, mesh))
            losses.append(value(metrics["loss"]))
            t_now = time.perf_counter()
            step_s.append(t_now - t_prev)
            t_prev = t_now
            if step % args.log_every == 0 or step == args.steps - 1:
                say(f"step {step:5d} loss {losses[-1]:.4f} "
                    f"gnorm {value(metrics['grad_norm']):.3f} "
                    f"lr {value(metrics['lr']):.2e} "
                    f"({t_now - t0:.1f}s)", flush=True)
                t_prev = time.perf_counter()     # logging is not the step's
            if mgr and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, state, data_cursor=step + 1)
                t_prev = time.perf_counter()     # nor the host snapshot
        if mgr:
            mgr.save(args.steps, state, data_cursor=args.steps,
                     blocking=True)
            mgr.wait()
    finally:
        prefetch.close()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "step_s": step_s, "model": model,
            "state": state, "train_step": train_step, "source": source,
            "device": dev, "mesh": mesh}


if __name__ == "__main__":
    main()
