"""End-to-end training driver with checkpoint/restart.

Port of ``src/repro/launch/train.py``: the same flags, plus ``--device``
(default ``cuda``, which raises without a card; ``cpu`` runs on the host).
The loop, its logging, the periodic async checkpoints, ``--resume auto``
(restore the latest valid checkpoint and seek the data to its cursor, so no
sample is lost or seen twice) and the ``--total-steps`` horizon of the
learning-rate schedule are the reference's.  A run checkpointed and
resumed gives the losses of an uninterrupted one (the data is a pure
function of the step).  Batches are pinned in the prefetch thread and
copied to the card without a host wait.  The port runs on one device: the
mesh and the FSDP weight gather wait for ROADMAP module item 13.

Usage:
  python -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
      --steps 50 --batch 8 --seq 128 --device cpu
  python -m repro_torch.launch.train --arch stablelm-1.6b --steps 20 \\
      --batch 8 --seq 512 --ckpt-dir /tmp/ckpt --resume auto
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.runtime import resolve_device
from repro_torch.data import Prefetcher, SyntheticSource
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


def to_device(batch, dev: torch.device):
    if dev.type == "cpu":
        return {k: torch.as_tensor(v) for k, v in batch.items()}
    return {k: v.to(dev, non_blocking=True) for k, v in batch.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Trains; returns ``final_loss``, ``losses`` and ``step_s`` (each
    step's host seconds, which end in the loss's read back), with the
    ``model``, its train ``state``, the ``train_step``, the data
    ``source`` and the ``device`` for a caller that measures more steps."""
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

    dev = resolve_device(args.device, "--device")
    model = get_model(cfg, device=dev)
    total = args.total_steps or args.steps
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=total,
                          warmup_steps=max(1, total // 10))
    state = tsteps.init_train_state(
        model, torch.Generator(device=dev).manual_seed(args.seed), opt_cfg)
    train_step = tsteps.build_train_step(model, opt_cfg, args.microbatch)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if mgr and args.resume == "auto" and mgr.latest_step() is not None:
        step0 = mgr.latest_step()
        state, cursor = mgr.restore(step0, state)
        start_step = cursor
        print(f"[resume] restored step {step0}, data cursor {cursor}")

    source = SyntheticSource(cfg.vocab_size, seed=args.seed)
    prefetch = Prefetcher(PinnedSource(source) if dev.type == "cuda"
                          else source, args.batch, args.seq,
                          start_step=start_step)
    n_params = sum(p.numel() for p in state["params"].values())
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"device={dev} steps={start_step}..{args.steps}")

    losses, step_s = [], []
    _sync(dev)
    t0 = t_prev = time.perf_counter()
    try:
        for step in range(start_step, args.steps):
            got_step, batch = next(prefetch)
            assert got_step == step, (got_step, step)
            state, metrics = train_step(state, to_device(batch, dev))
            losses.append(float(metrics["loss"]))
            t_now = time.perf_counter()
            step_s.append(t_now - t_prev)
            t_prev = t_now
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} "
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
            "device": dev}


if __name__ == "__main__":
    main()
