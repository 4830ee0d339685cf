"""End-to-end driver: train a 180 M-parameter LM for a few hundred steps.

Port of ``examples/train_lm.py`` over ``launch/train.py``, with the same
two argument lists; its checkpoints go to a directory of its own.  (The
reference calls the model ~100 M parameters: its embedding and head on
the 100 k vocabulary are 103 M of the 180 M.)

    python -m repro_torch.examples.train_lm            # the full run, card
    python -m repro_torch.examples.train_lm --quick    # 12 smoke steps
    python -m repro_torch.examples.train_lm --quick --cpu
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the host instead of the card")
    args = ap.parse_args(argv)

    if args.quick:
        argv = ["--arch", "stablelm-1.6b", "--smoke",
                "--steps", str(args.steps or 12),
                "--batch", "2", "--seq", "64", "--log-every", "4"]
    else:
        # 180 M params: stablelm family at d_model=512, 8 layers
        # (embed + head on the 100 k vocab are 103 M of them)
        argv = ["--arch", "stablelm-1.6b",
                "--d-model", "512", "--layers", "8",
                "--steps", str(args.steps or 200),
                "--batch", "2", "--seq", "64",
                "--ckpt-dir", CKPT_DIR, "--ckpt-every", "50",
                "--resume", "auto", "--log-every", "10"]
    out = train_main(argv + ["--device", "cpu" if args.cpu else "cuda"])
    print(f"final loss: {out['final_loss']:.4f}")
    assert out["final_loss"] < out["losses"][0], "loss did not improve"
    print("train_lm OK")


if __name__ == "__main__":
    main()
