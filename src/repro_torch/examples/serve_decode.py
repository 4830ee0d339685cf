"""Batched serving example: prefill a prompt batch, decode with KV cache.

Port of ``examples/serve_decode.py``: ``launch.serve`` at smoke scale.  The
reference's example expects 15 tokens from ``--gen 16``; its driver
returns all 16 (the first comes from the prefill), and so does the port's,
so this example checks for 16.

    python -m repro_torch.examples.serve_decode          # on the card
    python -m repro_torch.examples.serve_decode --cpu    # plain versions
    python -m repro_torch.examples.serve_decode --cpu --arch rwkv6-1.6b
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the host")
    args = ap.parse_args(argv)
    out = serve_main(["--arch", args.arch, "--smoke",
                      "--batch", "4", "--prompt-len", "32", "--gen", "16",
                      "--device", "cpu" if args.cpu else "cuda"])
    if out["tokens"].shape != (4, 16):
        raise AssertionError(f"tokens {out['tokens'].shape}, expected "
                             f"(4, 16)")
    print("serve_decode OK")


if __name__ == "__main__":
    main()
