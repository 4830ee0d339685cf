"""OOC attention demo: the MMOOC pipeline reused for a KV cache.

Port of ``examples/ooc_attention_demo.py``.  A decode-step query attends
over a cache four times the device budget; KV blocks stream through the
same double-buffered schedule as the GEMM, with an online-softmax carry
instead of the beta-accumulate.  The reference's TPU engine model is
replaced by the GPU one (an estimate, not a measurement).

    python -m repro_torch.examples.ooc_attention_demo          # on the card
    python -m repro_torch.examples.ooc_attention_demo --cpu    # plain
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (build_attention_schedule, gpu_like,
                              ooc_attention, plan_attention_partition,
                              resolve_device, schedule_stats, simulate,
                              validate_schedule)
from repro_torch.kernels import ops, ref


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the host")
    args = ap.parse_args()
    dev = resolve_device("cpu" if args.cpu else None)
    rng = np.random.default_rng(0)
    H, hkv, d, S = 32, 8, 128, 8192
    q = rng.standard_normal((H, d)).astype(np.float32)
    k = rng.standard_normal((S, hkv, d)).astype(np.float32)
    v = rng.standard_normal((S, hkv, d)).astype(np.float32)
    budget = S * hkv * d * 4 // 4     # cache is 4x the device budget

    part = plan_attention_partition(S, hkv, d, budget)
    print(f"KV cache split into {part.nblocks} blocks of {part.bs} "
          f"positions")

    sched = build_attention_schedule(part, hkv, d, H)
    validate_schedule(sched)
    print(f"schedule: {schedule_stats(sched)}")

    out = ooc_attention(q, k, v, budget_bytes=budget, torch_device=dev)
    qt, kt, vt = (torch.from_numpy(x)[None].to(dev) for x in (q, k, v))
    length = torch.tensor([S], device=dev)
    expect = ref.decode_attention_ref(qt, kt, vt, length)[0].cpu()
    print(f"engine max err vs oracle: "
          f"{(out - expect).abs().max().item():.2e}")

    # the same computation through the flash-decoding kernel on the whole
    # cache (its plain version on the CPU)
    out_k = ops.flash_decode_attention(qt, kt, vt, length,
                                       block_s=512)[0].cpu()
    print(f"kernel max err vs oracle: "
          f"{(out_k - expect).abs().max().item():.2e}")

    hw = gpu_like()
    res = simulate(sched, hw)
    print(f"{hw.name} (model estimate): {res.makespan*1e6:.1f} us/token, "
          f"H2D util {res.utilization('h2d'):.2f} (memory-bound, as decode "
          f"is)")
    print("ooc_attention_demo OK")


if __name__ == "__main__":
    main()
