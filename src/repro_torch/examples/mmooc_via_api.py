"""MMOOC written against the unified libhclooc-style API (paper Fig. 2).

Port of ``examples/mmooc_via_api.py``.  This file is the LOC *numerator*
for claim C4: compare with the backend-specific implementations in
``repro_torch/direct_impls.py``.  The same code runs on every memory tier
by changing the device tuple — the paper's {"GPU"| "PHI"| "FPGA"} becomes
{"HBM"| "VMEM"| "MESH"}; the MESH tier's ring runs over the ranks of a
``torch.distributed`` device mesh (here one rank: NCCL on the card, gloo
with ``--cpu``) and returns C as a row-sharded DTensor.

    python -m repro_torch.examples.mmooc_via_api          # on the card
    python -m repro_torch.examples.mmooc_via_api --cpu    # plain versions
"""
import argparse

import numpy as np

from repro_torch.core.api import (hclDeviceFactory, hclMatrixPartitioner,
                                  hclRuntimeFactory)
from repro_torch.launch.mesh import init_distributed, make_mesh, shutdown


def mmooc(A, B, C, alpha, beta, device_name="HBM", device_id=0,
          mem_bytes=None, torch_device=None, mesh=None):
    d = hclDeviceFactory.create(device_name, device_id, mem_bytes,
                                torch_device)
    r = hclRuntimeFactory.create(d, mesh, torch_device=torch_device)
    part = hclMatrixPartitioner(A.shape[0], B.shape[1], A.shape[1],
                                d.mem_size(), A.dtype.itemsize)
    return r.gemm(A, B, C, alpha, beta, part)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the host")
    args = ap.parse_args()
    torch_device = "cpu" if args.cpu else None
    rng = np.random.default_rng(0)
    M, N, K = 768, 512, 384
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    C = rng.standard_normal((M, N)).astype(np.float32)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 5   # force out-of-core
    init_distributed(torch_device or "cuda")
    try:
        mesh = make_mesh((1,), ("model",))
        for dev in ("HBM", "VMEM", "MESH"):
            out = mmooc(A, B, C, 1.5, 0.5, dev, mem_bytes=budget,
                        torch_device=torch_device, mesh=mesh)
            out = out.full_tensor() if dev == "MESH" else out
            err = np.abs(out.cpu().numpy() - (1.5 * A @ B + 0.5 * C)).max()
            print(f"{dev}: max err {err:.2e}")
            assert err < 1e-2
    finally:
        shutdown()
    print("mmooc_via_api OK")


if __name__ == "__main__":
    main()
