"""The port on a card: the hand-written kernel and the executor's CUDA
streams, events and pinned staging.

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX and nothing of the reference package, so it runs on the
machine with the card::

    python -m pytest -q -m cuda tests/test_torch_card.py

Oracles are the kernel's plain PyTorch version and float64 products; within
the card, results that the kernel's fixed K order makes identical are
compared bit for bit.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels.block_matmul import block_matmul, block_matmul_plain
from _torch_helpers import overlap_schedule

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, M, N, K):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32),
            rng.standard_normal((M, N)).astype(np.float32))


@pytest.mark.parametrize("M,N,K", [(300, 200, 150), (512, 128, 257),
                                   (1000, 999, 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_matches_plain_version(card, dtype, M, N, K):
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    A, B, C = (torch.from_numpy(x).to(card, dtype)
               for x in _inputs(M + N + K, M, N, K))
    before = block_matmul.launches
    outs = [block_matmul(A, B, C, alpha=1.25, beta=0.5, block=blk)
            for blk in ((128, 128, 128), (64, 64, 64))]
    assert block_matmul.launches == before + 2
    plain = block_matmul_plain(A, B, C, alpha=1.25, beta=0.5)
    torch.testing.assert_close(outs[0].float(), plain.float(), rtol=tol,
                               atol=tol)
    assert torch.equal(outs[0], outs[1])
    sub = block_matmul(A[7:M - 3], B[:, 5:N - 9], C[7:M - 3, 5:N - 9],
                       alpha=1.25, beta=0.5)
    assert torch.equal(sub, outs[0][7:M - 3, 5:N - 9])


def test_kernel_rejects_float64(card):
    a = torch.ones(8, 8, device=card, dtype=torch.float64)
    with pytest.raises(TypeError):
        block_matmul(a, a, a)


@pytest.mark.parametrize("nstreams,nbuf,traversal,evict", [
    (2, 2, "col", "lru"), (1, 1, "row", "belady"),
    (2, 3, "serpentine", "lru"), (3, 2, "zmorton", "belady")])
def test_executor_modes_agree_and_match_in_core(card, nstreams, nbuf,
                                                traversal, evict):
    A, B, C = _inputs(nstreams + nbuf, 704, 576, 320)
    full = A.nbytes + B.nbytes + C.nbytes
    part = T.plan_gemm_partition(704, 576, 320, full // 4, 4)
    sched = T.build_gemm_schedule(part, nstreams=nstreams, nbuf=nbuf,
                                  traversal=traversal, evict=evict)
    stats = T.schedule_stats(sched)
    n_dgemm = sum(1 for op in sched.ops
                  if isinstance(op.payload, T.BlockRef)
                  and op.payload.kernel == "dgemm")
    outs = []
    for mode in ("issue_order", "concurrent"):
        for wb in (True, False):
            ex = T.ScheduleExecutor(mode=mode, async_writeback=wb,
                                    record_spans=True)
            out = torch.from_numpy(C.copy())
            before = block_matmul.launches
            ex.run(sched, {"A": A, "B": B}, {"C": out},
                   {"alpha": 1.5, "beta": 0.5})
            assert block_matmul.launches - before == n_dgemm
            assert (ex.last_h2d_bytes, ex.last_d2h_bytes) \
                == (stats["h2d_bytes"], stats["d2h_bytes"])
            assert [s[0] for s in ex.last_spans] == \
                [op.tag for op in sched.ops]
            assert all(0.0 <= s[2] <= s[3] for s in ex.last_spans)
            outs.append(out)
    incore = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=full)
    for out in outs:
        assert torch.equal(out, incore)
    np.testing.assert_allclose(incore.numpy(),
                               1.5 * (A.astype(np.float64) @ B) + 0.5 * C,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["issue_order", "concurrent"])
def test_host_coherence_on_card(card, mode):
    rng = np.random.default_rng(21)
    A = rng.standard_normal((6, 8)).astype(np.float32)
    B = rng.standard_normal((8, 6)).astype(np.float32)
    C = rng.standard_normal((6, 6)).astype(np.float32)
    expect = C.astype(np.float64)
    ab = A.astype(np.float64) @ B
    expect[0:4] = ab[0:4] + 2.0 * expect[0:4]
    expect[2:6] = ab[2:6] + 2.0 * expect[2:6]
    out = torch.from_numpy(C.copy())
    T.ScheduleExecutor(mode=mode).run(overlap_schedule(T),
                                      {"A": A, "B": B}, {"C": out},
                                      {"alpha": 1.0, "beta": 2.0})
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-5, atol=1e-5)


def test_host_path_stays_within_working_set(card):
    M, N, K = 2048, 1536, 1024
    A, B, C = _inputs(5, M, N, K)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 4
    part = T.plan_gemm_partition(M, N, K, budget, 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = T.ooc_gemm(A, B, C, budget_bytes=budget, nstreams=2, nbuf=2)
    peak = torch.cuda.max_memory_allocated() - base
    # slack: the caching allocator rounds each of the six buffers up
    assert peak <= part.working_set_bytes(nbuf=2, nstreams=2) + 12 * 2**20
    np.testing.assert_allclose(out.numpy(), A.astype(np.float64) @ B,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["host", "vmem"])
def test_syrk_matches_in_core_bitwise(card, backend):
    rng = np.random.default_rng(13)
    P = rng.standard_normal((768, 256)).astype(np.float32)
    C = rng.standard_normal((768, 768)).astype(np.float32)
    budget = (2 * P.nbytes + C.nbytes) // 4
    out = T.ooc_syrk(P, C, -1.0, 0.5, budget_bytes=budget, backend=backend)
    Pd = torch.from_numpy(P).to(card)
    incore = block_matmul(Pd, Pd.T.contiguous(),
                          torch.from_numpy(C).to(card), alpha=-1.0, beta=0.5)
    assert torch.equal(out.cpu(), incore.cpu())
