"""The port on a card: the hand-written kernels and the executor's CUDA
streams, events and pinned staging.

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX and nothing of the reference package, so it runs on the
machine with the card::

    python -m pytest -q -m cuda tests/test_torch_card.py

Oracles are the kernels' plain PyTorch versions and float64 products;
within the card, results that the kernels' fixed summation orders make
identical are compared bit for bit.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch import direct_impls as D
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as kfa
from repro_torch.core.ooc_factor import (_plan_factor_spec,
                                         panel_workspace_bytes)
from repro_torch import fault as TF
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


# kernel 1's pipelines: k tiles of 16 in a ring of 4 stages in f32 (K = 64
# +- 1 straddles a full ring), k tiles of 64 in a ring of 4 stages in 16
# bits (K = 256 +- 1; 15, 17, 63 and 65 cut a tensor-core step of 16 or a
# tile); M = 200 is not a multiple of 64 and N = 131 not of 8, so both edge
# tiles are cut
PIPE_K = [1, 7, 15, 17, 33, 63, 64, 65, 255, 257]
GEMM_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("N", [136, 131])
@pytest.mark.parametrize("K", PIPE_K)
@pytest.mark.parametrize("dtype", GEMM_DTYPES)
def test_kernel_pipeline_edges(card, dtype, K, N):
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    M = 200
    A, B, C = (torch.from_numpy(x).to(card, dtype)
               for x in _inputs(K, M, N, K))
    out = block_matmul(A, B, C, alpha=1.25, beta=0.5)
    plain = block_matmul_plain(A, B, C, alpha=1.25, beta=0.5)
    torch.testing.assert_close(out.float(), plain.float(), rtol=tol,
                               atol=tol)
    sub = block_matmul(A[3:M - 70], B[:, 9:N - 1], C[3:M - 70, 9:N - 1],
                       alpha=1.25, beta=0.5)
    assert torch.equal(sub, out[3:M - 70, 9:N - 1])
    # kernel 3 sums in the same order: the same bits
    assert torch.equal(D.direct_vmem_ooc_gemm(A, B, C, 1.25, 0.5), out)


@pytest.mark.parametrize("dtype", GEMM_DTYPES)
@pytest.mark.parametrize("pad", [1, 3, 8])
def test_kernel_unaligned_row_strides(card, dtype, pad):
    """Operands inside wider rows, offset by ``pad`` elements.  Row strides
    that are not multiples of 16 bytes, and base pointers off a 16-byte
    boundary (pads 1 and 3), take the element-wise copies; pad 8 keeps
    both 16-byte aligned, so a padded row stride and an offset base go
    through the 16-byte copies (f32) or TMA (16 bits).  Each gives the same
    bits as contiguous copies of the operands (rows of 152 and 256
    elements)."""
    M, N, K = 150, 256, 152
    A, B, C = (torch.from_numpy(x).to(card, dtype)
               for x in _inputs(pad, M, N, K))
    wa = torch.zeros(M, K + pad, device=card, dtype=dtype)
    wb = torch.zeros(K, N + pad, device=card, dtype=dtype)
    wa[:, pad:] = A
    wb[:, pad:] = B
    av, bv = wa[:, pad:], wb[:, pad:]
    aligned = (av.stride(0) * av.element_size() % 16 == 0
               and av.data_ptr() % 16 == 0)
    assert aligned == (pad == 8)
    out = block_matmul(av, bv, C, alpha=-0.75, beta=1.5)
    assert torch.equal(out, block_matmul(A, B, C, alpha=-0.75, beta=1.5))
    sub = block_matmul(av[5:M - 2], bv[:, 1:N - 30], C[5:M - 2, 1:N - 30],
                       alpha=-0.75, beta=1.5)
    assert torch.equal(sub, out[5:M - 2, 1:N - 30])


@pytest.mark.parametrize("dtype", GEMM_DTYPES)
def test_kernel_out_aliases_strided_c(card, dtype):
    """The executor's use: ``out`` is ``c``, a row-strided view; nothing
    outside it is written, and the result is the one into a new tensor."""
    M, N, K = 131, 77, 65
    A, B, C = (torch.from_numpy(x).to(card, dtype)
               for x in _inputs(17, M, N, K))
    big = torch.full((M + 9, N + 11), 7.0, device=card, dtype=dtype)
    c = big[4:4 + M, 6:6 + N]
    c.copy_(C)
    fresh = block_matmul(A, B, C, alpha=1.5, beta=-0.5)
    assert block_matmul(A, B, c, alpha=1.5, beta=-0.5, out=c) is c
    assert torch.equal(c, fresh)
    rest = big.clone()
    rest[4:4 + M, 6:6 + N] = 7.0
    assert bool((rest == 7.0).all())
    sub_c = C[10:M - 1, 2:N - 5].clone()
    sub = block_matmul(A[10:M - 1], B[:, 2:N - 5], sub_c, alpha=1.5,
                       beta=-0.5, out=sub_c)
    assert torch.equal(sub, fresh[10:M - 1, 2:N - 5])


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_mmooc_equals_in_core_bitwise(card, dtype):
    """MMOOC in 16 bits on the tensor cores: every block is summed in the
    same k steps of 16 as the whole product, so both executor modes and the
    vmem backend equal one in-core launch bit for bit."""
    M, N, K = 704, 576, 320
    A, B, C = (torch.from_numpy(x).to(dtype) for x in _inputs(23, M, N, K))
    full = sum(t.numel() * t.element_size() for t in (A, B, C))
    part = T.plan_gemm_partition(M, N, K, full // 4, 2)
    assert part.h >= 2 and part.w >= 2
    incore = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=full)
    assert incore.dtype == dtype
    torch.testing.assert_close(
        incore.float(), block_matmul_plain(A, B, C, alpha=1.5,
                                           beta=0.5).float(),
        rtol=2e-2, atol=2e-2)
    for mode in ("issue_order", "concurrent"):
        rt = T.HostOocRuntime(executor=T.ScheduleExecutor(mode=mode))
        out = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=full // 4,
                         runtime=rt)
        assert torch.equal(out, incore), mode
    vmem = T.ooc_gemm(A.to(card), B.to(card), C.to(card), 1.5, 0.5,
                      budget_bytes=full // 4, backend="vmem")
    assert torch.equal(vmem.cpu(), incore)


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


@pytest.mark.parametrize("mode", T.ScheduleExecutor.MODES)
def test_gemm_c_made_on_card_equals_streamed_c_bitwise(card, mode):
    """A no-C out-of-core GEMM (ragged, at least 2 x 2 blocks) whose C
    blocks are zero-filled on the card equals the reference-equal schedule,
    which copies host zeros in, bit for bit on the same executor; it moves
    M·N·4 fewer H2D bytes and stages nothing for C (one ``executor.stage``
    range for each A or B copy alone)."""
    M, N, K = 1000, 900, 256
    A, B, _ = _inputs(17, M, N, K)
    budget = (A.nbytes + B.nbytes + M * N * 4) // 4
    part = T.plan_gemm_partition(M, N, K, budget, 4)
    assert part.h > 1 and part.w > 1 and M % part.bm and N % part.bn
    ex = T.ScheduleExecutor(mode=mode)
    ctx = {"alpha": 1.0, "beta": 0.0}
    runs = {}
    for fill in (False, True):
        sched = T.build_gemm_schedule(part, fill_c=fill)
        out = torch.zeros(M, N) if not fill \
            else torch.full((M, N), float("nan"))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            ex.run(sched, {"A": A, "B": B}, {"C": out}, ctx)
        stages = sum(e.name == "executor.stage" for e in prof.events())
        assert stages == sum(op.kind == T.OpKind.H2D for op in sched.ops)
        assert ex.last_h2d_bytes == T.schedule_stats(sched)["h2d_bytes"]
        runs[fill] = (out, ex.last_h2d_bytes, ex.last_fill_bytes, stages)
    (ref, ref_h2d, ref_fill, ref_stages), (out, h2d, filled, stages) = (
        runs[False], runs[True])
    assert torch.equal(out, ref)
    assert ref_h2d - h2d == M * N * 4
    assert (ref_fill, filled) == (0, M * N * 4)
    assert ref_stages - stages == part.nblocks
    got = T.ooc_gemm(A, B, budget_bytes=budget,
                     runtime=T.HostOocRuntime(T.Device("HBM", 0, budget),
                                              executor=ex))
    assert torch.equal(got, ref) and ex.last_fill_bytes == M * N * 4
    np.testing.assert_allclose(ref.numpy(), A.astype(np.float64) @ B,
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


@pytest.mark.parametrize("B,H,hkv,d,S,block_s", [
    (1, 8, 2, 64, 512, 128), (2, 16, 16, 64, 1000, 256),
    (3, 8, 1, 128, 384, 128), (2, 4, 4, 80, 300, 128),
    (1, 24, 8, 128, 8192, 512), (4, 32, 32, 64, 544, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_matches_plain_version(card, dtype, B, H, hkv, d, S,
                                               block_s):
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    rng = np.random.default_rng(B + H + d + S)
    q = torch.from_numpy(rng.standard_normal((B, H, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, hkv, d))
                             .astype(np.float32)).to(card, dtype)
            for _ in range(2))
    length = torch.from_numpy(rng.integers(1, S + 1, (B,)).astype(np.int32))
    for qd in (q.to(card), q.to(card, dtype)):
        before = (kfa.flash_partial.launches, kfa.flash_combine.launches)
        outs = [kfa.flash_decode_attention(qd, k, v, length.to(card),
                                           block_s=block_s)
                for _ in range(2)]
        assert (kfa.flash_partial.launches, kfa.flash_combine.launches) \
            == (before[0] + 2, before[1] + 2)
        plain = kfa.flash_decode_attention_plain(qd, k, v, length.to(card),
                                                 block_s=block_s)
        assert outs[0].dtype == qd.dtype
        torch.testing.assert_close(outs[0].float(), plain.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(outs[0], outs[1])


def test_flash_partial_masked_split_is_exact(card):
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(card) for s in ((2, 4, 64), (2, 1024, 4, 64),
                                   (2, 1024, 4, 64)))
    length = torch.tensor([100, 0], dtype=torch.int32, device=card)
    m, l, acc = kfa.flash_partial(q, k, v, length, block_s=128)
    assert bool((m[0, :, 1:] == np.float32(kfa.NEG_INF)).all())
    assert bool((m[1] == np.float32(kfa.NEG_INF)).all())
    assert not bool(l[:, :, 1:].any()) and not bool(acc[:, :, 1:].any())
    out = kfa.flash_decode_attention(q, k, v, length, block_s=128)
    assert not bool(out[1].any())
    trunc = kfa.flash_decode_attention_plain(q[:1], k[:1, :100], v[:1, :100],
                                             100, block_s=128)
    torch.testing.assert_close(out[:1], trunc, rtol=2e-4, atol=2e-4)


def _attention_inputs(seed, B, H, hkv, d, S, dtype, card):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, hkv, d))
                             .astype(np.float32)).to(card, dtype)
            for _ in range(2))
    return q.to(card), k, v


# kernel 2's partial pass at block_s = 512: a warp's tile is 8 positions at
# d = 128 in 16-bit types (4 in f32), tile t goes to warp t % 8, and each
# warp's ring has 3 slots; these lengths end mid-tile, mid-ring and one
# position either side of a split
PIPE_LENGTHS = [1, 5, 9, 31, 33, 95, 97, 100, 511, 513, 1021]


@pytest.mark.parametrize("G", [1, 3, 8, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_pipeline_edges(card, dtype, G):
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    hkv, d, S = 2, 128, 1024
    B = len(PIPE_LENGTHS) + 1
    q, k, v = _attention_inputs(G, B, hkv * G, hkv, d, S, dtype, card)
    length = torch.tensor(PIPE_LENGTHS + [0], dtype=torch.int32,
                          device=card)
    outs = [kfa.flash_decode_attention(q, k, v, length) for _ in range(2)]
    plain = kfa.flash_decode_attention_plain(q, k, v, length)
    torch.testing.assert_close(outs[0], plain, rtol=tol, atol=tol)
    assert torch.equal(outs[0], outs[1])
    assert not bool(outs[0][-1].any())            # a row of length 0
    m, l, acc = kfa.flash_partial(q, k, v, length)
    pm, pl, pacc = kfa.flash_partial_plain(q, k, v, length)
    torch.testing.assert_close(m, pm, rtol=tol, atol=tol)
    torch.testing.assert_close(l, pl, rtol=tol, atol=tol)
    torch.testing.assert_close(acc, pacc, rtol=tol, atol=tol)
    assert bool((m[-1] == np.float32(kfa.NEG_INF)).all())
    assert not bool(l[-1].any()) and not bool(acc[-1].any())


@pytest.mark.parametrize("S", [1, 3, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cache_shorter_than_a_tile(card, dtype, S):
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    q, k, v = _attention_inputs(S, 2, 6, 2, 64, S, dtype, card)
    length = torch.tensor([S, S - 1], dtype=torch.int32, device=card)
    out = kfa.flash_decode_attention(q, k, v, length)
    plain = kfa.flash_decode_attention_plain(q, k, v, length)
    torch.testing.assert_close(out, plain, rtol=tol, atol=tol)
    assert torch.equal(out, kfa.flash_decode_attention(q, k, v, length))


@pytest.mark.parametrize("d", [80, 256])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_flash_attention_head_dims_f32(card, d, G):
    hkv, S = 2, 1500
    q, k, v = _attention_inputs(d + G, 3, hkv * G, hkv, d, S, torch.float32,
                                card)
    length = torch.tensor([S, 700, 37], dtype=torch.int32, device=card)
    outs = [kfa.flash_decode_attention(q, k, v, length, block_s=256)
            for _ in range(2)]
    plain = kfa.flash_decode_attention_plain(q, k, v, length, block_s=256)
    torch.testing.assert_close(outs[0], plain, rtol=2e-4, atol=2e-4)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_unaligned_rows(card, dtype):
    """K and V whose rows are not 16-byte aligned take the element-wise
    copies (one element per lane, 8 query rows a pass)."""
    B, H, hkv, d, S = 2, 6, 2, 64, 700
    q, k, v = _attention_inputs(31, B, H, hkv, d, S, dtype, card)
    wide = [torch.zeros(B, S, hkv, d + 1, device=card, dtype=dtype)
            for _ in range(2)]
    wide[0][..., 1:] = k
    wide[1][..., 1:] = v
    ku, vu = (w[..., 1:] for w in wide)
    length = torch.tensor([S, 333], dtype=torch.int32, device=card)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    out = kfa.flash_decode_attention(q, ku, vu, length, block_s=128)
    plain = kfa.flash_decode_attention_plain(q, k, v, length, block_s=128)
    torch.testing.assert_close(out, plain, rtol=tol, atol=tol)
    torch.testing.assert_close(
        out, kfa.flash_decode_attention(q, k, v, length, block_s=128),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [64, 300])
def test_flash_combine_carry_on_card(card, d):
    """The combine pass with a carry, folding in place and normalising, at
    a head_dim within and beyond one 256-element chunk."""
    rng = np.random.default_rng(d)
    B, H, n = 2, 5, 37
    parts = (torch.from_numpy(rng.standard_normal((B, H, n)).astype(
                 np.float32) * 3),
             torch.from_numpy(rng.uniform(0.5, 50, (B, H, n)).astype(
                 np.float32)),
             torch.from_numpy(rng.standard_normal((B, H, n, d)).astype(
                 np.float32)))
    parts[0][:, :, 5] = kfa.NEG_INF                  # a masked split
    parts[1][:, :, 5] = 0.0
    parts[2][:, :, 5] = 0.0
    carry = (torch.from_numpy(rng.standard_normal((B, H)).astype(
                 np.float32)),
             torch.from_numpy(rng.uniform(1, 9, (B, H)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal((B, H, d)).astype(
                 np.float32)))
    expect = kfa.flash_combine_plain(parts, carry=carry)
    dparts = tuple(t.to(card) for t in parts)
    dcarry = tuple(t.to(card) for t in carry)
    assert kfa.flash_combine(dparts, carry=dcarry) is dcarry
    for got, want in zip(dcarry, expect):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    out = kfa.flash_combine(None, carry=dcarry, normalise=True,
                            out_dtype=torch.bfloat16)
    want = kfa.flash_combine_plain(None, carry=expect, normalise=True,
                                   out_dtype=torch.bfloat16)
    torch.testing.assert_close(out.cpu().float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("kv_dtype", [np.float32, np.float16])
def test_ooc_attention_modes_agree_on_card(card, kv_dtype):
    rng = np.random.default_rng(9)
    S, H, hkv, d = 8192, 24, 8, 128
    q = rng.standard_normal((H, d)).astype(np.float32)
    k, v = (rng.standard_normal((S, hkv, d)).astype(kv_dtype)
            for _ in range(2))
    budget = S * hkv * d * k.itemsize
    part = T.plan_attention_partition(S, hkv, d, budget, k.itemsize)
    stats = T.schedule_stats(T.build_attention_schedule(part, hkv, d, H))
    outs = []
    for mode in ("issue_order", "concurrent"):
        ex = T.ScheduleExecutor(mode=mode, record_spans=True)
        before = kfa.flash_partial.launches
        outs.append(T.ooc_attention(q, k, v, budget_bytes=budget,
                                    executor=ex))
        assert kfa.flash_partial.launches - before == part.nblocks
        assert (ex.last_h2d_bytes, ex.last_d2h_bytes) \
            == (stats["h2d_bytes"], stats["d2h_bytes"])
    assert part.nblocks == 4
    assert torch.equal(outs[0], outs[1])
    expect = kfa.flash_decode_attention_plain(
        torch.from_numpy(q)[None], torch.from_numpy(k)[None].float(),
        torch.from_numpy(v)[None].float(), S)[0]
    torch.testing.assert_close(outs[0], expect, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["issue_order", "concurrent"])
def test_page_locked_cache_equals_pageable_bitwise(card, mode):
    """MiniMax-Text-01's group (8 query heads on 1 KV head, d 128) over a
    bf16 cache: the call from the cache page-locked in place, every block
    copied straight from it, gives the pageable (staged) call's output bit
    for bit, with the same byte counts; the lock is released after."""
    g = torch.Generator().manual_seed(33)
    S, H, hkv, d = 300_000, 8, 1, 128
    q = torch.randn(H, d, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(S, hkv, d, generator=g).to(torch.bfloat16)
            for _ in range(2))
    budget = 32 << 20
    part = T.plan_attention_partition(S, hkv, d, budget, 2)
    stats = T.schedule_stats(T.build_attention_schedule(part, hkv, d, H))
    assert part.nblocks >= 3 and S % part.bs
    ex = T.ScheduleExecutor(mode=mode, record_spans=True)
    staged = T.ooc_attention(q, k, v, budget_bytes=budget, executor=ex)
    assert ex.last_direct_h2d_bytes == 0
    assert ex.last_stage_seconds > 0
    with T.page_lock(k) as lk, T.page_lock(v) as lv:
        assert lk.locked and lv.locked and k.is_pinned() and v.is_pinned()
        assert k[5:].is_pinned()
        assert not T.page_lock(k).locked      # already page-locked
        direct = T.ooc_attention(q, k, v, budget_bytes=budget, executor=ex)
        assert ex.last_direct_h2d_bytes == ex.last_h2d_bytes \
            == stats["h2d_bytes"]
        assert ex.last_stage_seconds == 0
        assert ex.last_d2h_bytes == stats["d2h_bytes"]
    assert not k.is_pinned() and not v.is_pinned()
    lk.release()
    assert torch.equal(staged, direct)
    expect = kfa.flash_decode_attention_plain(
        q[None].float(), k[None].float(), v[None].float(), S)[0]
    torch.testing.assert_close(direct.float(), expect, rtol=2e-2,
                               atol=2e-2)


def test_page_locked_gemm_equals_staged_bitwise(card):
    """A GEMM whose A and B are page-locked (A's row blocks go direct, B's
    column blocks and C stage) equals the all-staged call bit for bit."""
    M, N, K = 2048, 1536, 1024
    A, B, C = (torch.from_numpy(x) for x in _inputs(7, M, N, K))
    budget = (A.nbytes + B.nbytes + C.nbytes) // 4
    staged = T.ooc_gemm(A, B, C, beta=0.5, budget_bytes=budget)
    ex = T.ScheduleExecutor()
    rt = T.HostOocRuntime(T.Device("HBM", 0, budget), executor=ex)
    with T.page_lock(A), T.page_lock(B):
        direct = T.ooc_gemm(A, B, C, beta=0.5, budget_bytes=budget,
                            runtime=rt)
        assert 0 < ex.last_direct_h2d_bytes < ex.last_h2d_bytes
    assert torch.equal(staged, direct)
    np.testing.assert_allclose(
        direct.numpy(), A.numpy().astype(np.float64) @ B.numpy()
        + 0.5 * C.numpy(), rtol=1e-4, atol=1e-4)


# the shapes of tests/test_kernels.py's block GEMM tests, a ragged one and
# one of 256-multiples
DIRECT_SHAPES = [(128, 128, 128), (256, 384, 512), (300, 200, 150),
                 (512, 128, 257), (64, 64, 64), (1000, 999, 1001),
                 (512, 768, 256)]


@pytest.mark.parametrize("M,N,K", DIRECT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_direct_vmem_kernel_matches_plain_version(card, dtype, M, N, K):
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    A, B, C = (torch.from_numpy(x).to(card, dtype)
               for x in _inputs(M * N + K, M, N, K))
    C_before = C.clone()
    before = D.direct_vmem_ooc_gemm.launches
    blocks = ((256, 256, 256), (128, 64, 32), (64, 128, 16), (64, 64, 64))
    outs = [D.direct_vmem_ooc_gemm(A, B, C, 1.25, 0.5, block=blk)
            for blk in blocks]
    again = D.direct_vmem_ooc_gemm(A, B, C, 1.25, 0.5)
    assert D.direct_vmem_ooc_gemm.launches == before + len(blocks) + 1
    plain = D.direct_vmem_ooc_gemm_plain(A, B, C, 1.25, 0.5)
    assert outs[0].dtype == dtype and tuple(outs[0].shape) == (M, N)
    torch.testing.assert_close(outs[0].float(), plain.float(), rtol=tol,
                               atol=tol)
    assert all(torch.equal(outs[0], o) for o in outs[1:] + [again])
    assert torch.equal(C, C_before)
    # the same instruction sequence and k order as kernel 1: the same bits
    assert torch.equal(outs[0], block_matmul(A, B, C, alpha=1.25, beta=0.5))


def test_direct_vmem_takes_row_strided_views(card):
    A, B, C = (torch.from_numpy(x).to(card) for x in _inputs(8, 200, 136, 72))
    wide = torch.zeros(200, 100, device=card)
    wide[:, 20:92] = A
    assert torch.equal(D.direct_vmem_ooc_gemm(wide[:, 20:92], B, C, 1.5, 0.5),
                       D.direct_vmem_ooc_gemm(A, B, C, 1.5, 0.5))
    with pytest.raises(ValueError, match="column stride"):
        D.direct_vmem_ooc_gemm(A.T.contiguous().T, B, C, 1.5, 0.5)


def test_direct_vmem_failures_raise(card, monkeypatch):
    A, B, C = (torch.from_numpy(x).to(card) for x in _inputs(2, 64, 64, 64))
    before = D.direct_vmem_ooc_gemm.launches

    def no_nvcc(name):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(_build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        D.direct_vmem_ooc_gemm(A, B, C, 1.0, 0.0)

    class Refused:                  # a launch CUDA refuses
        argtypes = ()

        def __call__(self, *args):
            return 9                # cudaErrorInvalidConfiguration

    lib = type("Lib", (), {"repro_direct_vmem_gemm": Refused()})()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    with pytest.raises(RuntimeError, match="launch failed"):
        D.direct_vmem_ooc_gemm(A, B, C, 1.0, 0.0)
    assert D.direct_vmem_ooc_gemm.launches == before


def test_direct_host_equals_ooc_gemm_bitwise(card):
    """At 1536x1024x512 under a fifth of the operands both partitions are
    8x4 blocks of 192x256: the same blocks through kernel 1, the same bits
    and the same bytes."""
    M, N, K = 1536, 1024, 512
    A, B, C = _inputs(6, M, N, K)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 5
    ex_lib = T.ScheduleExecutor()
    lib = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=budget,
                     runtime=T.HostOocRuntime(executor=ex_lib))
    ex = T.ScheduleExecutor()
    before = block_matmul.launches
    out = D.direct_host_ooc_gemm(A, B, C, 1.5, 0.5, budget, executor=ex)
    assert block_matmul.launches - before == 32
    assert torch.equal(out, lib)
    assert (ex.last_h2d_bytes, ex.last_d2h_bytes) \
        == (ex_lib.last_h2d_bytes, ex_lib.last_d2h_bytes)


def test_engine_streams_persist_across_concurrent_runs(card):
    """A handler that allocates on its op's stream reuses that stream's
    cached blocks from the executor's second run on: the same engine
    streams, no cudaMalloc."""
    def dgemm_with_scratch(st, op, ref):
        c = st.bufs[op.buffers_written[0]]
        scratch = torch.empty_like(c)
        block_matmul(st.bufs[op.buffers_read[0]],
                     st.bufs[op.buffers_read[1]], c,
                     alpha=st.ctx["alpha"], beta=st.ctx["beta"], out=scratch)
        c.copy_(scratch)

    A, B, C = _inputs(11, 640, 512, 256)
    part = T.plan_gemm_partition(640, 512, 256,
                                 (A.nbytes + B.nbytes + C.nbytes) // 4, 4)
    sched = T.build_gemm_schedule(part, nstreams=2, nbuf=2)
    ex = T.ScheduleExecutor(mode="concurrent",
                            handlers={"dgemm": dgemm_with_scratch})
    outs, streams, mallocs = [], [], []
    for _ in range(2):
        out = torch.from_numpy(C.copy())
        torch.cuda.synchronize()
        n0 = torch.cuda.memory_stats()["num_device_alloc"]
        ex.run(sched, {"A": A, "B": B}, {"C": out},
               {"alpha": 1.5, "beta": 0.5})
        mallocs.append(torch.cuda.memory_stats()["num_device_alloc"] - n0)
        streams.append([s.cuda_stream for s in ex._engine_streams])
        outs.append(out)
    assert len(streams[0]) == len(T.compile_executable(sched).engines)
    assert streams[0] == streams[1]
    assert mallocs[1] == 0, mallocs
    assert torch.equal(outs[0], outs[1])


# ------------------------------------------------------- factorizations
def _factor_input(kind, n, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    if kind == "cholesky":
        M = M @ M.T / n + np.eye(n)
    return M.astype(np.float32)


FACTORS = {"cholesky": T.ooc_cholesky, "lu": T.ooc_lu}


def _factor_arrays(kind, res):
    return res if kind == "lu" else (res,)


def _card_budget(kind, n, panel, parity_bytes):
    """A budget that leaves ``parity_bytes`` for the schedule's buffers on
    the card once the panel ops' workspace is charged, so the card plans
    as the CPU does at ``parity_bytes``."""
    return panel_workspace_bytes(kind, n, panel, 4, "cuda") + parity_bytes


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_factorizations_match_the_cpu(card, kind):
    """Out of core on the card (cuSOLVER panels, kernel 1 trailing blocks)
    against the port on the CPU: the same pivots, the factor within the
    reference tests' f32 tolerance (5e-6 of the largest entry for
    Cholesky; LU by its reconstruction, whose values round apart more)."""
    n, panel = 384, 96
    A = _factor_input(kind, n, 31)
    kw = dict(panel=panel, validate=True)
    got = _factor_arrays(kind, FACTORS[kind](
        A, budget_bytes=_card_budget(kind, n, panel, A.nbytes), **kw))
    cpu = _factor_arrays(kind, FACTORS[kind](
        A, budget_bytes=A.nbytes, torch_device="cpu", **kw))
    assert all(t.device.type == "cpu" for t in got)
    if kind == "cholesky":
        scale = cpu[0].abs().max().item()
        torch.testing.assert_close(got[0], cpu[0], rtol=0, atol=5e-6 * scale)
        return
    LU, perm = got
    assert torch.equal(perm, cpu[1])
    L = torch.tril(LU.double(), -1) + torch.eye(n, dtype=torch.float64)
    rel = (torch.from_numpy(A).double()[perm] - L @ torch.triu(LU.double())
           ).abs().max().item() / float(np.abs(A).max())
    assert rel < 5e-6, rel
    assert torch.tril(LU, -1).abs().max().item() <= 1.0 + 1e-6


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_factor_modes_and_loop_agree_bitwise(card, kind):
    """The entry point, both executor modes (cold and warm) and the
    ``backend="vmem"`` loop give the same bits: kernel 1 sums each trailing
    element in one order whatever the blocks, and the panel ops see the
    same panels.  Bytes equal ``schedule_stats`` and kernel 1 launches once
    per ``dgemm`` op."""
    n, panel = 512, 128
    A = _factor_input(kind, n, 32)
    budget = _card_budget(kind, n, panel, A.nbytes)
    spec = _plan_factor_spec(kind, n, panel, budget, 4, 1, 2, "cuda")
    stats = T.schedule_stats(T.compile_factor_pipeline(spec))
    n_dgemm = sum(1 for op in T.compile_factor_pipeline(spec).ops
                  if isinstance(op.payload, T.BlockRef)
                  and op.payload.kernel == "dgemm")
    first = _factor_arrays(kind, FACTORS[kind](A, panel=panel,
                                               budget_bytes=budget))
    for mode in ("issue_order", "concurrent"):
        ex = T.ScheduleExecutor(mode=mode, record_spans=True)
        for _ in range(2):
            before = block_matmul.launches
            got = _factor_arrays(kind, FACTORS[kind](
                A, panel=panel, budget_bytes=budget, executor=ex))
            assert block_matmul.launches - before == n_dgemm
            assert (ex.last_h2d_bytes, ex.last_d2h_bytes) \
                == (stats["h2d_bytes"], stats["d2h_bytes"])
            assert all(torch.equal(a, b) for a, b in zip(got, first)), mode
    loop = _factor_arrays(kind, FACTORS[kind](A, panel=panel,
                                              budget_bytes=budget,
                                              backend="vmem"))
    assert all(torch.equal(a, b) for a, b in zip(loop, first))


@pytest.mark.parametrize("backend", ["host", "vmem"])
@pytest.mark.parametrize("mode", ["issue_order", "concurrent"])
def test_cholesky_of_an_indefinite_matrix_raises(card, mode, backend):
    """cuSOLVER's status is read after the run: a matrix that is not SPD
    raises instead of returning a factor."""
    A = _factor_input("cholesky", 384, 33)
    A[300, 300] = -100.0
    ex = T.ScheduleExecutor(mode=mode) if backend == "host" else None
    with pytest.raises(torch.linalg.LinAlgError, match="POTRF"):
        T.ooc_cholesky(A, panel=96,
                       budget_bytes=_card_budget("cholesky", 384, 96,
                                                 A.nbytes),
                       backend=backend, executor=ex)


@pytest.mark.parametrize("mode", ["issue_order", "concurrent"])
@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_factor_peak_memory_within_budget(card, kind, mode):
    """``budget_bytes`` covers the panel ops' device workspace (GETRF's
    column-major panel copy, POTRF's factor, the libraries' workspace):
    a run's peak device memory stays within it, on a fresh executor whose
    ``concurrent`` streams are new to cuBLAS, and the schedule's buffers
    take no more than what is left."""
    n, panel = 4096, 512
    A = _factor_input(kind, n, 35)
    charged = panel_workspace_bytes(kind, n, panel, 4, "cuda")
    budget = charged + A.nbytes // 4
    ex = T.ScheduleExecutor(mode=mode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    FACTORS[kind](A, panel=panel, budget_bytes=budget, executor=ex)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= budget, (peak, budget)
    assert ex.last_buffer_bytes <= budget - charged


@pytest.mark.parametrize("mode", ["issue_order", "concurrent"])
def test_integer_and_mixed_operands_on_card(card, mode):
    """Integer operands are exact and an f16 A with an f32 B returns f16,
    on the host pipeline, the vmem backend and in core."""
    rng = np.random.default_rng(34)
    A = rng.integers(0, 5, (400, 200)).astype(np.int32)
    B = rng.integers(0, 5, (200, 300)).astype(np.int32)
    exact = A.astype(np.int64) @ B
    rt = T.HostOocRuntime(executor=T.ScheduleExecutor(mode=mode))
    for kw in (dict(runtime=rt, budget_bytes=300_000),
               dict(backend="vmem", budget_bytes=300_000),
               dict(budget_bytes=1 << 30)):
        out = T.ooc_gemm(A, B, **kw)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.cpu().numpy(), exact)
        h = T.ooc_gemm(A.astype(np.float16), B.astype(np.float32), **kw)
        assert h.dtype == torch.float16
        np.testing.assert_allclose(h.cpu().float().numpy(), exact,
                                   rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------ fault recovery
def _quiet():
    return TF.FaultPolicy(sleep=lambda s: None)


def _dgemm_ops(sched):
    return sum(1 for op in sched.ops if isinstance(op.payload, T.BlockRef)
               and op.payload.kernel == "dgemm")


def _replayed_dgemms(sched, injected):
    """Kernel 1's extra launches: the ``dgemm`` ops of the redo-set of each
    injected compute fault (the faulted attempt and its chain)."""
    return sum(sum(1 for j in TF.redo_set(sched, i)
                   if sched.ops[j].payload.kernel == "dgemm")
               for i, cls in injected if cls == "compute_nan")


class _Capture:
    """``faults=`` factory that keeps the schedule and the injector."""

    def __init__(self, seed, rate):
        self.seed, self.rate = seed, rate
        self.sched = self.inj = None

    def __call__(self, sched):
        self.sched = sched
        self.inj = TF.FaultPlan.random(self.seed, sched,
                                       self.rate).injector()
        return self.inj


@pytest.mark.parametrize("mode", ["issue_order", "concurrent"])
def test_faulted_mmooc_on_card_bitwise(card, mode):
    """Transfer retries and compute replays on the card give the clean
    run's bits; kernel 1 launches once per ``dgemm`` op and once more per
    replayed one; the nominal bytes equal ``schedule_stats``.  With faults
    armed, ``concurrent`` runs the issue-order loop and equals it."""
    M, N, K = 1536, 1024, 512
    A, B, C = _inputs(41, M, N, K)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 5
    clean = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=budget)
    ex = T.ScheduleExecutor(mode=mode)
    cap = _Capture(3, 0.3)
    before = block_matmul.launches
    out = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=budget,
                     runtime=T.HostOocRuntime(executor=ex), faults=cap,
                     fault_policy=_quiet())
    launches = block_matmul.launches - before
    st = ex.last_fault_stats
    assert torch.equal(out, clean)
    assert st["replayed_ops"] > 0 and st["retries"] > 0
    assert st["replayed_ops"] == sum(len(TF.redo_set(cap.sched, i))
                                     for i, c in cap.inj.injected
                                     if c == "compute_nan")
    assert launches == _dgemm_ops(cap.sched) + st["replayed_ops"]
    stats = T.schedule_stats(cap.sched)
    assert (ex.last_h2d_bytes, ex.last_d2h_bytes) \
        == (stats["h2d_bytes"], stats["d2h_bytes"])
    assert ex.last_snapshot_bytes > 0


def test_faulted_lu_on_card_bitwise(card):
    """A faulted LU on the card — GETRF replays re-park their pivots — has
    the clean run's bits and permutation."""
    n, panel = 512, 128
    A = _factor_input("lu", n, 42)
    budget = _card_budget("lu", n, panel, A.nbytes)
    clean = T.ooc_lu(A, panel=panel, budget_bytes=budget)
    cap = _Capture(5, 0.2)
    ex = T.ScheduleExecutor()
    before = block_matmul.launches
    LU, perm = T.ooc_lu(A, panel=panel, budget_bytes=budget, executor=ex,
                        faults=cap, fault_policy=_quiet())
    launches = block_matmul.launches - before
    assert torch.equal(LU, clean[0]) and torch.equal(perm, clean[1])
    assert ex.last_fault_stats["replayed_ops"] > 0
    assert launches == _dgemm_ops(cap.sched) \
        + _replayed_dgemms(cap.sched, cap.inj.injected)


def test_replay_after_a_landing_reuses_the_buffer_on_card(card):
    """C accumulates two K halves through one A and one B parity buffer;
    the second update is corrupted, so its replay re-runs the first on
    what A and B held before the second halves landed over them — the
    copy-on-write clones, taken on the stream before the landings."""
    A, B, C = _inputs(43, 256, 192, 512)
    dev = T.Device("HBM", 0, 1 << 30)
    sched = T.Schedule(dev, T.StreamFactory.create(dev, 1))
    for h in range(2):
        sched.issue(T.Op(kind=T.OpKind.H2D, tag=f"S(a[{h}])", stream=0,
                         buffers_written=(("A", 0),), bytes=256 * 256 * 4,
                         payload=T.SliceRef("A", h, cols=(256 * h, 256))))
        sched.issue(T.Op(kind=T.OpKind.H2D, tag=f"S(b[{h}])", stream=0,
                         buffers_written=(("B", 0),), bytes=256 * 192 * 4,
                         payload=T.SliceRef("B", h, rows=(256 * h, 256))))
        if h == 0:
            sched.issue(T.Op(kind=T.OpKind.H2D, tag="S(c)", stream=0,
                             buffers_written=(("C", 0),),
                             bytes=256 * 192 * 4,
                             payload=T.SliceRef("C", 0)))
        sched.issue(T.Op(kind=T.OpKind.COMPUTE, tag=f"DGEMM[{h}]",
                         stream=0, buffers_read=(("A", 0), ("B", 0)),
                         buffers_written=(("C", 0),),
                         flops=2 * 256 * 192 * 256,
                         payload=T.BlockRef("dgemm", h)))
    sched.issue(T.Op(kind=T.OpKind.D2H, tag="R(c)", stream=0,
                     buffers_read=(("C", 0),), bytes=256 * 192 * 4,
                     payload=T.SliceRef("C", 0)))
    second = max(i for i, op in enumerate(sched.ops)
                 if op.kind == T.OpKind.COMPUTE)
    outs = []
    for plan in (None, TF.FaultPlan(specs=(
            TF.FaultSpec(op=second, cls="compute_nan"),))):
        out = torch.from_numpy(C.copy())
        ex = T.ScheduleExecutor()
        ex.run(sched, {"A": A, "B": B}, {"C": out},
               {"alpha": 1.0, "beta": 1.0}, faults=plan, policy=_quiet())
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    assert ex.last_fault_stats["replayed_ops"] == 2
    assert ex.last_snapshot_bytes == (256 * 192 * 2 + 256 * 256) * 4
    exact = A.astype(np.float64) @ B + C
    assert np.abs(outs[1].numpy() - exact).max() < 1e-3



# ------------------------------------------------------------ the tuner
def test_calibrate_on_card_rates_finite(card):
    """``calibrate()`` times one-op schedules on the card (CUDA events):
    finite positive rates at the card defaults, and the fingerprint is the
    card's, stable across calls."""
    from repro_torch.tune import calibrate, hardware_fingerprint

    res = calibrate(repeats=2)
    prof = res.profile
    for rate in (prof.h2d_bw, prof.d2h_bw, prof.flops):
        assert np.isfinite(rate) and rate > 0
    assert 0 < prof.per_op_overhead <= 1e-3
    assert "dgemm_4096_s" in res.samples
    assert res.fingerprint == hardware_fingerprint() \
        == hardware_fingerprint("cuda")
    assert res.fingerprint != hardware_fingerprint("cpu")


def _card_tuner(tmp_path):
    from repro_torch.tune import AutoTuner, PlanCache, gpu_profile

    return AutoTuner(profile=gpu_profile(flops=42e12, pcie=45e9),
                     cache=PlanCache(str(tmp_path / "plans.json")),
                     nbuf_options=(1, 2), max_steps=128)


def test_tuned_mmooc_on_card_bitwise(card, tmp_path):
    """``tune="auto"`` on the card: the tuned plan's schedule moves
    ``schedule_stats``'s bytes with one launch per ``dgemm`` op, its
    result equals the untuned run's bit for bit (K is never split and
    kernel 1 sums each element in one order), and the repeat call is
    served from the cache."""
    A, B, C = _inputs(51, 1536, 1024, 512)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 5
    tuner = _card_tuner(tmp_path)
    ex = T.ScheduleExecutor()
    rt = T.HostOocRuntime(executor=ex)
    before = block_matmul.launches
    out = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=budget, tune="auto",
                     tuner=tuner, runtime=rt)
    plan = tuner.gemm_plan(1536, 1024, 512, budget)
    sched = T.build_gemm_schedule(plan.gemm_partition(), plan.nstreams,
                                  plan.nbuf, traversal=plan.traversal,
                                  evict=plan.evict)
    stats = T.schedule_stats(sched)
    n_dgemm = sum(1 for op in sched.ops if op.kind == T.OpKind.COMPUTE)
    assert block_matmul.launches - before == n_dgemm
    assert (ex.last_h2d_bytes, ex.last_d2h_bytes) \
        == (stats["h2d_bytes"], stats["d2h_bytes"])
    untuned = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=budget)
    assert torch.equal(out, untuned)
    again = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=budget, tune="auto",
                       tuner=tuner)
    assert tuner.searches == 1 and tuner.last_from_cache
    assert torch.equal(again, out)


def test_tuned_cholesky_on_card(card, tmp_path):
    """A tuned Cholesky on the card: the search ran at the budget less the
    panel ops' workspace (the cache key carries it), peak device memory
    stays within the budget, and the factor equals the untuned factor at
    the tuned panel width bit for bit."""
    n, panel = 512, 128
    A = _factor_input("cholesky", n, 52)
    budget = _card_budget("cholesky", n, panel, A.nbytes // 2)
    tuner = _card_tuner(tmp_path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    L = T.ooc_cholesky(A, panel=panel, budget_bytes=budget, tune="auto",
                       tuner=tuner)
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= budget
    charged = budget - panel_workspace_bytes("cholesky", n, panel, 4, "cuda")
    plan = tuner.factor_plan("cholesky", n, panel, charged)
    assert tuner.last_from_cache and plan.budget == charged
    untuned = T.ooc_cholesky(A, panel=plan.param("panel"),
                             budget_bytes=budget)
    assert torch.equal(L, untuned)
    exact = np.linalg.cholesky(A.astype(np.float64))
    assert np.abs(L.numpy() - exact).max() <= 5e-6 * np.abs(exact).max()


def _hybrid_pair(budget):
    from repro_torch.hybrid import DeviceSpec
    from repro_torch.tune import gpu_profile, phi_profile

    return [DeviceSpec("gpu0", gpu_profile(), budget),
            DeviceSpec("phi0", phi_profile(), budget)]


HYBRID_FAST = dict(nbuf_options=(1, 2), max_steps=256)


def test_hybrid_mmooc_on_card_bitwise(card):
    """Two members on one card, each on its executor and streams from a
    pool thread: the hybrid GEMM equals the single-device run bit for bit
    (kernel 1 sums each element in one order and K is never split),
    kernel 1 launches once per ``dgemm`` op of the members' schedules, and
    the summed bytes equal the schedules'.  A warm run makes no
    cudaMalloc (the members' executors and streams are kept)."""
    from repro_torch import hybrid as TH

    M, N, K = 1536, 1024, 512
    A, B, C = _inputs(61, M, N, K)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 5
    hp = TH.plan_hybrid_gemm(M, N, K, _hybrid_pair(budget), **HYBRID_FAST)
    assert len(hp.device_plans) == 2
    ops = sum(_dgemm_ops(TH.device_schedule(hp, dp))
              for dp in hp.device_plans)
    single = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=budget)
    for rep in ("cold", "warm"):
        before = block_matmul.launches
        mallocs = torch.cuda.memory_stats()["num_device_alloc"]
        out, groups = TH.run_hybrid_gemm(A, B, C, 1.5, 0.5, hp)
        mallocs = torch.cuda.memory_stats()["num_device_alloc"] - mallocs
        assert block_matmul.launches - before == ops
        assert torch.equal(out, single), rep
        stats = TH.executor.last_run_stats()
        assert (stats["h2d_bytes"], stats["d2h_bytes"]) \
            == (stats["sched_h2d_bytes"], stats["sched_d2h_bytes"])
        assert [g[0] for g in groups] == ["gpu0", "phi0"]
    assert mallocs == 0


def test_hybrid_attention_on_card(card):
    """The KV cache split across two members on one card: the merged
    partials agree with the single-device run and a float64 oracle, and
    kernel 2 launches twice per ``attn`` op of the members' schedules."""
    from repro_torch import hybrid as TH

    S, hkv, d, H = 65536, 8, 128, 24
    rng = np.random.default_rng(62)
    q = rng.standard_normal((H, d)).astype(np.float32)
    k = torch.from_numpy(rng.standard_normal((S, hkv, d)).astype(
        np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((S, hkv, d)).astype(
        np.float32)).bfloat16()
    budget = k.numel() * 2 // 4
    hp = TH.plan_hybrid_attention(S, hkv, d, H, _hybrid_pair(budget),
                                  dtype=torch.bfloat16)
    assert len(hp.device_plans) == 2
    attn_ops = sum(
        1 for dp in hp.device_plans for op in TH.device_schedule(hp, dp).ops
        if op.kind == T.OpKind.COMPUTE)
    before = kfa.flash_partial.launches + kfa.flash_combine.launches
    out, _ = TH.run_hybrid_attention(q, k, v, hp)
    assert kfa.flash_partial.launches + kfa.flash_combine.launches \
        - before == 2 * attn_ops
    single = T.ooc_attention(q, k, v, budget_bytes=2 * budget)
    assert (out - single).abs().max().item() <= 1e-5
    qd = torch.from_numpy(q).double()
    kd, vd = k.double(), v.double()
    G = H // hkv
    exact = torch.empty((H, d), dtype=torch.float64)
    for kh in range(hkv):
        rows = slice(kh * G, (kh + 1) * G)
        s = qd[rows] @ kd[:, kh].T / np.sqrt(d)
        exact[rows] = torch.softmax(s, dim=-1) @ vd[:, kh]
    assert (out.double() - exact).abs().max().item() <= 2e-4


def test_hybrid_device_lost_rebalances_on_card(card):
    """``device_lost`` at a member's first compute on the card: the dead
    member drains its streams before it returns, its band is recomputed on
    the survivor, and the result equals the clean hybrid run bit for
    bit."""
    from repro_torch import hybrid as TH

    M, N, K = 1536, 1024, 512
    A, B, C = _inputs(63, M, N, K)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 5
    hp = TH.plan_hybrid_gemm(M, N, K, _hybrid_pair(budget), **HYBRID_FAST)
    clean, _ = TH.run_hybrid_gemm(A, B, C, 1.5, 0.5, hp)

    def first_compute_lost(sched):
        i = next(i for i, op in enumerate(sched.ops)
                 if op.kind == T.OpKind.COMPUTE)
        return TF.FaultPlan(specs=(TF.FaultSpec(op=i, cls="device_lost"),))

    for dead in ("gpu0", "phi0"):
        out, groups = TH.run_hybrid_gemm(
            A, B, C, 1.5, 0.5, hp, fault_plans={dead: first_compute_lost},
            fault_policy=_quiet())
        assert torch.equal(out, clean), dead
        assert any(f"rebalance {dead}" in g for g, _ in groups)


# ------------------------------------------------------- trace analysis
@pytest.mark.parametrize("mode", ["issue_order", "concurrent"])
@pytest.mark.parametrize("kind", ["gemm", "cholesky"])
def test_from_spans_places_card_spans(card, kind, mode):
    """A warm run's CUDA-event spans, in either executor mode, place every
    op in its schedule stream's issue order (``concurrent`` spreads a
    schedule stream over engine streams; each op still starts after its
    stream predecessor's completion event) and the attribution tiles the
    spans' window, with bytes, flops and ops equal to ``schedule_stats``
    and a launch per ``dgemm`` op."""
    from repro_torch.obs.analyze import TraceAnalysis

    if kind == "gemm":
        A, B, C = _inputs(21, 1024, 768, 512)
        part = T.plan_gemm_partition(1024, 768, 512,
                                     (A.nbytes + B.nbytes + C.nbytes) // 4,
                                     4)
        sched = T.build_gemm_schedule(part, nstreams=2, nbuf=2)
        args = ({"A": A, "B": B}, lambda: {"C": torch.from_numpy(C.copy())},
                {"alpha": 1.5, "beta": 0.5})
    else:
        n, panel = 1024, 256
        spec = T.factor_pipeline_spec(n, panel, 3 * n * panel * 4 * 2, 4,
                                      kind="cholesky", lookahead=1, nbuf=2)
        sched = T.compile_factor_pipeline(spec, nstreams=2, nbuf=2)
        A = torch.from_numpy(_factor_input("cholesky", n, 22))
        args = ({}, lambda: {"A": A.clone()},
                {"alpha": -1.0, "beta": 1.0, "panel": spec.panel,
                 "n": spec.n})
    ex = T.ScheduleExecutor(mode=mode, record_spans=True)
    operands, outputs, ctx = args
    ex.run(sched, operands, outputs(), ctx)
    before = block_matmul.launches
    ex.run(sched, operands, outputs(), ctx)
    assert block_matmul.launches - before == sum(
        1 for op in sched.ops if op.kind == T.OpKind.COMPUTE
        and op.payload.kernel == "dgemm")
    spans = ex.last_spans
    assert [s[0] for s in spans] == [op.tag for op in sched.ops]
    for si in range(len(sched.streams)):
        mine = [s for s in spans if s[1] == si]
        assert [s[0] for s in sorted(mine, key=lambda s: (s[2], s[3]))] \
            == [s[0] for s in mine]
    ana = TraceAnalysis.from_spans(sched, spans)
    st = T.schedule_stats(sched)
    assert (ana.n_ops, ana.h2d_bytes, ana.d2h_bytes, ana.flops) == (
        st["n_ops"], st["h2d_bytes"], st["d2h_bytes"], st["flops"])
    assert ana.path[0].start == ana.origin == min(s[2] for s in spans)
    assert ana.path[-1].end == ana.makespan == max(s[3] for s in spans)
    assert all(a.end == b.start for a, b in zip(ana.path, ana.path[1:]))
    assert sum(s.duration for s in ana.path) == pytest.approx(
        ana.makespan - ana.origin, abs=ana.tolerance)
    assert ana.verdict in ("transfer-bound", "compute-bound",
                           "dependency-bound")


# ------------------------------------------------------------ model serving
@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2.5-3b",
                                  "deepseek-moe-16b", "rwkv6-1.6b",
                                  "zamba2-1.2b"])
def test_smoke_decode_launches_kernel_2_per_layer_and_step(card, arch):
    """A smoke-size model on the card: each decode step launches kernel 2's
    two passes once per attention layer (every layer of a transformer,
    every shared-attention site of Zamba2, none in RWKV6), and
    teacher-forced decode stays within the reference test's 2e-3 of
    forward's logits (float32, TF32 off)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model

    cfg = get_arch(arch).smoke()
    gen = torch.Generator(device=card).manual_seed(0)
    model = get_model(cfg).init(gen)
    assert model.device.type == "cuda"
    per_step = {"ssm": 0, "hybrid": getattr(model, "n_sites", None)}.get(
        cfg.family, cfg.num_layers)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen,
                         device=card)
    with torch.inference_mode():          # serving records no graph
        full = model.forward(toks)
    assert not full.requires_grad
    logits, cache = model.prefill(toks[:, :5], max_len=12)
    steps = 12 - 5
    before = (kfa.flash_partial.launches, kfa.flash_combine.launches)
    for i in range(5, 12):
        logits, cache = model.decode(cache, toks[:, i])
        torch.testing.assert_close(logits, full[:, i], rtol=2e-3, atol=2e-3)
    assert (kfa.flash_partial.launches - before[0],
            kfa.flash_combine.launches - before[1]) == (
        per_step * steps, per_step * steps)
    assert cache["len"].tolist() == [12, 12]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_decode_apply_kernel_matches_plain(card, dtype):
    """``attention_decode_apply`` on the card (kernel 2) against the same
    call on CPU tensors (its plain version), on one input, at llama3.2-3b's
    head widths; and kernel 2 against the plain mirror of the reference's
    ``decode_attention`` (in 16 bits that one rounds q and p first)."""
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(31)
    D, H, hkv, d, Smax = 256, 24, 8, 128, 700
    p = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             / np.sqrt(shape[0])).to(dtype)
         for k, shape in (("wq", (D, H * d)), ("wk", (D, hkv * d)),
                          ("wv", (D, hkv * d)), ("wo", (H * d, D)))}
    x = torch.from_numpy(rng.standard_normal((3, D)).astype(np.float32)).to(
        dtype)
    kc, vc = (torch.from_numpy(rng.standard_normal(
        (3, Smax, hkv, d)).astype(np.float32)).to(dtype) for _ in range(2))
    length = torch.tensor([0, 300, Smax - 1], dtype=torch.int32)
    kw = dict(n_heads=H, n_kv=hkv, head_dim=d, rope_theta=5e5)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    cpu = [t.clone() for t in (kc, vc)]
    plain = TL.attention_decode_apply(p, x, *cpu, length, **kw)
    gpu = [t.to(card) for t in (kc, vc)]
    before = kfa.flash_partial.launches
    out = TL.attention_decode_apply({k: v.to(card) for k, v in p.items()},
                                    x.to(card), *gpu, length.to(card), **kw)
    assert kfa.flash_partial.launches == before + 1
    torch.testing.assert_close(out.cpu().float(), plain.float(), rtol=tol,
                               atol=tol)
    for g, c in zip(gpu, cpu):
        torch.testing.assert_close(g.cpu(), c, rtol=tol, atol=tol)
    q = torch.from_numpy(rng.standard_normal((3, H, d)).astype(
        np.float32)).to(card, dtype)
    kern = kfa.flash_decode_attention(q, gpu[0], gpu[1], length.to(card) + 1)
    mirror = TL.decode_attention(q, gpu[0], gpu[1], length.to(card) + 1)
    torch.testing.assert_close(kern.float(), mirror.float(), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b",
                                  "zamba2-1.2b"])
def test_smoke_train_step_on_card_matches_cpu(card, arch):
    """One smoke train step (float32, TF32 off) on the card against the
    same step on the CPU from the same weights and batch: the loss within
    1e-5, ``grad_norm`` within 1e-4 and the first moment (a tenth of the
    clipped gradient) per leaf within 1e-3 of its largest magnitude; then
    AdamW fed the same gradients on both sides, the parameters within
    1e-6.  (After each side's own step the parameters are not compared:
    the first Adam step moves a weight by about lr times the sign of its
    gradient, so a gradient within rounding of zero may go either way.)"""
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.training import steps as tsteps

    cfg = get_arch(arch).smoke()
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    gen = torch.Generator().manual_seed(0)
    cpu = get_model(cfg, device="cpu").init(gen)
    gpu = get_model(cfg).init(torch.Generator(device=card))
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
        for k in ("inputs", "labels")}
    out = []
    for model in (cpu, gpu):
        state = tsteps.train_state(model, opt)
        step = tsteps.build_train_step(model, opt)
        out.append(step(state, {k: v.to(model.device)
                                for k, v in batch.items()}))
    (sc, mc), (sg, mg) = out
    for key, tol in (("loss", 1e-5), ("grad_norm", 1e-4)):
        torch.testing.assert_close(mg[key].cpu(), mc[key], rtol=tol,
                                   atol=tol)
    for name, m in sc["opt"]["m"].items():
        err = (sg["opt"]["m"][name].cpu() - m).abs().max()
        assert err <= 1e-3 * max(float(m.abs().max()), 1e-30), name
    grads = {k: torch.randn(p.shape, generator=gen)
             for k, p in cpu.named_parameters()}
    gpu.load_state_dict(cpu.state_dict())       # the same weights again
    states = []
    for model in (cpu, gpu):
        state = tsteps.train_state(model, opt)
        adamw.update({k: g.to(model.device) for k, g in grads.items()},
                     state["opt"], state["params"], opt)
        states.append(state)
    for name, p in states[0]["params"].items():
        torch.testing.assert_close(states[1]["params"][name].detach().cpu(),
                                   p.detach(), rtol=1e-6, atol=1e-6)


def test_checkpoint_roundtrip_of_card_tensors(card, tmp_path):
    """A train state on the card saved (async) and restored onto card
    tensors bit for bit, bf16 leaves included."""
    from repro_torch.checkpoint import CheckpointManager

    gen = torch.Generator(device=card).manual_seed(1)
    state = {"params": {"w": torch.randn(64, 32, generator=gen,
                                         device=card).to(torch.bfloat16)},
             "opt": {"m": {"w": torch.randn(64, 32, generator=gen,
                                            device=card)},
                     "count": torch.tensor(4, dtype=torch.int32,
                                           device=card)}}
    keep = {"w": state["params"]["w"].clone(),
            "m": state["opt"]["m"]["w"].clone()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state, data_cursor=4)
    state["params"]["w"].add_(1.0)        # after the snapshot
    mgr.wait()
    target = {"params": {"w": torch.zeros(64, 32, dtype=torch.bfloat16,
                                          device=card)},
              "opt": {"m": {"w": torch.zeros(64, 32, device=card)},
                      "count": torch.zeros((), dtype=torch.int32,
                                           device=card)}}
    restored, cursor = mgr.restore(mgr.latest_step(), target)
    assert cursor == 4 and restored["params"]["w"].device.type == "cuda"
    assert torch.equal(restored["params"]["w"], keep["w"])
    assert torch.equal(restored["opt"]["m"]["w"], keep["m"])
    assert int(restored["opt"]["count"]) == 4


@pytest.mark.parametrize("dtype", GEMM_DTYPES)
def test_one_rank_mesh_ring_equals_in_core_bitwise(card, dtype):
    """The MESH tier's ring and ``direct_mesh_ooc_gemm`` on a one-rank
    NCCL group: one launch of kernel 1 on the whole problem, no transfer,
    C row-sharded (one shard) and bit for bit the in-core launch's."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh, shutdown

    M, N, K = 384, 256, 320
    A, B, C = (torch.from_numpy(x).to(dtype) for x in _inputs(24, M, N, K))
    incore = T.ooc_gemm(A, B, C, 1.5, 0.5,
                        budget_bytes=sum(t.numel() * t.element_size()
                                         for t in (A, B, C)))
    init_distributed("cuda")
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh((1,), ("model",))
        rt = T.MeshOocRuntime(mesh)
        assert rt.mem_size() == torch.cuda.get_device_properties(
            card).total_memory
        block_matmul.launches = 0
        out = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=rt.mem_size(),
                         backend="mesh", runtime=rt)
        assert block_matmul.launches == 1 and rt.last_p2p_bytes == 0
        assert out.placements[0].is_shard(0)
        assert torch.equal(out.to_local().cpu(), incore)
        direct = D.direct_mesh_ooc_gemm(A, B, C, 1.5, 0.5, mesh)
        assert torch.equal(direct.full_tensor().cpu(), incore)
    finally:
        shutdown()


def test_sharded_smoke_steps_on_one_rank_match_plain(card):
    """The sharded train and decode steps (DTensors on a one-rank NCCL
    (data, model) mesh, the weight gather on) of llama3.2-3b,
    deepseek-moe-16b, rwkv6-1.6b and zamba2-1.2b smoke against the plain
    steps on the card (kernel 2 in both decodes), within 1e-5."""
    from _torch_dist import sharded_steps_rank
    from repro_torch.launch.mesh import init_distributed, shutdown

    archs = ["llama3.2-3b", "deepseek-moe-16b", "rwkv6-1.6b", "zamba2-1.2b"]
    init_distributed("cuda")
    try:
        res = sharded_steps_rank(0, 1, archs, (1, 1), device="cuda")
    finally:
        shutdown()
    for arch, r in res.items():
        l0, l1 = r["loss"]
        assert abs(l0 - l1) <= 1e-5 * max(1.0, abs(l0)), (arch, r)
        for k in ("param_err", "opt_err", "decode_err", "cache_err"):
            assert r[k] <= 1e-5, (arch, k, r[k])


@pytest.mark.parametrize("slices", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sequence_split_kernel_2_matches_unsplit(card, dtype, slices):
    """Sequence-parallel decode's kernel-2 path on the card: a decode cache
    (B 4, 544 positions, rows at 528, 0 and 543) cut into slices, each
    slice's write and partial pass (``layers.seq_slice_partials``), the
    combine pass over their partials in slice order
    (``layers.seq_combine``), against the same write and the unsplit
    kernel 2: 1e-5 in f32, 2^-7 relative (two roundings of the output)
    and 1e-4 absolute in bf16; each pass counted under the path
    ``seq_decode``, once a slice and once."""
    from repro_torch.models.layers import (SEQ_DECODE_PATH, cache_update,
                                           seq_combine, seq_slice_partials)

    rng = np.random.default_rng(7)
    B, S, hkv, G, d = 4, 544, 8, 3, 128
    t = lambda *s: torch.from_numpy(                         # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(card, dtype)
    q, kn, vn = t(B, hkv * G, d), t(B, hkv, d), t(B, hkv, d)
    k0, v0 = t(B, S, hkv, d), t(B, S, hkv, d)
    length = torch.tensor([528, 0, 543, 300], dtype=torch.int32, device=card)
    k_all, v_all = k0.clone(), v0.clone()
    cache_update(k_all, kn, length)
    cache_update(v_all, vn, length)
    want = kfa.flash_decode_attention(q, k_all, v_all, length + 1)
    before = [w.launches_by_path.get(SEQ_DECODE_PATH, 0)
              for w in (kfa.flash_partial, kfa.flash_combine)]
    n = S // slices
    ks, vs = k0.clone(), v0.clone()
    parts = [seq_slice_partials(q, kn, vn, ks[:, r * n:(r + 1) * n],
                                vs[:, r * n:(r + 1) * n], length, r)
             for r in range(slices)]
    out = seq_combine((torch.cat([p[0] for p in parts], -1),
                       torch.cat([p[1] for p in parts], -1),
                       torch.cat([p[2] for p in parts], -2)), q.dtype)
    torch.cuda.synchronize()
    after = [w.launches_by_path.get(SEQ_DECODE_PATH, 0)
             for w in (kfa.flash_partial, kfa.flash_combine)]
    assert [a - b for a, b in zip(after, before)] == [slices, 1]
    assert torch.equal(ks, k_all) and torch.equal(vs, v_all)
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-4, 2**-7)
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol)
    # row 1 (length 0) sees only slice 0: every later slice is exactly empty
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    assert bool((m[1:, 1] == np.float32(kfa.NEG_INF)).all())
    assert not bool(l[1:, 1].any()) and not bool(acc[1:, 1].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sequence_sharded_local_decode_on_one_rank_nccl(card, dtype):
    """``layers.local_decode`` on caches placed (Shard(0), Shard(1)) on a
    one-rank NCCL (data, model) mesh takes the sequence-parallel branch:
    one partial and one combine pass under ``seq_decode`` (the partials
    all-gathered over NCCL between them), the output and the caches
    against the same write and the unsplit kernel 2, at the tolerances of
    ``test_sequence_split_kernel_2_matches_unsplit``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import init_distributed, make_mesh, shutdown
    from repro_torch.models.layers import (SEQ_DECODE_PATH, cache_update,
                                           local_decode)

    rng = np.random.default_rng(11)
    B, S, hkv, G, d = 4, 544, 8, 3, 128
    t = lambda *s: torch.from_numpy(                         # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(card, dtype)
    q, kn, vn = t(B, hkv * G, d), t(B, hkv, d), t(B, hkv, d)
    k0, v0 = t(B, S, hkv, d), t(B, S, hkv, d)
    length = torch.tensor([528, 0, 543, 300], dtype=torch.int32, device=card)
    k_all, v_all = k0.clone(), v0.clone()
    cache_update(k_all, kn, length)
    cache_update(v_all, vn, length)
    want = kfa.flash_decode_attention(q, k_all, v_all, length + 1)
    init_distributed("cuda")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        rep = (Replicate(), Replicate())
        kc, vc = (DTensor.from_local(x, mesh, (Shard(0), Shard(1)))
                  for x in (k0, v0))
        before = [w.launches_by_path.get(SEQ_DECODE_PATH, 0)
                  for w in (kfa.flash_partial, kfa.flash_combine)]
        out = local_decode(*(DTensor.from_local(x, mesh, rep)
                             for x in (q, kn, vn)), kc, vc,
                           DTensor.from_local(length, mesh, rep))
        torch.cuda.synchronize()
        after = [w.launches_by_path.get(SEQ_DECODE_PATH, 0)
                 for w in (kfa.flash_partial, kfa.flash_combine)]
        assert tuple(out.placements) == (Shard(0), Replicate())
        out = out.to_local()
    finally:
        shutdown()
    assert [a - b for a, b in zip(after, before)] == [1, 1]
    assert torch.equal(k0, k_all) and torch.equal(v0, v_all)
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-4, 2**-7)
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol)


def test_dry_run_traces_kernel_2_on_fake_card_tensors(card):
    """On fake ``cuda`` tensors (``FakeTensorMode``) kernel 2's wrappers
    run the fake operators: nothing launches, the flop formulas count."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    before = (kfa.flash_partial.launches, kfa.flash_combine.launches)
    with FakeTensorMode():
        q = torch.empty(4, 24, 128, device=card)
        k = torch.empty(4, 544, 8, 128, device=card, dtype=torch.bfloat16)
        lens = torch.empty(4, dtype=torch.int32, device=card)
        with FlopCounterMode(display=False) as fc:
            kfa.flash_decode_attention(q, k, k, lens)
    assert fc.get_total_flops() == 4 * 4 * 24 * 544 * 128 \
        + 2 * 4 * 24 * 2 * 128
    assert (kfa.flash_partial.launches, kfa.flash_combine.launches) == before


# ------------------------------------------------------------------------
# The executor paths of the paper's claims (chip_smoke.py phase 18) at
# test sizes: the vendor schedule, one stream with one buffer, the
# completion order, the reuse claim and a seeded stress loop
# ------------------------------------------------------------------------
def _dgemm_ops(sched):
    return sum(1 for op in sched.ops if isinstance(op.payload, T.BlockRef)
               and op.payload.kernel == "dgemm")


@pytest.mark.parametrize("mode", ["issue_order", "concurrent"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vendor_schedule_equals_in_core_bitwise(card, dtype, mode):
    """The CUBLAS-XT-style schedule (one stream, one buffer, B re-sent for
    every C tile) on the executor and kernel 1 equals one in-core launch
    bit for bit, moving ``schedule_stats``' bytes."""
    M, N, K = 1280, 1536, 640
    A, B, C = (torch.from_numpy(x).to(dtype) for x in _inputs(41, M, N, K))
    full = sum(t.numel() * t.element_size() for t in (A, B, C))
    part = T.plan_gemm_partition(M, N, K, full // 4, A.element_size())
    sched = T.build_vendor_schedule(part, tile=256)
    stats = T.schedule_stats(sched)
    incore = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=full)
    ex = T.ScheduleExecutor(mode=mode)
    before = block_matmul.launches
    out = T.HostOocRuntime(executor=ex).gemm(A, B, C, 1.5, 0.5, part,
                                             schedule=sched)
    assert block_matmul.launches - before == _dgemm_ops(sched) == 5 * 6
    assert (ex.last_h2d_bytes, ex.last_d2h_bytes) \
        == (stats["h2d_bytes"], stats["d2h_bytes"])
    assert torch.equal(out, incore)


@pytest.mark.parametrize("traversal", ["col", "row"])
def test_one_stream_one_buffer_concurrent_equals_in_core(card, traversal):
    """nstreams=1, nbuf=1 in concurrent mode: each landing into a parity
    buffer must wait on the device for the kernel that last read it (the
    eviction wiring ``test_release_waits_single_stream_single_buffer``
    pins); a missing wait shows here as a result that is not the
    in-core launch's."""
    M, N, K = 1024, 1280, 768
    A, B, C = _inputs(43, M, N, K)
    full = A.nbytes + B.nbytes + C.nbytes
    part = T.plan_gemm_partition(M, N, K, full // 6, 4, nbuf=1, nstreams=1)
    assert part.h >= 2 and part.w >= 2
    sched = T.build_gemm_schedule(part, nstreams=1, nbuf=1,
                                  traversal=traversal)
    incore = T.ooc_gemm(A, B, C, 1.25, -0.5, budget_bytes=full)
    ex = T.ScheduleExecutor(mode="concurrent")
    for _ in range(3):
        out = T.HostOocRuntime(executor=ex).gemm(A, B, C, 1.25, -0.5, part,
                                                 schedule=sched)
        assert torch.equal(out, incore)


def test_concurrent_completion_order_is_linear_extension_on_card(card):
    from repro_torch.core.streams import dependency_edges

    M, N, K = 1024, 896, 512
    A, B, C = _inputs(45, M, N, K)
    part = T.plan_gemm_partition(M, N, K, (A.nbytes + B.nbytes
                                           + C.nbytes) // 4, 4)
    sched = T.build_gemm_schedule(part, nstreams=2, nbuf=3,
                                  traversal="serpentine")
    ex = T.ScheduleExecutor(mode="concurrent", record_spans=True)
    out = torch.from_numpy(C.copy())
    ex.run(sched, {"A": A, "B": B}, {"C": out}, {"alpha": 1.0, "beta": 1.0})
    order = ex.last_completion_order
    assert sorted(order) == list(range(len(sched.ops)))
    pos = {i: k for k, i in enumerate(order)}
    _, preds = dependency_edges(sched)
    for succ, ps in enumerate(preds):
        assert all(pos[p] < pos[succ] for p in ps)
    assert [s[0] for s in ex.last_spans] == [op.tag for op in sched.ops]
    assert torch.equal(out, T.ooc_gemm(A, B, C, 1.0, 1.0,
                                       budget_bytes=1 << 40))


@pytest.mark.parametrize("mode", ["issue_order", "concurrent"])
def test_new_kernel_via_spec_on_card(card, mode):
    """The reuse claim on the card: a scaled block copy as a PipelineSpec
    and one registered handler (a PyTorch multiply into the output
    buffer), exactly 3.0 * X, with ``schedule_stats``' bytes."""
    M, N, bm = 4096, 1024, 512
    h = M // bm

    @T.register_op_handler("scale_copy")
    def _scale_copy(st, op, ref):
        torch.mul(st.bufs[op.buffers_read[0]], st.ctx["gamma"],
                  out=st.bufs[op.buffers_written[0]])

    def operand(name, inout=False):
        return T.StreamedOperand(
            name=name, nblocks=h, block_of=lambda s: s,
            slice_of=lambda b: T.SliceRef(name, b, rows=(b * bm, bm)),
            bytes_of=lambda b: bm * N * 4, inout=inout)

    spec = T.PipelineSpec(
        name="scale_copy", nsteps=h,
        operands=(operand("X"), operand("Y", inout=True)),
        compute=T.ComputeStage(kernel="scale_copy", reads=("X",),
                               flops_of=lambda s: bm * N),
        writeback=T.WriteBack(mode="each", operand="Y"), budget=8 * 2**20)
    sched = T.compile_pipeline(spec, nstreams=2, nbuf=2)
    T.validate_schedule(sched)
    stats = T.schedule_stats(sched)
    X = torch.from_numpy(np.random.default_rng(47).standard_normal(
        (M, N)).astype(np.float32))
    ex = T.ScheduleExecutor(mode=mode)
    for _ in range(2):
        out = torch.zeros(M, N)
        ex.run(sched, {"X": X}, {"Y": out}, {"gamma": 3.0})
        assert torch.equal(out, 3.0 * X)
        assert (ex.last_h2d_bytes, ex.last_d2h_bytes) \
            == (stats["h2d_bytes"], stats["d2h_bytes"])


def test_concurrent_stress_seeded_with_watchdog_on_card(card):
    """Seeded schedule shapes x repeated runs on one concurrent executor:
    every run equals the in-core launch bit for bit, bytes equal
    ``schedule_stats``; a deadlock dumps every thread's stack and exits
    instead of hanging."""
    import faulthandler

    faulthandler.dump_traceback_later(300.0, exit=True)
    try:
        rng = np.random.default_rng(20260808)
        ex = T.ScheduleExecutor(mode="concurrent")
        for _ in range(8):
            M, N, K = (int(v) * 128 for v in rng.integers(3, 9, size=3))
            nstreams, nbuf = (int(v) for v in rng.integers(1, 4, size=2))
            traversal = ["col", "row", "serpentine"][int(rng.integers(3))]
            A, B, C = _inputs(int(rng.integers(1 << 30)), M, N, K)
            part = T.plan_gemm_partition(
                M, N, K, (A.nbytes + B.nbytes + C.nbytes) // 3, 4,
                nbuf=nbuf, nstreams=nstreams)
            sched = T.build_gemm_schedule(part, nstreams=nstreams,
                                          nbuf=nbuf, traversal=traversal)
            stats = T.schedule_stats(sched)
            incore = T.ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=1 << 40)
            for _rep in range(3):
                out = torch.from_numpy(C.copy())
                ex.run(sched, {"A": A, "B": B}, {"C": out},
                       {"alpha": 1.0, "beta": 0.5})
                assert (ex.last_h2d_bytes, ex.last_d2h_bytes) \
                    == (stats["h2d_bytes"], stats["d2h_bytes"])
                assert torch.equal(out, incore), (
                    f"{M}x{N}x{K} ns={nstreams} nbuf={nbuf} {traversal}")
    finally:
        faulthandler.cancel_dump_traceback_later()
