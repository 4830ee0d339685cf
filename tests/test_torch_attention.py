"""Decode attention in the port against the reference (CPU).

On the CPU the port's flash-decoding wrappers run their plain PyTorch
versions; the reference runs its Pallas kernel in interpret mode, as
``test_kernels.py`` does, and its ``ooc_attention`` on its own executor.
Both get the same inputs, made with numpy from a seed.  Tolerances are the
reference tests' own: 2e-4 (f32) and 3e-2 (bf16) for the kernel as in
``test_kernels.py``, 1e-4 (f32 KV) and 1e-5 (f16 KV) for ``ooc_attention``
as in ``test_oocgemm.py``.  The combine pass is held to
``merge_attention_partials`` at 1e-6: the same arithmetic in the same
order, up to ``exp``'s last bit.  The kernel pair on a card is in
``test_torch_card.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.hybrid.executor import merge_attention_partials
from repro.kernels import ops as R_ops
from repro.kernels import ref as R_ref
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import ref as T_ref

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
LLAMA = dict(H=24, hkv=8, d=128)        # llama3.2-3b attention widths

# the six cases of test_kernels.py: (B, H, hkv, d, S, block_s, dtype, how
# lengths are drawn)
KERNEL_CASES = {
    "gqa": (1, 8, 2, 64, 512, 128, "float32", "random"),
    "mha_ragged_S": (2, 16, 16, 64, 1000, 256, "float32", "random"),
    "mqa": (3, 8, 1, 128, 384, 128, "float32", "random"),
    "odd_head_dim": (2, 4, 4, 80, 300, 128, "float32", "random"),
    "bf16": (2, 8, 2, 64, 512, 128, "bfloat16", "full"),
    "fully_masked_block": (1, 4, 4, 64, 1024, 128, "float32", "short"),
}
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _np32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_flash_decode_matches_pallas(case):
    B, H, hkv, d, S, block_s, dtype, lens = KERNEL_CASES[case]
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(sorted(KERNEL_CASES).index(case))
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, d)).astype(np.float32)
    length = {"random": rng.integers(1, S + 1, (B,)),
              "full": np.full((B,), S),
              "short": np.full((B,), 100)}[lens].astype(np.int32)
    ref_out = R_ops.flash_decode_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(length),
        block_s=block_s, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    out = T_ops.flash_decode_attention(tq, tk, tv, torch.from_numpy(length),
                                       block_s=block_s)
    assert out.dtype == tdt and tuple(out.shape) == (B, H, d)
    np.testing.assert_allclose(_np32(out), _np32(ref_out), rtol=tol,
                               atol=tol)
    oracle = T_ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(length))
    np.testing.assert_allclose(_np32(out), _np32(oracle), rtol=tol, atol=tol)
    if lens == "short":          # identical to the truncated cache
        trunc = R_ref.decode_attention_ref(
            jnp.asarray(q), jnp.asarray(k[:, :100]), jnp.asarray(v[:, :100]),
            jnp.asarray(length))
        np.testing.assert_allclose(_np32(out), _np32(trunc), rtol=tol,
                                   atol=tol)


def test_partial_pass_masks_exactly():
    """A split wholly beyond ``length`` is exactly (NEG_INF, 0, 0), and a row
    of length 0 gives zeros, not NaN."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 64), (2, 1024, 4, 64), (2, 1024, 4, 64)))
    length = torch.tensor([100, 0], dtype=torch.int32)
    m, l, acc = kfa.flash_partial(q, k, v, length, block_s=128)
    assert m.shape == (2, 4, 8) and acc.shape == (2, 4, 8, 64)
    assert bool((m[0, :, 1:] == np.float32(kfa.NEG_INF)).all())
    assert bool((m[1] == np.float32(kfa.NEG_INF)).all())
    assert not bool(l[:, :, 1:].any()) and not bool(acc[:, :, 1:].any())
    assert bool((l[0, :, 0] > 0).all())
    out = kfa.flash_decode_attention(q, k, v, length, block_s=128)
    assert not bool(out[1].any())
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("with_carry", [False, True])
def test_combine_matches_merge_attention_partials(with_carry):
    rng = np.random.default_rng(7 + with_carry)
    H, d, n = 8, 64, 5
    parts = [(rng.standard_normal(H).astype(np.float32) * 3,
              rng.uniform(0.5, 50, H).astype(np.float32),
              rng.standard_normal((H, d)).astype(np.float32) * 10)
             for _ in range(n)]
    parts[2] = (np.full(H, kfa.NEG_INF, np.float32), np.zeros(H, np.float32),
                np.zeros((H, d), np.float32))            # all masked
    expect = merge_attention_partials(parts)

    def stack(i, ps):
        return torch.from_numpy(np.stack([p[i] for p in ps], axis=1)[None]
                                ).contiguous()

    if with_carry:   # the first partial enters as the incoming carry
        carry = tuple(torch.from_numpy(x[None].copy()) for x in parts[0])
        partials = tuple(stack(i, parts[1:]) for i in range(3))
        folded = kfa.flash_combine(partials, carry=carry)
        assert folded is carry
        out = kfa.flash_combine(None, carry=carry, normalise=True)
    else:
        partials = tuple(stack(i, parts) for i in range(3))
        out = kfa.flash_combine(partials, normalise=True)
    np.testing.assert_allclose(out[0].numpy(), expect, rtol=1e-6, atol=1e-6)


def _attention_problem(seed, S, H, hkv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((H, d)).astype(np.float32),
            rng.standard_normal((S, hkv, d)).astype(dtype),
            rng.standard_normal((S, hkv, d)).astype(dtype))


def _oracle(q, k, v):
    return np.asarray(R_ref.decode_attention_ref(
        jnp.asarray(q)[None], jnp.asarray(k, jnp.float32)[None],
        jnp.asarray(v, jnp.float32)[None], jnp.asarray([k.shape[0]]))[0])


# the two cases of test_oocgemm.py: f32 KV, and f16 KV whose f32 carry must
# not be quantized on its way out
OOC_CASES = {"f32": (2048, np.float32, 1e-4), "f16_kv": (1024, np.float16,
                                                         1e-5)}


@pytest.mark.parametrize("nstreams", [1, 2])
@pytest.mark.parametrize("nbuf", [2, 3])
@pytest.mark.parametrize("case", sorted(OOC_CASES))
def test_ooc_attention_matches_reference(case, nstreams, nbuf):
    S, dtype, tol = OOC_CASES[case]
    H, hkv, d = 16, 4, 64
    q, k, v = _attention_problem(S + nstreams + nbuf, S, H, hkv, d, dtype)
    budget = S * hkv * d * 4 // 3
    kw = dict(budget_bytes=budget, nstreams=nstreams, nbuf=nbuf,
              validate=True)
    ref_out = np.asarray(R.ooc_attention(q, k, v, **kw))
    out = T.ooc_attention(q, k, v, torch_device=CPU, **kw)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.dtype == torch.float32 and tuple(out.shape) == (H, d)
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=tol, atol=tol)
    np.testing.assert_allclose(out.numpy(), _oracle(q, k, v), rtol=tol,
                               atol=tol)


def test_ooc_attention_llama_widths():
    """llama3.2-3b's attention widths, S = 4096 over 4 blocks of 1024."""
    S = 4096
    q, k, v = _attention_problem(11, S, **LLAMA)
    budget = 2 * 1024 * 2 * LLAMA["hkv"] * LLAMA["d"] * 4
    assert T.plan_attention_partition(S, LLAMA["hkv"], LLAMA["d"], budget,
                                      4).nblocks == 4
    ref_out = np.asarray(R.ooc_attention(q, k, v, budget_bytes=budget))
    out = T.ooc_attention(q, k, v, budget_bytes=budget, torch_device=CPU)
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), _oracle(q, k, v), rtol=1e-4,
                               atol=1e-4)


def _schedule(S, H, hkv, d, budget, **kw):
    part = T.plan_attention_partition(S, hkv, d, budget, 4)
    return T.build_attention_schedule(part, hkv, d, H, **kw)


def test_ooc_attention_byte_counters_match_schedule_stats():
    S, H, hkv, d = 2048, 16, 4, 64
    q, k, v = _attention_problem(5, S, H, hkv, d)
    budget = S * hkv * d * 4 // 3
    stats = T.schedule_stats(_schedule(S, H, hkv, d, budget))
    ex = T.ScheduleExecutor(torch_device=CPU)
    T.ooc_attention(q, k, v, budget_bytes=budget, executor=ex)
    assert (ex.last_h2d_bytes, ex.last_d2h_bytes) \
        == (stats["h2d_bytes"], stats["d2h_bytes"])
    assert stats["d2h_bytes"] == H * d * 4


def test_attention_concurrent_matches_serial():
    """Twin of test_exec_concurrent.py's: one schedule, both executor
    modes, bitwise equal, and equal to the reference executor at 1e-4."""
    rng = np.random.default_rng(14)
    S, hkv, d, H = 512, 2, 64, 8
    kc = rng.standard_normal((S, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((S, hkv, d)).astype(np.float32)
    q = rng.standard_normal((H, d)).astype(np.float32)
    sched = _schedule(S, H, hkv, d, kc.nbytes, nstreams=2, nbuf=2)
    T.validate_schedule(sched)
    stats = T.schedule_stats(sched)
    outs = {}
    for mode in ("issue_order", "concurrent"):
        ex = T.ScheduleExecutor(torch_device=CPU, mode=mode)
        outs[mode] = torch.zeros((H, d))
        ex.run(sched, {"K": kc, "V": vc}, {"out": outs[mode]}, {"q": q})
        assert (ex.last_h2d_bytes, ex.last_d2h_bytes) \
            == (stats["h2d_bytes"], stats["d2h_bytes"])
    assert torch.equal(outs["issue_order"], outs["concurrent"])
    ref = {"out": np.zeros((H, d), np.float32)}
    R.ScheduleExecutor().run(R.build_attention_schedule(
        R.plan_attention_partition(S, hkv, d, kc.nbytes, 4), hkv, d, H,
        nstreams=2, nbuf=2), {"K": kc, "V": vc}, ref, {"q": jnp.asarray(q)})
    np.testing.assert_allclose(outs["concurrent"].numpy(), ref["out"],
                               rtol=1e-4, atol=1e-4)
