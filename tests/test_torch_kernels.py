"""The port's block GEMM against the Pallas kernel and the oracles.

On the CPU the port's ``block_matmul`` runs its plain PyTorch version; the
reference runs its Pallas kernel in interpret mode, as ``test_kernels.py``
does.  Both get the same inputs, made with numpy from a seed (bf16 inputs
are rounded from the same float32 values on both sides).  The hand-written
kernel against its plain version on a card is in ``test_torch_card.py``,
which imports no JAX so that it also runs on the machine with the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R_ops
from repro.kernels import ref as R_ref
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import ref as T_ref

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, M, N, K):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32),
            rng.standard_normal((M, N)).astype(np.float32))


def _np32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("M,N,K", [
    (128, 128, 128),
    (256, 384, 512),
    (300, 200, 150),      # non-divisible: ragged edges
    (512, 128, 257),
    (64, 64, 64),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_matmul_matches_pallas_and_oracle(M, N, K, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    A, B, C = _inputs(M * 7 + N * 3 + K, M, N, K)
    ja, jb, jc = (jnp.asarray(x, jdt) for x in (A, B, C))
    ta, tb, tc = (torch.from_numpy(x).to(tdt) for x in (A, B, C))
    ref_out = R_ops.block_matmul(ja, jb, jc, alpha=1.25, beta=0.5,
                                 block=(128, 128, 128), interpret=True)
    out = T_ops.block_matmul(ta, tb, tc, alpha=1.25, beta=0.5,
                             block=(128, 128, 128))
    assert out.dtype == tdt and tuple(out.shape) == (M, N)
    np.testing.assert_allclose(_np32(out), _np32(ref_out), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(
        _np32(out), _np32(T_ref.gemm_ref(ta, tb, tc, 1.25, 0.5)),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _np32(T_ref.gemm_ref(ta, tb, tc, 1.25, 0.5)),
        _np32(R_ref.gemm_ref(ja, jb, jc, 1.25, 0.5)), rtol=tol, atol=tol)


@pytest.mark.parametrize("block", [(128, 128, 128), (256, 128, 64),
                                   (64, 256, 128)])
def test_block_matmul_block_shapes(block):
    A, B, _ = _inputs(1, 256, 256, 320)
    C = np.zeros((256, 256), np.float32)
    ref_out = R_ops.block_matmul(jnp.asarray(A), jnp.asarray(B),
                                 jnp.asarray(C), block=block, interpret=True)
    out = T_ops.block_matmul(torch.from_numpy(A), torch.from_numpy(B),
                             torch.from_numpy(C), block=block)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), A @ B, rtol=2e-4, atol=2e-4)


def test_block_matmul_beta_zero():
    A, B, _ = _inputs(2, 128, 128, 128)
    C = np.zeros((128, 128), np.float32)
    out = T_ops.block_matmul(torch.from_numpy(A), torch.from_numpy(B),
                             torch.from_numpy(C), alpha=2.0, beta=0.0)
    ref_out = R_ops.block_matmul(jnp.asarray(A), jnp.asarray(B),
                                 jnp.asarray(C), alpha=2.0, beta=0.0,
                                 block=(128, 128, 128), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=2e-4, atol=2e-4)


def test_block_matmul_out_in_place_on_strided_views():
    """The executor's use: ``out`` is ``c`` itself, a row-strided view."""
    A, B, C = _inputs(3, 96, 80, 40)
    big = torch.zeros(120, 100)
    c = big[10:106, 5:85]
    c.copy_(torch.from_numpy(C))
    res = T_ops.block_matmul(torch.from_numpy(A), torch.from_numpy(B), c,
                             alpha=-1.0, beta=2.0, out=c)
    assert res is c
    np.testing.assert_allclose(c.numpy(), -(A @ B) + 2 * C, rtol=2e-4,
                               atol=2e-4)
    assert float(big[:10].abs().sum()) == 0.0      # nothing outside c


@pytest.mark.parametrize("case", ["shape", "mixed_dtype", "float64",
                                  "column_stride", "block"])
def test_block_matmul_rejects_what_the_kernel_does_not_take(case):
    a, b, c = torch.ones(8, 4), torch.ones(4, 6), torch.ones(8, 6)
    kw = {}
    if case == "shape":
        c = torch.ones(6, 8)
    elif case == "mixed_dtype":
        b = b.to(torch.bfloat16)
    elif case == "float64":
        a, b, c = a.double(), b.double(), c.double()
    elif case == "column_stride":
        b = torch.ones(6, 4).T
    else:
        kw["block"] = (128, 0, 128)
    with pytest.raises((ValueError, TypeError)):
        T_ops.block_matmul(a, b, c, **kw)


def test_block_matmul_counts_only_kernel_launches():
    before = T_ops.block_matmul.launches
    T_ops.block_matmul(torch.ones(8, 4), torch.ones(4, 6), torch.ones(8, 6))
    assert T_ops.block_matmul.launches == before   # CPU: plain version


def test_reference_arrays_carried_across_exactly():
    """``from_reference`` turns reference (JAX) operands into CPU tensors
    bit for bit, bfloat16 included."""
    from repro_torch.core.convert import from_reference

    A, _, _ = _inputs(5, 16, 8, 24)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        got = from_reference(jnp.asarray(A, jdt))
        assert got.dtype == tdt
        assert torch.equal(got, torch.from_numpy(A).to(tdt))
