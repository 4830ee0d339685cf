"""Out-of-core Cholesky and LU in the port against the reference (CPU).

Twins of ``test_factor.py``: the same numpy inputs from a seed go through
``repro.core.ooc_cholesky``/``ooc_lu`` and their ports
(``torch_device="cpu"``: the panel ops run ``torch.linalg`` on the host,
the trailing updates the block GEMM's plain version).  Tolerances are the
reference tests' own: 5e-6 of the factor's largest entry against float64
numpy, 5e-6 (LU reconstruction), 1e-4 (ill-conditioned).  Within the port,
pipeline configurations must agree bit for bit (the CPU path pins one
BLAS thread, see ``one_torch_thread``); the reference holds them only to
rounding.  The factorizations on a card are in ``test_torch_card.py``.
"""

import itertools

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import runtime as R_runtime
from repro.core.api import hclOocFactor as R_hclOocFactor
from repro_torch.core import runtime as T_runtime
from repro_torch.core.api import hclOocFactor

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"


def _spd(rng, n, dtype=np.float32, cond=None):
    """Random SPD matrix; ``cond`` spreads the spectrum geometrically (the
    reference tests' construction)."""
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    if cond is None:
        lam = rng.uniform(1.0, 2.0, n)
    else:
        lam = np.geomspace(1.0, cond, n)
    return (Q * lam @ Q.T + n * np.finfo(np.float32).eps * np.eye(n)) \
        .astype(dtype)


def _square(rng, n, dtype=np.float32, cond=None):
    """Random well- or ill-conditioned square matrix via its SVD."""
    A = rng.standard_normal((n, n))
    if cond is not None:
        U, _, Vt = np.linalg.svd(A)
        A = U * np.geomspace(cond, 1.0, n) @ Vt
    return A.astype(dtype)


def _lu_factors(LU, dtype=np.float64):
    LU = np.asarray(LU, dtype=dtype)
    n = LU.shape[0]
    return np.tril(LU, -1) + np.eye(n, dtype=dtype), np.triu(LU)


def _lu_rel(A, LU, perm) -> float:
    L, U = _lu_factors(LU)
    A = np.asarray(A, dtype=np.float64)
    return np.abs(A[np.asarray(perm)] - L @ U).max() / np.abs(A).max()


FACTOR_CASES = [
    (256, 64),     # divisible
    (300, 96),     # non-divisible (last panel is 12 wide)
    (192, 512),    # panel >= n: a single in-core panel step
    (260, 64),     # non-divisible, small last panel
]


# ------------------------------------------------------------ Cholesky
@pytest.mark.parametrize("n,panel", FACTOR_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cholesky_matches_reference_and_numpy(rng, n, panel, dtype):
    A = _spd(rng, n, dtype)
    kw = dict(panel=panel, budget_bytes=4 * A.nbytes, validate=True)
    L = T.ooc_cholesky(A, torch_device=CPU, **kw)
    ref = R.ooc_cholesky(A, **kw)
    expect = np.linalg.cholesky(A.astype(np.float64))
    scale = np.abs(expect).max()
    assert isinstance(L, torch.Tensor) and L.device.type == "cpu"
    assert L.dtype == torch.from_numpy(A).dtype and ref.dtype == A.dtype
    np.testing.assert_allclose(L.numpy() / scale, expect / scale, rtol=0,
                               atol=5e-6)
    np.testing.assert_allclose(L.numpy() / scale, ref / scale, rtol=0,
                               atol=5e-6)
    assert torch.equal(L, torch.tril(L))


def test_cholesky_ill_conditioned(rng):
    """A 1e5 condition number loses digits but the factorization must stay
    backward-stable: reconstruct A within a modest multiple of f32 eps."""
    A = _spd(rng, 256, cond=1e5)
    L = T.ooc_cholesky(A, panel=64, budget_bytes=4 * A.nbytes, validate=True,
                       torch_device=CPU).double().numpy()
    rel = np.abs(L @ L.T - A).max() / np.abs(A).max()
    assert rel < 1e-4, rel
    ref = R.ooc_cholesky(A, panel=64, budget_bytes=4 * A.nbytes)
    np.testing.assert_allclose(L, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


_CHOL_BASE = {}


def _chol_case():
    if not _CHOL_BASE:
        A = _spd(np.random.default_rng(5), 260, np.float32)
        _CHOL_BASE["A"] = A
        _CHOL_BASE["base"] = T.ooc_cholesky(
            A, panel=96, budget_bytes=4 * A.nbytes, lookahead=0, nstreams=2,
            nbuf=2, torch_device=CPU)
    return _CHOL_BASE["A"], _CHOL_BASE["base"]


@pytest.mark.parametrize("lookahead,nstreams,nbuf", list(itertools.product(
    [0, 1, 2], [1, 2], [1, 2, 3])))
def test_cholesky_invariant_to_pipeline_config(lookahead, nstreams, nbuf):
    """Lookahead depth, stream count and buffer depth are scheduling
    properties: within the port every config gives the same bits (each
    trailing element is one full-K sum in a fixed order), and the
    reference's result for the same config agrees to its tolerance."""
    A, base = _chol_case()
    kw = dict(panel=96, budget_bytes=4 * A.nbytes, lookahead=lookahead,
              nstreams=nstreams, nbuf=nbuf, validate=True)
    got = T.ooc_cholesky(A, torch_device=CPU, **kw)
    assert torch.equal(got, base)
    ref = R.ooc_cholesky(A, **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("backend", ["host", "vmem"])
def test_cholesky_not_spd_raises(rng, backend):
    """An indefinite matrix raises instead of returning garbage, as the
    reference's ``np.linalg.cholesky`` does."""
    A = _spd(rng, 200)
    A[150, 150] = -50.0
    kw = dict(panel=64, budget_bytes=A.nbytes, backend=backend)
    with pytest.raises(np.linalg.LinAlgError):
        R.ooc_cholesky(A, **kw)
    with pytest.raises(torch.linalg.LinAlgError, match="POTRF"):
        T.ooc_cholesky(A, torch_device=CPU, **kw)


# ------------------------------------------------------------------ LU
@pytest.mark.parametrize("n,panel", FACTOR_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lu_reconstructs_with_bounded_multipliers(rng, n, panel, dtype):
    A = _square(rng, n, dtype)
    kw = dict(panel=panel, budget_bytes=4 * A.nbytes, validate=True)
    LU, perm = T.ooc_lu(A, torch_device=CPU, **kw)
    assert LU.dtype == torch.from_numpy(A).dtype and perm.dtype == torch.int64
    # P A = L U within engine (f32) tolerance
    rel = _lu_rel(A, LU, perm)
    assert rel < 5e-6, rel
    # the partial-pivoting invariant: every multiplier is bounded by 1
    assert torch.tril(LU, -1).abs().max().item() <= 1.0 + 1e-6
    ref_LU, ref_perm = R.ooc_lu(A, **kw)
    assert _lu_rel(A, ref_LU, ref_perm) < 5e-6


def test_lu_pivots_match_reference_and_scipy(rng):
    """Same pivot choices as the reference and the LAPACK oracle on a
    well-separated matrix (pivot magnitudes far apart, so rounding cannot
    flip an argmax)."""
    scipy_linalg = pytest.importorskip("scipy.linalg")
    n = 96
    A = _square(rng, n)
    LU, perm = T.ooc_lu(A, panel=32, budget_bytes=4 * A.nbytes,
                        torch_device=CPU)
    ref_LU, ref_perm = R.ooc_lu(A, panel=32, budget_bytes=4 * A.nbytes)
    assert np.array_equal(perm.numpy(), ref_perm)
    _, piv = scipy_linalg.lu_factor(A.astype(np.float64))
    sperm = np.arange(n)
    for j, p in enumerate(piv):
        sperm[[j, p]] = sperm[[p, j]]
    assert np.array_equal(perm.numpy(), sperm)
    np.testing.assert_allclose(LU.numpy(), ref_LU, rtol=0,
                               atol=5e-6 * np.abs(ref_LU).max())


def test_lu_permutation_round_trip(rng):
    """perm is a true permutation and inverts cleanly: scattering the
    factored rows back restores original row order."""
    n = 260
    A = _square(rng, n)
    LU, perm = T.ooc_lu(A, panel=96, budget_bytes=4 * A.nbytes,
                        torch_device=CPU)
    perm = perm.numpy()
    assert sorted(perm.tolist()) == list(range(n))
    L, U = _lu_factors(LU)
    inv = np.empty(n, dtype=perm.dtype)
    inv[perm] = np.arange(n)
    recon = (L @ U)[inv]          # undo the row permutation
    rel = np.abs(recon - A).max() / np.abs(A).max()
    assert rel < 5e-6, rel


def test_lu_solves_like_numpy(rng):
    """Forward/back substitution through the port's factors reproduces
    np.linalg.solve, as the reference's do."""
    scipy_linalg = pytest.importorskip("scipy.linalg")
    n = 256
    A = _square(rng, n)
    b = rng.standard_normal(n).astype(np.float32)
    LU, perm = T.ooc_lu(A, panel=64, budget_bytes=4 * A.nbytes,
                        torch_device=CPU)
    L, U = _lu_factors(LU, np.float32)
    y = scipy_linalg.solve_triangular(L, b[perm.numpy()], lower=True,
                                      unit_diagonal=True)
    x = scipy_linalg.solve_triangular(U, y, lower=False)
    expect = np.linalg.solve(A.astype(np.float64), b)
    np.testing.assert_allclose(x, expect, rtol=2e-3, atol=2e-3)


def test_lu_ill_conditioned_stays_backward_stable(rng):
    A = _square(rng, 256, cond=1e5)
    LU, perm = T.ooc_lu(A, panel=64, budget_bytes=4 * A.nbytes,
                        validate=True, torch_device=CPU)
    rel = _lu_rel(A, LU, perm)
    assert rel < 1e-4, rel


def test_lu_pivoting_beats_no_pivot_case(rng):
    """A tiny leading diagonal forces row swaps: the permutation is
    non-trivial and equals the reference's."""
    n = 128
    A = _square(rng, n)
    A[0, 0] = 1e-30
    LU, perm = T.ooc_lu(A, panel=32, budget_bytes=4 * A.nbytes,
                        torch_device=CPU)
    assert not np.array_equal(perm.numpy(), np.arange(n))
    assert _lu_rel(A, LU, perm) < 5e-6
    _, ref_perm = R.ooc_lu(A, panel=32, budget_bytes=4 * A.nbytes)
    assert np.array_equal(perm.numpy(), ref_perm)


def test_lu_invariant_to_pipeline_config(rng):
    A = _square(rng, 300)
    base = None
    for lookahead, nstreams, nbuf in itertools.product((0, 1, 2), (1, 2),
                                                       (1, 2, 3)):
        got = T.ooc_lu(A, panel=96, budget_bytes=4 * A.nbytes,
                       lookahead=lookahead, nstreams=nstreams, nbuf=nbuf,
                       validate=True, torch_device=CPU)
        if base is None:
            base = got
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    # the reference's blocked and unblocked eliminations round U apart
    # (by more than its own 1e-5 between configs), so it is held as the
    # reference holds itself: the same pivots, the same reconstruction bound
    ref_LU, ref_perm = R.ooc_lu(A, panel=96, budget_bytes=4 * A.nbytes)
    assert np.array_equal(base[1].numpy(), ref_perm)
    assert _lu_rel(A, *base) < 5e-6 and _lu_rel(A, ref_LU, ref_perm) < 5e-6


# --------------------------------------------- panel ops and the replay
def test_getrf_panel_matches_reference(rng):
    """The panel GETRF (LAPACK's getrf here) against the reference's
    unblocked loop on a tall panel: the same pivots, factors at f32
    tolerance."""
    buf = rng.standard_normal((200, 48)).astype(np.float32)
    ref = buf.copy()
    ref_piv = R_runtime.getrf_panel(ref)
    got = torch.from_numpy(buf.copy())
    piv = T_runtime.getrf_panel(got)
    assert piv.dtype == torch.int64
    assert np.array_equal(piv.numpy(), ref_piv)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=5e-6 * np.abs(ref).max())


@pytest.mark.parametrize("work", [None, 16, 1 << 16])
@pytest.mark.parametrize("k0,k1", [(0, 32), (40, 72), (96, 128)])
def test_composed_replay_equals_swap_loop(rng, k0, k1, work):
    """One gather of the rows the composed permutation moves (into a work
    buffer that is made, too small and replaced, or large enough and
    reused) equals the swap-by-swap replay bit for bit, and the
    reference's replay."""
    n = 128
    A = rng.standard_normal((n, n)).astype(np.float32)
    m, pw = n - k0, k1 - k0
    piv = np.array([j + int(rng.integers(0, m - j)) for j in range(pw)])
    piv[::5] = np.arange(pw)[::5]            # some columns do not swap
    got, plain = torch.from_numpy(A.copy()), torch.from_numpy(A.copy())
    perm, perm_plain = torch.arange(n), torch.arange(n)
    buf = None if work is None else torch.empty(work)
    used = T_runtime.apply_panel_pivots(got, torch.from_numpy(piv), k0, k1,
                                        perm, buf)
    assert (used is buf) == (work == 1 << 16)
    T_runtime.apply_panel_pivots_plain(plain, piv, k0, k1, perm_plain)
    assert torch.equal(got, plain) and torch.equal(perm, perm_plain)
    ref, ref_perm = A.copy(), np.arange(n)
    R_runtime.apply_panel_pivots(ref, piv, k0, k1, ref_perm)
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(perm.numpy(), ref_perm)
    # the panel's own columns are the write-back's, not the replay's
    assert np.array_equal(got[:, k0:k1].numpy(), A[:, k0:k1])


# ------------------------------------------- loop path, bytes, facade
@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_vmem_loop_matches_host_pipeline(rng, kind):
    """``backend="vmem"`` takes the per-panel loop (trailing updates through
    ``ooc_syrk``/``ooc_gemm`` on the vmem tier): it agrees with the host
    pipeline and with the reference's loop."""
    n, panel = 300, 96
    A = _spd(rng, n) if kind == "cholesky" else _square(rng, n)
    fn = {"cholesky": T.ooc_cholesky, "lu": T.ooc_lu}[kind]
    rfn = {"cholesky": R.ooc_cholesky, "lu": R.ooc_lu}[kind]
    budget = A.nbytes // 2
    host = fn(A, panel=panel, budget_bytes=budget, torch_device=CPU)
    loop = fn(A, panel=panel, budget_bytes=budget, backend="vmem",
              torch_device=CPU)
    ref = rfn(A, panel=panel, budget_bytes=budget, backend="vmem")
    if kind == "lu":
        # the LU's values round apart between the two paths (the
        # reference's own loop and pipeline differ by 8e-6 of the largest
        # entry here), so LU is held by pivots and reconstruction
        assert torch.equal(loop[1], host[1])
        assert np.array_equal(loop[1].numpy(), ref[1])
        assert _lu_rel(A, *loop) < 5e-6 and _lu_rel(A, *host) < 5e-6
        return
    scale = np.abs(np.asarray(ref)).max()
    np.testing.assert_allclose(loop.numpy(), host.numpy(), rtol=0,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(loop.numpy(), np.asarray(ref), rtol=0,
                               atol=5e-6 * scale)


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_bytes_equal_schedule_stats(rng, kind):
    """The executor's byte counters equal ``schedule_stats`` of the
    compiled schedule, which equals the reference's op for op."""
    n, panel = 320, 64
    A = _spd(rng, n) if kind == "cholesky" else _square(rng, n)
    budget = A.nbytes
    ex = T.ScheduleExecutor(torch_device=CPU)
    fn = {"cholesky": T.ooc_cholesky, "lu": T.ooc_lu}[kind]
    fn(A, panel=panel, budget_bytes=budget, executor=ex)
    spec = T.factor_pipeline_spec(n, panel, budget, 4, kind=kind)
    stats = T.schedule_stats(T.compile_factor_pipeline(spec))
    rstats = R.schedule_stats(R.compile_factor_pipeline(
        R.factor_pipeline_spec(n, panel, budget, 4, kind=kind)))
    assert stats == rstats
    assert (ex.last_h2d_bytes, ex.last_d2h_bytes) == (stats["h2d_bytes"],
                                                      stats["d2h_bytes"])


def test_hcl_ooc_factor_facade(rng):
    n = 192
    A = _spd(rng, n)
    L = hclOocFactor(A, "cholesky", panel=64, budget_bytes=4 * A.nbytes,
                     torch_device=CPU).numpy()
    np.testing.assert_allclose(L @ L.T, A, rtol=1e-4, atol=1e-4)
    ref = R_hclOocFactor(A, "cholesky", panel=64, budget_bytes=4 * A.nbytes)
    np.testing.assert_allclose(L, ref, rtol=0, atol=5e-6 * np.abs(ref).max())
    B = _square(rng, n)
    LU, perm = hclOocFactor(B, "lu", panel=64, budget_bytes=4 * B.nbytes,
                            torch_device=CPU)
    L2, U2 = _lu_factors(LU)
    np.testing.assert_allclose(B[perm.numpy()], L2 @ U2, rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="unknown factor kind"):
        hclOocFactor(A, "qr", budget_bytes=1 << 20, torch_device=CPU)


def test_factor_tiny_matrices(rng):
    """n smaller than any sensible panel still factors (single in-core
    panel step)."""
    for n in (1, 2, 4, 7):
        A = _spd(rng, n)
        L = T.ooc_cholesky(A, budget_bytes=1 << 24, torch_device=CPU)
        L = L.double().numpy()
        np.testing.assert_allclose(L @ L.T, A, rtol=1e-5, atol=1e-5)
        B = _square(rng, n) + n * np.eye(n, dtype=np.float32)
        LU, perm = T.ooc_lu(B, budget_bytes=1 << 24, torch_device=CPU)
        L2, U2 = _lu_factors(LU)
        np.testing.assert_allclose(B[perm.numpy()], L2 @ U2, rtol=1e-5,
                                   atol=1e-5)
        _, ref_perm = R.ooc_lu(B, budget_bytes=1 << 24)
        assert np.array_equal(perm.numpy(), ref_perm)


def test_factor_rejects_non_square_and_infeasible_budget(rng):
    for fn in (T.ooc_cholesky, T.ooc_lu):
        with pytest.raises(ValueError, match="square"):
            fn(rng.standard_normal((64, 32)), budget_bytes=1 << 20,
               torch_device=CPU)
        with pytest.raises(ValueError, match="budget"):
            fn(_spd(rng, 512), panel=128, budget_bytes=1024,
               torch_device=CPU)
    with pytest.raises(ValueError, match="budget"):
        R.ooc_cholesky(_spd(rng, 512), panel=128, budget_bytes=1024)




@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_card_plan_charges_panel_workspace(kind):
    """On a card the planner sizes the schedule for the budget less the
    panel ops' device workspace (GETRF's column-major copy of the largest
    panel, or POTRF's factor, and the libraries'); on the CPU it charges
    nothing and plans as the reference does.  A budget the workspace
    alone fills raises."""
    from repro_torch.core.ooc_factor import (_plan_factor_spec,
                                             panel_workspace_bytes)
    n, panel, budget = 4096, 512, 160 << 20
    cpu = _plan_factor_spec(kind, n, panel, budget, 4, 1, 2, CPU)
    ref = R.factor_pipeline_spec(n, panel, budget, 4, kind=kind)
    assert (cpu.panel, cpu.lookahead, cpu.bm, cpu.bn) \
        == (ref.panel, ref.lookahead, ref.bm, ref.bn)
    assert panel_workspace_bytes(kind, n, panel, 4, CPU) == 0
    charged = panel_workspace_bytes(kind, n, panel, 4, "cuda")
    own = n * panel if kind == "lu" else panel * panel
    assert charged == 4 * own + (64 << 20)
    card = _plan_factor_spec(kind, n, panel, budget, 4, 1, 2, "cuda")
    assert card.working_set_bytes(2) + charged <= budget
    assert card.working_set_bytes(2) <= cpu.working_set_bytes(2)
    assert card == T.factor_pipeline_spec(n, panel, budget - charged, 4,
                                          kind=kind)
    with pytest.raises(ValueError, match="panel-op workspace"):
        _plan_factor_spec(kind, n, panel, 32 << 20, 4, 1, 2, "cuda")


def test_default_device_needs_a_card(rng):
    """Without a card and without ``torch_device="cpu"`` the entry points
    raise instead of falling back to the host."""
    A = _spd(rng, 32)
    for fn in (T.ooc_cholesky, T.ooc_lu):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(A, budget_bytes=1 << 20)


def test_factor_schedule_accounts_full_flops():
    """The compiled schedule's flop total covers the n^3/3 factorization,
    both lookahead modes move identical bytes, and every count is the
    reference's."""
    stats = {}
    for la in (0, 1):
        args = (1024, 128, 1 << 30, 4)
        kw = dict(kind="cholesky", lookahead=la)
        stats[la] = T.schedule_stats(T.compile_factor_pipeline(
            T.factor_pipeline_spec(*args, **kw)))
        assert stats[la] == R.schedule_stats(R.compile_factor_pipeline(
            R.factor_pipeline_spec(*args, **kw)))
    assert stats[0]["flops"] >= 1024 ** 3 // 3
    assert stats[0]["h2d_bytes"] == stats[1]["h2d_bytes"]
    assert stats[0]["d2h_bytes"] == stats[1]["d2h_bytes"]


@pytest.mark.parametrize("A_type", ["numpy", "tensor"])
@pytest.mark.parametrize("backend", ["host", "vmem"])
def test_cholesky_masks_its_own_copy_in_place(rng, monkeypatch, backend,
                                              A_type):
    """Both paths (host pipeline, vmem loop) mask the call's own copy of A
    in place: the caller's A reads the same afterwards, the result shares
    no storage with it, and it is ``torch.tril`` of the unmasked factor
    bit for bit, with exact zeros above the diagonal."""
    A = _spd(rng, 192)
    if A_type == "tensor":
        A = torch.from_numpy(A)
    before = np.array(A, copy=True)
    unmasked = []
    tril_ = torch.Tensor.tril_

    def spy(self, *a, **kw):
        unmasked.append(self.clone())
        return tril_(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "tril_", spy)
    L = T.ooc_cholesky(A, panel=64, budget_bytes=before.nbytes // 2,
                       backend=backend, torch_device=CPU)
    np.testing.assert_array_equal(np.asarray(A), before)
    assert (L.untyped_storage().data_ptr()
            != torch.as_tensor(A).untyped_storage().data_ptr())
    (full,) = unmasked
    assert torch.equal(L, torch.tril(full))
    assert not torch.equal(full, L)
    assert torch.count_nonzero(torch.triu(L, 1)) == 0
    np.testing.assert_allclose(L.numpy() @ L.numpy().T, before, rtol=0,
                               atol=1e-5 * np.abs(before).max())
