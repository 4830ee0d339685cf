"""MiniMax-Text-01's out-of-core decode step on the CPU, and the executor's
direct H2D path from page-locked operands.

The benchmark's driver (``oocbench/drivers/decode_step.py``) runs one decode
step: one ``ooc_attention`` call per softmax layer over that layer's cached
K and V, which it first page-locks.  It is held to the plain reference
(``plain_decode_attention.py``: float32, TF32 off) on seeded random q, K
and V at the model's group of 8 query heads on 1 KV head and ``head_dim``
128, with a budget that streams each layer in several blocks, the last one
ragged.  Tolerances: a bfloat16 step's output is rounded to bfloat16, half
an ulp (2^-9) of each entry, so the bound is 2^-8 of the largest entry; a
float32 step sums the same products in another order, 1e-5 of it.

The path choice is checked through the executor's counters: a slice of a
page-locked input operand that is contiguous, not transposed and in its
compute dtype takes the direct path (``last_direct_h2d_bytes``); pageable,
strided, transposed or float64 slices and an output's are staged.  With no card nothing is page-locked,
so the CPU tests mark operands page-locked by patching
``runtime._page_locked``; on the CPU both paths copy the same.
"""

import pathlib

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import runtime
from repro_torch.obs import get_observability

from oocbench.harness.manifest import Manifest
from plain_decode_attention import decode_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
H, HKV, D = 8, 1, 128           # one tensor-parallel chip's share
LAYERS, S = 2, 3000
# 2 x 768 positions of K and V in bfloat16: blocks of 768, the last of 696
BUDGET = 2 * 768 * 2 * HKV * D * 2


def _step_operands(seed, dtype):
    g = torch.Generator().manual_seed(seed)
    return {n: torch.randn(shape, generator=g).to(dtype)
            for n, shape in (("Q", (LAYERS, H, D)),
                             ("K", (LAYERS, S, HKV, D)),
                             ("V", (LAYERS, S, HKV, D)))}


@pytest.fixture
def driver():
    return Manifest(ROOT).module("drivers", "decode_step")


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2.0 ** -8),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_driver_step_matches_plain_reference(driver, dtype, tol, seed):
    ops = _step_operands(seed, dtype)
    part = T.plan_attention_partition(
        S, HKV, D, BUDGET, bytes_per_el=ops["K"].element_size())
    assert part.nblocks >= 3 and S % part.bs
    ex = T.ScheduleExecutor(torch_device=CPU)
    session = driver.prepare({"budget_bytes": BUDGET}, ex)
    out = driver.call(session, ops, {}, {"budget_bytes": BUDGET,
                                         "options": {}})
    assert out.shape == (LAYERS, H, D) and out.dtype == dtype
    want = decode_step(ops["Q"], ops["K"], ops["V"])
    gap = float((out.float() - want).abs().max() / want.abs().max())
    assert gap <= tol
    # no card: the session holds its handles, and they locked nothing
    assert len(session.locks) == 2
    assert not any(h.locked for h in session.locks.values())
    assert ex.last_direct_h2d_bytes == 0


def test_driver_locks_each_cache_once(driver, monkeypatch):
    """A session locks the cache it is given once, keeps it for every step,
    and releases it when a step brings another cache."""
    made = []

    class Handle:
        locked = True

        def __init__(self, t):
            made.append(self)
            self.released = 0

        def release(self):
            self.released += 1

    monkeypatch.setattr(driver, "page_lock", Handle)
    session = driver.prepare({}, T.ScheduleExecutor(torch_device=CPU))
    cfg = {"budget_bytes": BUDGET, "options": {}}
    one, two = (_step_operands(seed, torch.bfloat16) for seed in (1, 2))
    driver.call(session, one, {}, cfg)
    driver.call(session, one, {}, cfg)
    assert len(made) == 2 and not any(h.released for h in made)
    driver.call(session, two, {}, cfg)
    assert len(made) == 4
    assert [h.released for h in made] == [1, 1, 0, 0]


def test_page_lock_does_nothing_without_a_card():
    t = torch.randn(64, 8)
    before = t.clone()
    with T.page_lock(t) as h:
        assert not h.locked and not t.is_pinned()
    h.release()
    h.release()
    assert torch.equal(t, before)
    with pytest.raises(ValueError, match="CPU tensor"):
        T.page_lock(torch.empty(0, device="meta"))


def _attention_case(strided=False):
    g = torch.Generator().manual_seed(11)
    q = torch.randn(H, D, generator=g)
    if strided:     # (S, Hkv, d) views of (d, Hkv, S) storage
        k, v = (torch.randn(D, HKV, S, generator=g).permute(2, 1, 0)
                for _ in range(2))
    else:
        k, v = (torch.randn(S, HKV, D, generator=g).to(torch.bfloat16)
                for _ in range(2))
    part = T.plan_attention_partition(S, HKV, D, BUDGET * 2,
                                      bytes_per_el=k.element_size())
    sched = T.build_attention_schedule(part, HKV, D, H)
    return sched, {"K": k, "V": v}, {"out": torch.zeros(H, D)}, {"q": q}


def _syrk_case():
    rng = np.random.default_rng(13)
    n, K = 256, 192
    P = rng.standard_normal((n, K)).astype(np.float32)
    C = rng.standard_normal((n, n)).astype(np.float32)
    part = T.plan_gemm_partition(n, n, K, (2 * P.nbytes + C.nbytes) // 2, 4,
                                 nbuf=2, nstreams=2)
    return (T.build_syrk_schedule(part, nstreams=2, nbuf=2),
            {"P": torch.from_numpy(P)}, {"C": torch.from_numpy(C)},
            {"alpha": 1.0, "beta": 0.5})


def _gemm_case(dtype=np.float32):
    rng = np.random.default_rng(17)
    M, N, K = 320, 256, 192
    A, B, C = (torch.from_numpy(rng.standard_normal(s).astype(dtype))
               for s in ((M, K), (K, N), (M, N)))
    part = T.plan_gemm_partition(M, N, K, (A.nbytes + B.nbytes + C.nbytes)
                                 // 3, 4)
    return (T.build_gemm_schedule(part), {"A": A, "B": B}, {"C": C},
            {"alpha": 1.0, "beta": 0.5})


def _h2d_bytes(sched, which):
    return sum(op.bytes for op in sched.ops
               if op.kind.name == "H2D" and which(op.payload))


# case -> (schedule case, operands page-locked, the slices that go direct)
PATHS = {
    "contiguous-locked": (_attention_case, True, lambda ref: True),
    "pageable": (_attention_case, False, lambda ref: False),
    "strided-locked": (lambda: _attention_case(strided=True), True,
                       lambda ref: False),
    "transposed-locked": (_syrk_case, True,
                          lambda ref: ref.operand == "P"
                          and not ref.transpose),
    "column-slices-and-output-locked": (_gemm_case, True,
                                        lambda ref: ref.operand == "A"),
    # float64 lands as float32: the slice needs a host conversion
    "float64-locked": (lambda: _gemm_case(np.float64), True,
                       lambda ref: False),
}


@pytest.mark.parametrize("case", sorted(PATHS))
def test_h2d_path_choice_and_counters(monkeypatch, case):
    """Direct bytes are exactly those of the slices the rule admits; every
    run's H2D and D2H bytes still equal ``schedule_stats``, and the result
    is the staged run's, bit for bit."""
    make, locked, direct = PATHS[case]
    sched, operands, outputs, ctx = make()
    stats = T.schedule_stats(sched)
    results = []
    for lock in (False, locked):
        monkeypatch.setattr(runtime, "_page_locked", lambda t: lock)
        ex = T.ScheduleExecutor(torch_device=CPU)
        outs = {k: v.clone() for k, v in outputs.items()}
        ex.run(sched, operands, outs, dict(ctx))
        results.append(outs)
        assert (ex.last_h2d_bytes, ex.last_d2h_bytes) == (
            stats["h2d_bytes"], stats["d2h_bytes"])
        want = _h2d_bytes(sched, direct) if lock else 0
        assert ex.last_direct_h2d_bytes == want
    # where the rule admits slices, their bytes are counted
    if case.endswith("-locked") and not case.startswith(("strided",
                                                         "float64")):
        assert 0 < want <= stats["h2d_bytes"]
    for k in outputs:
        assert torch.equal(results[0][k], results[1][k])


def test_direct_bytes_reach_the_call_record_and_the_metrics(monkeypatch):
    """An ``ooc_attention`` call over page-locked operands: its record
    carries the run's direct bytes, and the executor publishes them as
    ``repro_executor_direct_h2d_bytes``; a pageable run publishes none."""
    obs = get_observability()
    sched, operands, _, ctx = _attention_case()
    k, v = operands["K"], operands["V"]
    obs.reset().enable(metrics=True)
    try:
        ex = T.ScheduleExecutor(record_spans=True, torch_device=CPU)
        T.ooc_attention(ctx["q"], k, v, budget_bytes=BUDGET * 2, executor=ex)
        assert obs.metrics.get("repro_executor_direct_h2d_bytes") is None
        monkeypatch.setattr(runtime, "_page_locked", lambda t: True)
        T.ooc_attention(ctx["q"], k, v, budget_bytes=BUDGET * 2, executor=ex)
        pageable, locked = obs.calls
        assert pageable.direct_h2d_bytes == 0
        assert locked.direct_h2d_bytes == ex.last_direct_h2d_bytes \
            == ex.last_h2d_bytes == T.schedule_stats(sched)["h2d_bytes"]
        assert obs.metrics.get("repro_executor_direct_h2d_bytes").value(
            kernel=sched.meta.get("kernel", "unknown")) \
            == ex.last_direct_h2d_bytes
    finally:
        obs.reset().disable()
