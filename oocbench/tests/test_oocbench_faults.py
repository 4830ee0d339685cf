"""The comparison that decides ``correct`` refuses a broken timed path.

Each test drives a whole run on the CPU (the harness's look for a card is
the only step left out) with the program broken underneath, in the block
GEMM that every cell's ``dgemm`` ops call, and sees ``correct`` come out
false; the same run unbroken is correct.  The faults are those a cell on
one card can have: a step that returns its state unchanged; half of the
work left out and the rest scaled to stand for the whole; an answer
altered where it is produced; a call that fails.  No cell exchanges data
between cards, so that fault has no place here.
"""

import json
import pathlib

import pytest
import torch

import repro_torch.core.runtime as rt
from oocbench.harness import bench
from oocbench_tiny import tiny  # noqa: F401  (the fixture)

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
REAL = rt.block_gemm


def unchanged(a, b, c, alpha, beta, out=None, **kw):
    """The product returns C as it found it."""
    if out is not None and out is not c:
        out.copy_(c)
        return out
    return c


def half_left_out():
    """Every other product is skipped; the others count double."""
    n = [0]

    def fault(a, b, c, alpha, beta, out=None, **kw):
        n[0] += 1
        if n[0] % 2:
            return unchanged(a, b, c, alpha, beta, out)
        return REAL(a, b, c, 2 * alpha, beta, out=out, **kw)
    return fault


def altered(a, b, c, alpha, beta, out=None, **kw):
    """One entry of each product is off by a thousandth of the largest."""
    res = REAL(a, b, c, alpha, beta, out=out, **kw)
    res.view(-1)[res.numel() // 2] += 1e-3 * float(res.abs().max())
    return res


def raises(*args, **kw):
    raise RuntimeError("planted: the block product failed")


FAULTS = {"unchanged": lambda: unchanged, "half_left_out": half_left_out,
          "altered": lambda: altered, "raises": lambda: raises}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    sound = bench.run_cell(tiny, cell, 2**31 + 21, 0.3, False, "cpu")
    assert sound["correct"], sound["checks"]
    monkeypatch.setattr(rt, "block_gemm", FAULTS[fault]())
    try:
        res = bench.run_cell(tiny, cell, 2**31 + 21, 0.3, False, "cpu")
    except RuntimeError as e:
        # the warm call is set-up: a program that fails there (the planted
        # error, or a factor that is no longer positive definite) ends the
        # run with no result line
        assert fault in ("raises", "half_left_out"), e
        return
    assert fault != "raises"
    assert not res["correct"]
    assert res["checks"]["max_err"]["value"] > \
        res["checks"]["max_err"]["limit"]
    assert res["failed"] == res["attempted"] > 0


def test_a_call_that_fails_in_the_window_is_not_correct(tiny, monkeypatch):
    """A call of the window that raises counts as failed; the window goes
    on (the warm call before it succeeded)."""
    import repro_torch.core as core

    real, calls = core.ooc_gemm, [0]

    def third_fails(*args, **kw):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("planted: the call failed")
        return real(*args, **kw)
    monkeypatch.setattr(core, "ooc_gemm", third_fails)
    res = bench.run_cell(tiny, "mmooc-f32.k8192", 2**31 + 22, 0.5, False,
                         "cpu")
    assert calls[0] > 3 and res["attempted"] == calls[0] - 1
    assert not res["correct"] and res["checks"]["failed_calls"]["value"] == 1


def test_the_faults_break_the_product():
    a, b, c = torch.randn(8, 5), torch.randn(5, 6), torch.randn(8, 6)
    want = REAL(a, b, c, 1.0, 1.0)
    assert torch.equal(unchanged(a, b, c.clone(), 1.0, 1.0), c)
    assert not torch.allclose(altered(a, b, c, 1.0, 1.0), want)
    f = half_left_out()
    assert torch.equal(f(a, b, c, 1.0, 1.0), c)
    assert torch.allclose(f(a, b, c, 1.0, 0.0), 2 * (a @ b), atol=1e-5)
