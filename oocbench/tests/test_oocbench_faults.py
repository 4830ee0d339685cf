"""The comparison that decides ``correct`` refuses a broken timed path.

Each test drives a whole run on the CPU (the harness's look for a card is
the only step left out) with the program broken underneath, at the
function that the cell's entry point names in its cut
(``cuts/<entry>.json``: ``fault``), and sees ``correct`` come out false;
the same run unbroken is correct.  The faults are those a cell on one card
can have: a step that returns its state unchanged; half of the work left
out and the rest scaled to stand for the whole; an answer altered where it
is produced; a call that fails.  No cell exchanges data between cards, so
that fault has no place here.
"""

import importlib
import inspect
import json
import pathlib

import pytest
import torch

from oocbench.harness import bench
from oocbench.harness.manifest import Manifest
from oocbench_tiny import cut_of, tiny  # noqa: F401  (the fixture)

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _unchanged(spec, bound):
    """The call's result is its state as it found it (copied into its
    ``out`` where it has another one)."""
    state = bound.arguments[spec["state"]]
    out = bound.arguments.get("out")
    if isinstance(out, torch.Tensor) and out is not state:
        return out.copy_(state)
    return state


def unchanged(spec, real):
    """The step returns its state unchanged."""
    return lambda bound: _unchanged(spec, bound)


def half_left_out(spec, real):
    """Every other call is skipped; the others count double (where the
    function has a scale: a softmax's normalisation takes the mean over
    the rest by itself)."""
    n = [0]

    def fault(bound):
        n[0] += 1
        if n[0] % 2:
            return _unchanged(spec, bound)
        if spec.get("scale"):
            bound.arguments[spec["scale"]] *= 2
        return real(*bound.args, **bound.kwargs)
    return fault


def altered(spec, real):
    """One entry of what each call produces (of several tensors, the
    largest) is off by a thousandth of its largest."""
    def fault(bound):
        res = real(*bound.args, **bound.kwargs)
        t = res if isinstance(res, torch.Tensor) \
            else max(res, key=lambda x: x.numel())
        t.view(-1)[t.numel() // 2] += 1e-3 * float(t.abs().max())
        return res
    return fault


def raises(spec, real):
    def fault(bound):
        raise RuntimeError(f"planted: {spec['at']} failed")
    return fault


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
          "altered": altered, "raises": raises}


def planted(spec, fault):
    """``(module, name, broken)``: the function that ``spec`` names, and
    ``fault`` made of it, applied to the calls that ``spec``'s ``when``
    selects."""
    mod_name, name = spec["at"].rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    real = getattr(mod, name)
    sig = inspect.signature(real)
    broken = FAULTS[fault](spec, real)

    def call(*args, **kw):
        bound = sig.bind(*args, **kw)
        bound.apply_defaults()
        if all(bound.arguments[k] == v
               for k, v in spec.get("when", {}).items()):
            return broken(bound)
        return real(*args, **kw)
    return mod, name, call


def check_fault(root, cell, fault, monkeypatch):
    """A run of ``cell`` under ``root`` is correct, and with ``fault``
    planted where its entry point's cut says, not correct."""
    sound = bench.run_cell(root, cell, 2**31 + 21, 0.3, False, "cpu")
    assert sound["correct"], sound["checks"]
    man = Manifest(root)
    entry = man.config(man.cell(cell)["config"])["entry"]
    mod, name, broken = planted(cut_of(root, entry)["fault"], fault)
    monkeypatch.setattr(mod, name, broken)
    try:
        res = bench.run_cell(root, cell, 2**31 + 21, 0.3, False, "cpu")
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


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    check_fault(tiny, cell, fault, monkeypatch)


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
    """The faults, planted at the block GEMM: what each makes of one
    product, and ``when`` choosing the calls that are planted."""
    from repro_torch.core.runtime import block_gemm

    spec = {"at": "repro_torch.core.runtime.block_gemm", "state": "c",
            "scale": "alpha"}
    a, b, c = torch.randn(8, 5), torch.randn(5, 6), torch.randn(8, 6)
    want = block_gemm(a, b, c, 1.0, 1.0)
    fault = {f: planted(spec, f)[2] for f in FAULTS}
    assert torch.equal(fault["unchanged"](a, b, c.clone(), 1.0, 1.0), c)
    out = torch.empty_like(c)
    assert fault["unchanged"](a, b, c, 1.0, 1.0, out=out) is out
    assert torch.equal(out, c)
    assert not torch.allclose(fault["altered"](a, b, c, 1.0, 1.0), want)
    half = fault["half_left_out"]
    assert torch.equal(half(a, b, c, 1.0, 1.0), c)
    assert torch.allclose(half(a, b, c, 1.0, 0.0), 2 * (a @ b), atol=1e-5)
    with pytest.raises(RuntimeError, match="planted"):
        fault["raises"](a, b, c, 1.0, 1.0)
    only_beta_0 = planted(dict(spec, when={"beta": 0.0}), "raises")[2]
    assert torch.equal(only_beta_0(a, b, c, 1.0, 1.0), want)
    with pytest.raises(RuntimeError, match="planted"):
        only_beta_0(a, b, c, 1.0, beta=0.0)
