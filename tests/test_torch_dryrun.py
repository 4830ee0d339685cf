"""The dry-run's port (``launch.dryrun``, ``distributed.cost_analysis``,
``configs.input_specs``, ``scripts.make_tables``) against the reference's
``launch/dryrun.py``, ``distributed/hlo_analysis.py``, ``configs/base.py``
and ``scripts/make_tables.py``.

Exact twins: the roofline rows under the TPU v5e's rates, the wire bytes by
collective kind (the reference parsing an HLO text built from the same
records, ``tests/test_distributed.py``'s among them), every input stand-in,
the parameter counts and the serving-rules decision of the ten full
configs at 16x16, and the rendered tables.  The traced steps run in a
subprocess on a fake group of 8 ranks (the twin of
``tests/test_dryrun_smoke.py``): the four smoke archs' train and decode
steps on a (2, 4) mesh, each OK with flops > 0, and their flops equal to
the same steps run on real tensors.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_arch as r_get_arch
from repro.configs import input_specs as r_input_specs
from repro.distributed import Roofline as RRoofline
from repro.distributed import collective_bytes
from repro.models import get_model as r_get_model
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch, input_specs
from repro_torch.distributed import cost_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.models import get_model

ROOT = pathlib.Path(__file__).resolve().parents[1]


class FakeMesh:
    """Duck-typed mesh with a .shape mapping."""

    def __init__(self, shape):
        self.shape = shape


M2 = FakeMesh({"data": 16, "model": 16})


def _reference_dryrun():
    """The reference's dry-run module, imported without letting its first
    line's ``XLA_FLAGS`` outlive the import (this process keeps one host
    device)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return mod


# ------------------------------------------------------------------ roofline
V5E = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


@pytest.mark.parametrize("flops,hbm,wire,chips,model", [
    (197e12, 819e9 * 2, 50e9 * 0.5, 256, 197e12 * 256 * 0.5),
    (3.1e13, 2.0e9, 7.5e10, 512, 1.0e16),
    (1.0, 0.0, 0.0, 1, 0.0),
    (0.0, 0.0, 0.0, 256, 0.0)])
def test_roofline_rows_equal_the_reference_at_the_v5e_rates(
        flops, hbm, wire, chips, model):
    ours = ca.Roofline(flops=flops, hbm_bytes=hbm, wire_bytes=wire,
                       chips=chips, model_flops=model, **V5E)
    ref = RRoofline(flops=flops, hbm_bytes=hbm, wire_bytes=wire, chips=chips,
                    model_flops=model)
    assert ours.row() == ref.row()
    assert ours.t_bound == ref.t_bound


def test_roofline_defaults_are_the_h100s():
    rl = ca.Roofline(flops=989e12, hbm_bytes=3.35e12 * 2,
                     wire_bytes=450e9 * 0.5, chips=256)
    assert (rl.peak_flops, rl.hbm_bw, rl.link_bw) == (989e12, 3.35e12, 450e9)
    assert (rl.t_compute, rl.t_memory, rl.t_collective) == (1.0, 2.0, 0.5)
    assert rl.bottleneck == "memory" and rl.roofline_fraction == 0.5
    assert ca.HBM_BYTES > 80e9


# ------------------------------------------------------- collective bytes
_ESIZE = {"bf16": 2, "f32": 4, "s32": 4, "f16": 2}


def _hlo(records):
    """An HLO module with one collective per (kind, dtype, dims, n)."""
    lines = ["HloModule test", "ENTRY %main {"]
    for i, (kind, dt, dims, n) in enumerate(records):
        group = ",".join(map(str, range(n)))
        lines.append(f"  %c{i} = {dt}[{','.join(map(str, dims))}]{{0}} "
                     f"{kind}(%x), replica_groups={{{{{group}}}}}")
    lines.append("}")
    return "\n".join(lines)


def _ours(records):
    st = ca.CollectiveStats()
    for kind, dt, dims, n in records:
        nbytes = int(np.prod(dims)) * _ESIZE[dt]
        if n > 1:
            st.add(kind, ca.ring_wire_bytes(kind, nbytes, n))
    return st


RECORDS = [
    [("all-reduce", "bf16", (16, 1024), 4),
     ("all-gather", "f32", (64, 1024), 4),
     ("reduce-scatter", "f32", (4, 1024), 4)],
    [("all-to-all", "bf16", (128, 64), 16),
     ("collective-broadcast", "f32", (7,), 2),
     ("collective-permute", "bf16", (8, 8), 2),
     ("all-gather", "bf16", (2, 3, 5), 16),
     ("all-gather", "f32", (9,), 1)],
    [("reduce-scatter", "s32", (33,), 2), ("all-reduce", "f16", (1,), 256),
     ("all-reduce", "f32", (1024, 1024), 16)],
]


@pytest.mark.parametrize("records", RECORDS)
def test_ring_factors_equal_the_reference_parser(records):
    ref = collective_bytes(_hlo(records))
    ours = _ours(records)
    assert ours.counts == ref.counts
    assert ours.by_kind == pytest.approx(ref.by_kind, rel=1e-12)
    assert ours.wire_bytes == pytest.approx(ref.wire_bytes, rel=1e-12)


def test_ring_factors_on_the_reference_tests_hlo():
    """``tests/test_distributed.py``'s HLO text: its collectives as records
    (the permute's group is the parser's default of 2; its -done carries
    nothing)."""
    from test_distributed import HLO
    records = [("all-reduce", "bf16", (16, 1024), 4),
               ("all-gather", "f32", (64, 1024), 4),
               ("reduce-scatter", "f32", (4, 1024), 4),
               ("collective-permute", "bf16", (8, 8), 2)]
    ref = collective_bytes(HLO)
    ours = _ours(records)
    assert ours.counts == ref.counts
    assert ours.by_kind == pytest.approx(ref.by_kind, rel=1e-12)


# -------------------------------------------------------------- input specs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    for name in SHAPES:
        ours = input_specs(get_arch(arch), SHAPES[name])
        ref = r_input_specs(r_get_arch(arch), R_SHAPES[name])
        assert set(ours) == set(ref)
        for k, v in ours.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == ref[k].shape, (arch, name, k)
            assert str(v.dtype).split(".")[1] == ref[k].dtype.name


def test_input_specs_are_fake_under_the_dry_runs_mode():
    with FakeTensorMode():
        spec = input_specs(get_arch("llama3.2-3b"), SHAPES["train_4k"],
                           device="cpu")
    assert all(type(v).__name__ == "FakeTensor" for v in spec.values())


# ------------------------------------------------- parameters, serve rules
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_serve_rules_match_the_reference(arch):
    ref = _reference_dryrun()
    rcfg = r_get_arch(arch)
    sds = jax.eval_shape(lambda: r_get_model(rcfg).init(
        jax.random.PRNGKey(0)))
    with FakeTensorMode():
        model = get_model(get_arch(arch), device="cpu").init(
            torch.Generator().manual_seed(0))
        named = {k: p.shape for k, p in model.named_parameters()}
        fits = dryrun._serve_rules_if_fits(list(model.parameters()), M2)
    assert dryrun.count_params(named) == ref.count_params(sds)
    assert dryrun.active_params(get_arch(arch), named) \
        == ref.active_params(rcfg, sds)
    assert (fits is None) == (ref._serve_rules_if_fits(sds, M2) is None)


# --------------------------------------------------------------- make_tables
def _artifacts(d, port):
    secs = "trace_s" if port else "proof_compile_s"
    row = {"t_compute_s": 0.0123, "t_memory_s": 0.456, "t_collective_s": 0.7,
           "bottleneck": "collective", "roofline_fraction": 0.0176,
           "useful_flops_ratio": 0.81}
    arts = {
        "llama3.2-3b__train_4k__single": {
            "arch": "llama3.2-3b", "shape": "train_4k", "mesh": "16x16",
            "status": "OK", "chips": 256, "device_hbm_bytes": 12 * 2**30,
            "fits_hbm": True, secs: 41.5, "roofline": row,
            "model_flops": 5.6e18, "flops_per_device": 2.5e16,
            "collectives": {"all-reduce": 3 * 2**30, "all-gather": 2**29,
                            "reduce-scatter": 7 * 2**28}},
        "llama3.2-3b__train_4k__multi": {
            "arch": "llama3.2-3b", "shape": "train_4k", "mesh": "2x16x16",
            "status": "OK", "chips": 512, "device_hbm_bytes": 20 * 2**30,
            "fits_hbm": False, secs: 60.0},
        "llama3.2-3b__long_500k__single": {
            "arch": "llama3.2-3b", "shape": "long_500k", "mesh": "16x16",
            "status": "SKIP", "reason": "pure full-attention arch; 500k "
                                        "decode needs sub-quadratic backbone"},
        "zamba2-1.2b__prefill_32k__single": {
            "arch": "zamba2-1.2b", "shape": "prefill_32k", "mesh": "16x16",
            "status": "FAIL", "error": "RuntimeError: x"},
        "zamba2-1.2b__decode_32k__single": {
            "arch": "zamba2-1.2b", "shape": "decode_32k", "mesh": "16x16",
            "status": "OK", "chips": 256, "device_hbm_bytes": 3 * 2**30,
            "fits_hbm": True, secs: 6.4},
    }
    for name, art in arts.items():
        with open(os.path.join(d, name + ".json"), "w") as f:
            json.dump(art, f)


@pytest.mark.parametrize("which", [None, "dryrun", "roofline",
                                   "collectives"])
def test_make_tables_output_equals_the_reference_scripts(tmp_path, which):
    from repro_torch.scripts import make_tables

    _artifacts(str(tmp_path), port=False)
    argv = [str(tmp_path)] + ([which] if which else [])
    ref = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                              "make_tables.py"), *argv],
                         capture_output=True, text=True, timeout=60)
    assert ref.returncode == 0, ref.stderr
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        make_tables.main(argv)
    assert out.getvalue() == ref.stdout


def test_make_tables_heads_the_port_artifacts_by_trace_seconds(tmp_path):
    from repro_torch.scripts import make_tables

    _artifacts(str(tmp_path), port=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        make_tables.main([str(tmp_path), "dryrun"])
    text = out.getvalue()
    assert "| trace (s) |" in text
    assert "| llama3.2-3b | train_4k | OK / 12.00 / Y | OK / 20.00 / N | " \
           "41.5 / 60.0 |" in text


# -------------------------------------------------- kernel 2 under a trace
def test_kernel_2_is_a_fake_operator_counted_at_its_own_work():
    """On fake ``cuda`` tensors the wrappers take the card's branch: two
    operators that launch nothing, counted by their flop formulas."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flash_attention as kfa

    B, H, hkv, S, d = 4, 24, 8, 544, 128
    before = (kfa.flash_partial.launches, kfa.flash_combine.launches)
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty(B, H, d, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(B, S, hkv, d, device="cuda", dtype=torch.bfloat16)
        lens = torch.empty(B, dtype=torch.int32, device="cuda")
        with FlopCounterMode(display=False) as fc:
            out = kfa.flash_decode_attention(q, k, k, lens)
    assert out.shape == (B, H, d) and out.device.type == "cuda"
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    n = kfa.nsplits(S, 512)
    assert counts == {"repro_torch.flash_partial": 4 * B * H * S * d,
                      "repro_torch.flash_combine": 2 * B * H * n * d}
    assert (kfa.flash_partial.launches, kfa.flash_combine.launches) == before


def test_run_cell_skips_as_the_reference_and_refuses_a_live_group():
    ref = _reference_dryrun()
    for arch, shape in (("hubert-xlarge", "decode_32k"),
                        ("llama3.2-3b", "long_500k")):
        ours = dryrun.run_cell(arch, shape, False)
        theirs = ref.run_cell(arch, shape, False)
        assert ours == theirs
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already up"):
            dryrun.run_cell("llama3.2-3b", "decode_32k", False)
    finally:
        dist.destroy_process_group()


# ------------------------------------------- traced steps on 8 fake ranks
TWIN = r"""
import json
import torch
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.distributed.cost_analysis import CostMode
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh

B, S = 8, 32
TRAIN, DECODE = ShapeConfig("t", S, B, "train"), ShapeConfig("d", 64, B,
                                                              "decode")
specs = dryrun.input_specs


def zeros(cfg, shape, device):
    return {k: torch.zeros_like(v, device=device)
            for k, v in specs(cfg, shape).items()}


def real(cfg, mesh, shape):
    # the traced step's own code on real tensors (token ids 0); the fake
    # group moves no data, so only the counts are read
    dryrun.input_specs = zeros
    try:
        with CostMode("cpu") as cost:
            dryrun._trace(cfg, shape, mesh, True, 1, True, cost, "cpu")
    finally:
        dryrun.input_specs = specs
    return cost.flops


out = {}
with dryrun.fake_world(8):
    mesh = make_mesh((2, 4), ("data", "model"), dryrun.trace_device())
    for arch in ["llama3.2-3b", "deepseek-moe-16b", "rwkv6-1.6b",
                 "zamba2-1.2b"]:
        cfg = get_arch(arch).smoke().replace(num_heads=4, num_kv_heads=4)
        for shape in (TRAIN, DECODE):
            art = dryrun.trace_cell(cfg, shape, mesh)
            out[f"{arch} {shape.kind}"] = {
                "status": art["status"], "flops": art["flops_per_device"],
                "real": real(cfg, mesh, shape),
                "device": art["trace_device"],
                "collectives": art["collective_counts_scan_body"]}
print(json.dumps(out))
"""


def test_traced_steps_on_8_fake_ranks():
    res = subprocess.run([sys.executable, "-c", TWIN], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(out) == 8
    for cell, r in out.items():
        assert r["status"] == "OK", cell
        assert r["flops"] > 0, cell
        assert r["flops"] == r["real"], (cell, r)
        assert r["device"] == dryrun.trace_device()
        assert sum(r["collectives"].values()) > 0, cell
