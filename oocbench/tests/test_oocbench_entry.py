"""A cell of a new entry point from added files alone.

In a ``tiny`` copy of the benchmark, ``repro_torch.core.ooc_attention``
(decode attention over a KV cache in host RAM, with 3-D K and V) comes in
as a configuration would bring it: a driver that passes the harness's
executor, a plain-PyTorch reference with its useful work and its control,
a cut file, a traffic mix, limits and a metric of that cell only, and
entries of ``BENCHMARK.json``.  Every per-cell check of the other test
modules then runs on it; no file of the benchmark is edited.
"""

import json
import textwrap

import pytest

from oocbench_tiny import cut_configs, tiny  # noqa: F401  (the fixture)
from repro_torch.obs import get_observability
from test_oocbench_control import check_control
from test_oocbench_faults import FAULTS, check_fault
from test_oocbench_harness import (check_cell_files, check_counts,
                                   check_loads_no_jax, check_result_line)
from test_oocbench_phases import (check_call_records,
                                  check_untraced_records_nothing)

CELL = "attn-f32.decode"

DRIVER = '''
"""Driver of ``repro_torch.core.ooc_attention``: one query's heads over
the mix's K and V, with the harness's executor."""

from repro_torch.core import ooc_attention


def prepare(config, executor):
    return executor


def call(executor, operands, scalars, config):
    return ooc_attention(operands["q"], operands["K"], operands["V"],
                         budget_bytes=int(config["budget_bytes"]),
                         executor=executor, **scalars,
                         **config.get("options", {}))
'''

REFERENCE = '''
"""Plain reference of decode attention, softmax(q K^T / sqrt(d)) V with
each KV head shared by a group of query heads; the control multiplies
TF32-rounded operands."""

import math

import torch

from oocbench.reference.precision import full_float32, tf32


def useful_flops(shapes):
    (S, _, d), (H, _) = shapes["K"], shapes["q"]
    return 4 * H * S * d


def solve(operands, scalars, control=False):
    q, k, v = (operands[n].float() for n in ("q", "K", "V"))
    if control:
        q, k, v = tf32(q), tf32(k), tf32(v)
    S, hkv, d = k.shape
    qg = q.view(hkv, q.shape[0] // hkv, d)
    with full_float32():
        p = torch.softmax(torch.einsum("hgd,shd->hgs", qg, k)
                          / math.sqrt(d), dim=-1)
        return torch.einsum("hgs,shd->hgd", p, v).reshape(q.shape)
'''

METRIC = '''
"""``kv_blocks``: the KV blocks a call streams (its ``attn`` ops)."""

from oocbench.harness.ops import ops_where


def read(run):
    calls = [c for c in run.calls if c.execs]
    if not calls:
        return None
    return sum(len(ops_where(e, "COMPUTE", ("attn",)))
               for c in calls for e in c.execs) / len(calls)
'''


def _add_attention(root):
    bench = root / "oocbench"
    files = {
        "drivers/attention.py": textwrap.dedent(DRIVER),
        "reference/attention.py": textwrap.dedent(REFERENCE),
        "metrics/kv_blocks.py": textwrap.dedent(METRIC),
        "configs/attn-f32.json": json.dumps({
            "name": "attn-f32", "entry": "attention", "dtype": "float32",
            "s": 4194304, "heads": 64, "kv_heads": 8, "head_dim": 128,
            "budget_bytes": 512 << 20, "reduced": [], "departures": {}}),
        "tests/cuts/attention.json": json.dumps({
            "config": {"s": 2048, "heads": 8, "kv_heads": 2, "head_dim": 16,
                       "budget_bytes": 128 << 10},
            "useful_flops": "equal",
            "fault": {"at": "repro_torch.kernels.flash_attention"
                            ".flash_combine",
                      "state": "carry", "scale": None,
                      "when": {"normalise": False}}}),
        "traffic/decode.json": json.dumps({
            "loop": "closed", "operand_sets": 2,
            "operands": {
                "q": {"shape": ["heads", "head_dim"], "dist": "normal"},
                "K": {"shape": ["s", "kv_heads", "head_dim"],
                      "dist": "normal"},
                "V": {"shape": ["s", "kv_heads", "head_dim"],
                      "dist": "normal"}},
            "scalars": {},
            "check": {"rows_per_call": 64, "full_per_set": 1}}),
        f"limits/{CELL}.json": json.dumps({"max_err": {"limit": 1e-5}}),
    }
    for path, text in files.items():
        assert not (bench / path).exists(), path
        (bench / path).write_text(text)
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "attn-f32", "source": "x", "reduced": [],
                         "file": "oocbench/configs/attn-f32.json",
                         "why": "x"})
    m["workloads"].append({"name": CELL, "config": "attn-f32",
                           "traffic": "decode", "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "kv_blocks", "unit": "blocks",
                           "better": "lower", "source": "program_counter",
                           "layer": "kernels", "moves": "tflops",
                           "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cut_configs(root)
    return root


@pytest.fixture
def attention(tiny):
    get_observability().calls.clear()
    yield _add_attention(tiny)
    get_observability().calls.clear()


def test_files_of_the_new_cell(attention):
    check_cell_files(attention, CELL)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_of_the_new_cell(attention, monkeypatch, trace):
    check_result_line(attention, CELL, trace, monkeypatch)


def test_counts_of_the_new_cell(attention):
    check_counts(attention, CELL)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_in_the_new_cell(attention, monkeypatch, fault):
    check_fault(attention, CELL, fault, monkeypatch)


def test_control_of_the_new_cell(attention):
    check_control(attention, CELL)


def test_call_records_of_the_new_cell(attention):
    check_call_records(attention, CELL)
    get_observability().calls.clear()
    check_untraced_records_nothing(attention, CELL)


def test_new_cell_loads_no_jax(attention):
    check_loads_no_jax(attention, [CELL])
