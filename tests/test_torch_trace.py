"""Chrome-trace export on the port: the twins of ``tests/test_trace.py``.

Simulated spans must export to the reference's trace document, event for
event; the port's executor on the CPU must record one host-clock span per
op in issue order (on a card ``tests/test_torch_card.py`` holds its
CUDA-event spans) and compute the reference's result within its fp32
tolerance.
"""

import json

import numpy as np
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.core.convert import from_reference
from _torch_helpers import one_torch_thread, op_key  # noqa: F401

CPU = "cpu"


def _runtime(ex):
    # no card: the tier's size is given, not read from the device
    return T.HostOocRuntime(T.Device("HBM", 0, 1 << 30), executor=ex)


def _sched():
    args = (512, 384, 256, 1_000_000, 4)
    rpart, part = R.plan_gemm_partition(*args), T.plan_gemm_partition(*args)
    assert from_reference(rpart) == part
    ref = R.build_gemm_schedule(rpart, nstreams=2, nbuf=2)
    sched = T.build_gemm_schedule(part, nstreams=2, nbuf=2)
    assert [op_key(o) for o in sched.ops] == [op_key(o) for o in ref.ops]
    return part, sched, (rpart, ref)


def test_sim_result_to_chrome_trace():
    part, sched, (_, rsched) = _sched()
    res = T.simulate(sched, T.gpu_like())
    trace = res.to_chrome_trace()
    assert trace == R.simulate(rsched, R.gpu_like()).to_chrome_trace()
    events = trace["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) == len(sched.ops)
    by_name = {e["name"]: e for e in xs}
    for tag, stream, start, end in res.op_spans:
        e = by_name[tag]
        assert e["tid"] == stream
        assert e["ts"] == start * 1e6
        assert e["dur"] >= 0
    # categories follow the schedule's tag grammar
    assert by_name["DGEMM[0]"]["cat"] == "compute"
    assert all(e["cat"] == "h2d" for e in xs if e["name"].startswith("S("))
    assert all(e["cat"] == "d2h" for e in xs if e["name"].startswith("R("))
    # metadata names one thread per stream
    tids = {e["tid"] for e in events if e["name"] == "thread_name"}
    assert tids == {0, 1}
    json.dumps(trace)  # serializable as-is


def test_executor_records_real_spans(rng):
    part, sched, (rpart, rsched) = _sched()
    A = rng.standard_normal((512, 256)).astype(np.float32)
    B = rng.standard_normal((256, 384)).astype(np.float32)
    C = rng.standard_normal((512, 384)).astype(np.float32)
    ex = T.ScheduleExecutor(record_spans=True, torch_device=CPU)
    out = _runtime(ex).gemm(A, B, C, 1.0, 1.0, part,
                           schedule=sched)
    expect = A.astype(np.float64) @ B + C
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-4)
    ref = R.HostOocRuntime().gemm(A, B, C, 1.0, 1.0, rpart,
                                  schedule=rsched)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)

    spans = ex.last_spans
    assert len(spans) == len(sched.ops)
    assert [t for t, _, _, _ in spans] == [o.tag for o in sched.ops]
    prev_start = 0.0
    for tag, stream, start, end in spans:
        assert end >= start >= prev_start >= 0.0  # serialized dispatch order
        prev_start = start
    # the recorded spans feed the same trace exporter as the simulator,
    # and the reference's exporter reads them alike
    trace = T.chrome_trace(spans, process_name="exec")
    assert sum(e["ph"] == "X" for e in trace["traceEvents"]) == len(spans)
    assert trace == R.chrome_trace(spans, process_name="exec")


def test_write_chrome_trace_file(tmp_path):
    _, sched, (_, rsched) = _sched()
    res = T.simulate(sched, T.gpu_like())
    path = tmp_path / "trace.json"
    T.write_chrome_trace(str(path), res.op_spans)
    loaded = json.loads(path.read_text())
    assert loaded["displayTimeUnit"] == "ms"
    assert any(e["ph"] == "X" for e in loaded["traceEvents"])
    rpath = tmp_path / "ref.json"
    R.write_chrome_trace(str(rpath),
                         R.simulate(rsched, R.gpu_like()).op_spans)
    assert loaded == json.loads(rpath.read_text())


def test_record_spans_off_by_default(rng):
    part, sched, _ = _sched()
    ex = T.ScheduleExecutor(torch_device=CPU)
    assert ex.record_spans is False
    A = rng.standard_normal((512, 256)).astype(np.float32)
    B = rng.standard_normal((256, 384)).astype(np.float32)
    C = np.zeros((512, 384), np.float32)
    out = _runtime(ex).gemm(A, B, C, 1.0, 0.0, part,
                           schedule=sched)
    assert ex.last_spans == []
    assert torch.equal(out, T.ooc_gemm(A, B, C, budget_bytes=1 << 30,
                                       torch_device=CPU))
