"""The port's schedules (the paper's event program) and simulator: the
twins of ``tests/test_pipeline.py``.

Every schedule is built by both packages from the same partition and must
agree op for op; every simulation must give the reference's makespan and
engine busy times exactly; the validator must reject what the reference
rejects, with its message.  The reference test's assertions are then
checked on the port's objects.
"""

import pytest
from tests._hypothesis_shim import given, settings, st

import repro.core as R
import repro.core.simulator as R_sim
import repro_torch.core as T
from repro_torch.core.convert import from_reference
from _torch_helpers import op_key

dims = st.sampled_from([128, 256, 384, 512, 1024])


def _parts(*args, **kw):
    rp = R.plan_gemm_partition(*args, **kw)
    tp = T.plan_gemm_partition(*args, **kw)
    assert from_reference(rp) == tp
    return rp, tp


def _same(build, rp, tp, *args, **kw):
    """The port's ``build(tp, ...)``, after holding it op for op (and its
    stats) equal to the reference's ``build(rp, ...)``."""
    ref = getattr(R, build)(rp, *args, **kw)
    port = getattr(T, build)(tp, *args, **kw)
    assert [op_key(o) for o in port.ops] == [op_key(o) for o in ref.ops]
    assert T.schedule_stats(port) == R.schedule_stats(ref)
    return ref, port


def _sim(ref, port, rhw, thw):
    rs, ts = R.simulate(ref, rhw), T.simulate(port, thw)
    assert ts.makespan == rs.makespan and ts.busy == rs.busy
    assert ts.op_spans == rs.op_spans
    return ts


@given(M=dims, N=dims, K=dims,
       nstreams=st.sampled_from([1, 2]),
       nbuf=st.sampled_from([1, 2, 3]),
       frac=st.sampled_from([3, 4, 8]))
@settings(max_examples=60, deadline=None)
def test_gemm_schedule_event_correct(M, N, K, nstreams, nbuf, frac):
    """For any partition and stream/buffer count, the port's event
    program is the reference's and passes the validator (deadlock-free,
    no live buffer overwritten, under any legal interleaving)."""
    full = (M * K + K * N + M * N) * 4
    rp, tp = _parts(M, N, K, max(full // frac, 700_000), 4)
    _, sched = _same("build_gemm_schedule", rp, tp, nstreams=nstreams,
                     nbuf=nbuf)
    T.validate_schedule(sched)
    st_ = T.schedule_stats(sched)
    assert st_["flops"] >= 2 * M * N * K
    # every block of C travels H2D once and D2H once
    assert st_["d2h_bytes"] == M * N * 4


def test_gemm_schedule_transfers_B_once_per_column():
    rp, part = _parts(1024, 1024, 512, 2_000_000, 4)
    _, sched = _same("build_gemm_schedule", rp, part)
    b_ops = [o for o in sched.ops if o.tag.startswith("S(b")]
    assert len(b_ops) == part.w  # column reuse (vendor baseline re-sends)
    _, vend = _same("build_vendor_schedule", rp, part, tile=512)
    vb_ops = [o for o in vend.ops if o.tag.startswith("S(b")]
    assert len(vb_ops) == 4  # one B panel per 512-tile of C: no reuse


def test_vendor_B_retransfer_bytes_exceed_lib():
    """Claim C3's mechanism: the vendor schedule re-sends B panels per C
    tile, so its B traffic exceeds the library's once-per-column reuse."""
    rp, part = _parts(2048, 2048, 1024, 8_000_000, 4)
    _, lib = _same("build_gemm_schedule", rp, part)
    _, vend = _same("build_vendor_schedule", rp, part, tile=512)

    def b_bytes(sched):
        return sum(o.bytes for o in sched.ops
                   if o.kind == T.OpKind.H2D and o.tag.startswith("S(b"))

    assert b_bytes(vend) > b_bytes(lib)
    # lib moves each B column exactly once: K*N elements total
    assert b_bytes(lib) == 1024 * 2048 * 4
    # vendor re-sends the panel for every tile row of C
    n_tile_rows = (2048 + 511) // 512
    assert b_bytes(vend) == n_tile_rows * 1024 * 2048 * 4
    assert T.schedule_stats(vend)["h2d_bytes"] \
        > T.schedule_stats(lib)["h2d_bytes"]


def test_syrk_schedule_event_correct():
    """The SYRK spec compiles to the reference's valid event program,
    the panel's transposed slices transferred once per column."""
    rp, part = _parts(1024, 1024, 256, 3_000_000, 4)
    for ns, nb in ((1, 1), (2, 2), (2, 3)):
        _, sched = _same("build_syrk_schedule", rp, part, nstreams=ns,
                         nbuf=nb)
        T.validate_schedule(sched)
    _, sched = _same("build_syrk_schedule", rp, part)
    pt_ops = [o for o in sched.ops if o.tag.startswith("S(pt")]
    assert len(pt_ops) == part.w  # column reuse, like GEMM's B


def test_attention_schedule_valid():
    args = (8192, 8, 128, 4 * 2**20, 2)
    rp = R.plan_attention_partition(*args)
    part = T.plan_attention_partition(*args)
    assert from_reference(rp) == part
    _, sched = _same("build_attention_schedule", rp, part, 8, 128, 32)
    T.validate_schedule(sched)


def _two_streams(mod):
    dev = mod.Device("HBM", 0, 1 << 20)
    return mod.Schedule(dev, mod.StreamFactory.create(dev, 2))


def _rejected(build):
    """The port's validator rejects ``build(T)`` with the message the
    reference's gives for ``build(R)``."""
    with pytest.raises(R.ScheduleError) as rexc:
        R.validate_schedule(build(R))
    with pytest.raises(T.ScheduleError) as texc:
        T.validate_schedule(build(T))
    assert str(texc.value) == str(rexc.value)


def test_validator_catches_missing_wait():
    def build(mod):
        sched = _two_streams(mod)
        sched.issue(mod.Op(kind=mod.OpKind.H2D, tag="S(a0)", stream=0,
                           records=mod.Event("r0"),
                           buffers_written=(("A", 0),), bytes=64))
        # compute on the OTHER stream without waiting for the transfer
        sched.issue(mod.Op(kind=mod.OpKind.COMPUTE, tag="GEMM", stream=1,
                           buffers_read=(("A", 0),), flops=10))
        return sched

    _rejected(build)


def test_validator_catches_deadlock():
    def build(mod):
        sched = _two_streams(mod)
        e1, e2 = mod.Event("e1"), mod.Event("e2")
        sched.issue(mod.Op(kind=mod.OpKind.COMPUTE, tag="a", stream=0,
                           waits=(e2,), records=e1))
        sched.issue(mod.Op(kind=mod.OpKind.COMPUTE, tag="b", stream=1,
                           waits=(e1,), records=e2))
        return sched

    _rejected(build)


# ---------------------------------------------------------------- simulator
def _mk(M=2048, N=2048, K=1024, frac=4):
    full = (M * K + K * N + M * N) * 8
    return _parts(M, N, K, full // frac, 8)


def test_overlap_beats_serial():
    """Claim C3 mechanics: the 2-stream overlapped pipeline beats the
    non-overlapping vendor-style schedule on GPU-like hardware."""
    rp, tp = _mk()
    hw = (R.gpu_like(), T.gpu_like())
    t_lib = _sim(*_same("build_gemm_schedule", rp, tp, 2, 2), *hw).makespan
    t_vendor = _sim(*_same("build_vendor_schedule", rp, tp), *hw).makespan
    assert t_vendor > 1.5 * t_lib


def test_phi_prefers_one_stream():
    """Claim C5: on Phi-like hardware a single stream wins in the
    compute-dominated regime the paper measured (large N=K)."""
    rp, tp = _mk(8192, 8192, 8192, 6)
    t1 = _sim(*_same("build_gemm_schedule", rp, tp, 1, 2),
              R.phi_like(nstreams=1), T.phi_like(nstreams=1)).makespan
    t2 = _sim(*_same("build_gemm_schedule", rp, tp, 2, 2),
              R.phi_like(nstreams=2), T.phi_like(nstreams=2)).makespan
    assert t1 < t2


def test_gpu_prefers_two_streams():
    rp, tp = _mk()
    hw = (R.gpu_like(), T.gpu_like())
    t1 = _sim(*_same("build_gemm_schedule", rp, tp, 1, 1), *hw).makespan
    t2 = _sim(*_same("build_gemm_schedule", rp, tp, 2, 2), *hw).makespan
    assert t2 < t1


def test_simulator_conserves_work():
    rp, tp = _mk()
    rhw = R_sim.tpu_v5e_vmem()
    hw = from_reference(rhw)
    ref, sched = _same("build_gemm_schedule", rp, tp, 2, 2)
    res = _sim(ref, sched, rhw, hw)
    assert res.flops == sched.total_flops()
    # makespan >= each engine's busy time (no engine overcommitted)
    for pool, busy in res.busy.items():
        cap = hw.pools[pool]
        assert busy <= res.makespan * cap + 1e-9


def test_simulator_respects_events():
    """Every op starts after its waited events record."""
    rp, tp = _mk(1024, 1024, 512)
    ref, sched = _same("build_gemm_schedule", rp, tp, 2, 2)
    res = _sim(ref, sched, R.gpu_like(), T.gpu_like())
    end = {}
    start = {}
    for tag, stream, s, e in res.op_spans:
        start[tag] = s
        end[tag] = e
    rec = {o.records.name: o.tag for o in sched.ops if o.records}
    for o in sched.ops:
        for ev in o.waits:
            assert start[o.tag] >= end[rec[ev.name]] - 1e-12
