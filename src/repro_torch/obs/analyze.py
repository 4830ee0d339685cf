"""Port of ``src/repro/obs/analyze.py`` (JAX-free), held against it by
``tests/test_torch_analyze.py`` (``to_json`` key for key, floats exact) and
on the card by ``chip_smoke.py`` (``[analyze]`` lines); a copy of the
reference apart from its imports and one guard: a backward walk that comes
back to an op it has already left raises instead of looping (the
reference's walk never revisits an op on input it can finish).

What the port's spans are.  On a card ``ScheduleExecutor(record_spans=
True)`` times each op with CUDA events on the stream that runs it, with no
per-op synchronize, so overlap between engines survives into the spans.
An op's span starts after its host-side preparation (an H2D's fill of
pinned staging, a write-back landing), so host time the card waits for
shows up as gaps and ``idle-wait`` segments, the reference's meaning of a
host gap.  In ``issue_order`` mode every op runs on one CUDA stream, so
the spans are serial across the schedule's streams; in ``concurrent``
mode each schedule stream's ops run on its engines' streams, each after
its stream predecessor's completion event, so a schedule stream's spans
sorted by start are in issue order, as :func:`_place` needs.

Bottleneck attribution over the unified span timeline (DESIGN.md §11).

The observability layer (§10) records *what* happened — spans, byte
counters, drift ratios.  This module explains *why a run took as long as it
did*: :class:`TraceAnalysis` consumes a span timeline (the simulator's
``SimResult.op_spans``, an executor's wall-clock ``last_spans``, or a
Tracer flat group) together with the
:class:`~repro_torch.core.streams.Schedule` that produced it, and computes

  * **per-stream utilization** — busy/idle segmentation of every stream,
    with each idle gap attributed to the event or engine the stream was
    waiting on;
  * **the exact critical path** — the chain of ops that tiles
    ``[0, makespan]`` with no gaps, reconstructed backward through the
    schedule's dependency event graph, each segment classified as
    ``h2d`` / ``d2h`` / ``compute`` / ``merge`` / ``eviction-stall``;
  * **a bottleneck verdict** — transfer-bound, compute-bound or
    dependency-bound, from the critical path's class shares.

Exactness.  ``simulate()`` places every op at ``start = max(stream-free,
engine-free, waited-event times)``: each component is the *end* of some
already-placed op (or 0.0), so every op's start equals a predecessor's end
as an exact float.  The backward walk therefore finds, for every op on the
path, a certificate predecessor — its stream predecessor, a waited event's
recorder, or a same-pool op (engine contention) — whose end *equals* its
start, and the resulting segments tile ``[0, makespan]`` with float-exact
abutment.  ``tests/test_torch_analyze.py`` pins this reconciliation across
GEMM, SYRK, Cholesky-with-lookahead and hybrid gpu+phi runs.

Wall-clock spans (``TraceAnalysis.from_spans`` with ``tolerance > 0``) get
the best-effort version: predecessors match within the tolerance, real host
gaps appear as ``idle-wait`` filler segments, and ``exact`` is False.

Eviction stalls.  An event edge whose *successor* is an H2D op means the
transfer was issued but gated on a buffer release — a block-cache eviction
wait in the GEMM/SYRK pipelines (H2D ops wait on nothing else there), a
write-back-before-restream ordering in the factor pipelines.  The tail of
the blocking op's segment, from the moment the stalled transfer's stream
went idle, is reclassified ``eviction-stall`` so "time spent waiting to
transfer" is attributed separately from "time spent transferring".
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.simulator import HardwareModel, SimResult
from repro_torch.core.streams import Op, OpKind, Schedule

FlatSpan = Tuple[str, int, float, float]      # (tag, stream, start, end)

#: every class a critical-path segment can carry
PATH_CLASSES = ("h2d", "d2h", "compute", "merge", "eviction-stall",
                "idle-wait")

#: bottleneck verdicts, from the critical path's class shares
VERDICTS = ("transfer-bound", "compute-bound", "dependency-bound")


def _op_class(op: Op) -> str:
    if op.kind == OpKind.H2D:
        return "h2d"
    if op.kind == OpKind.D2H:
        return "d2h"
    return "merge" if op.tag.lower().startswith("merge") else "compute"


@dataclasses.dataclass(frozen=True)
class PathSegment:
    """One interval of the critical path (``[start, end)``)."""

    tag: str                 # op tag ("(waiting)" for idle-wait filler)
    stream: int              # issuing stream (-1 for filler)
    start: float
    end: float
    cls: str                 # one of PATH_CLASSES
    detail: str = ""         # event name / stalled transfer / pool

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_json(self) -> dict:
        return {"tag": self.tag, "stream": self.stream,
                "start": self.start, "end": self.end,
                "class": self.cls, "detail": self.detail,
                "seconds": self.duration}


@dataclasses.dataclass(frozen=True)
class StreamStats:
    """Busy/idle accounting for one stream over ``[0, makespan]``."""

    stream: int
    n_ops: int
    busy_seconds: float
    idle_seconds: float
    utilization: float

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class IdleGap:
    """One idle interval of a stream, attributed to what it waited on."""

    stream: int
    start: float
    end: float
    next_tag: str            # the op that ran when the gap closed ("" = none)
    cause: str               # "event rC[3] <- DGEMM[3]" / "h2d engine busy.."

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["seconds"] = self.duration
        return d


class _Placed:
    """One op matched to its span (start/end on the run's timeline)."""

    __slots__ = ("op", "stream", "idx", "start", "end", "pool")

    def __init__(self, op: Op, stream: int, idx: int, start: float,
                 end: float, pool: str):
        self.op = op
        self.stream = stream
        self.idx = idx
        self.start = start
        self.end = end
        self.pool = pool


def _place(sched: Schedule, spans: Sequence[FlatSpan],
           hw: Optional[HardwareModel]
           ) -> Tuple[List[_Placed], List[List[_Placed]]]:
    """Pair every span with its scheduled op.

    Streams execute their ops in issue order, so the spans of one stream —
    sorted by start — zip positionally with that stream's op list; tags are
    cross-checked so a span list from a *different* schedule is rejected
    instead of silently mis-attributed.
    """
    per: Dict[int, List[FlatSpan]] = defaultdict(list)
    for sp in spans:
        per[sp[1]].append(sp)
    unknown = set(per) - set(range(len(sched.streams)))
    if unknown:
        raise ValueError(f"spans reference streams {sorted(unknown)} "
                         f"not in the schedule")
    placed: List[_Placed] = []
    rows: List[List[_Placed]] = []
    for si, st in enumerate(sched.streams):
        got = sorted(per.get(si, ()), key=lambda t: (t[2], t[3]))
        if len(got) != len(st.ops):
            raise ValueError(
                f"stream {si}: {len(got)} spans for {len(st.ops)} scheduled "
                f"ops — spans and schedule do not describe the same run")
        row: List[_Placed] = []
        for idx, (op, (tag, _, s, e)) in enumerate(zip(st.ops, got)):
            if tag != op.tag:
                raise ValueError(
                    f"stream {si} op {idx}: span tag {tag!r} does not match "
                    f"scheduled op {op.tag!r}")
            pool = hw.kind_pool[op.kind] if hw is not None else op.kind.name
            row.append(_Placed(op, si, idx, float(s), float(e), pool))
        rows.append(row)
        placed.extend(row)
    return placed, rows


class TraceAnalysis:
    """Critical path + utilization + verdict for one executed schedule.

    Build via :meth:`from_sim` (exact, the default reconciliation target),
    :meth:`from_spans` (wall-clock spans, best effort), or :meth:`analyze`
    (simulate then attribute, one call).
    """

    def __init__(self, sched: Schedule, spans: Sequence[FlatSpan],
                 makespan: Optional[float] = None,
                 hw: Optional[HardwareModel] = None,
                 tolerance: float = 0.0,
                 source: str = "sim"):
        if not spans:
            raise ValueError("cannot analyze an empty span list")
        self.schedule = sched
        self.hw = hw
        self.source = source
        self.tolerance = float(tolerance)
        self.exact = self.tolerance == 0.0
        placed, rows = _place(sched, spans, hw)
        self._placed = placed
        self._rows = rows
        self.n_ops = len(placed)
        self.origin = 0.0 if self.exact else min(p.start for p in placed)
        end = max(p.end for p in placed)
        self.makespan = float(makespan) if makespan is not None else end
        if self.exact and self.makespan != end:
            raise ValueError(
                f"makespan {self.makespan} != last span end {end}: "
                f"spans do not cover the run")
        # modeled totals, recomputed from the paired ops (reconciled against
        # SimResult / schedule_stats by verify_reconciliation)
        self.h2d_bytes = sum(p.op.bytes for p in placed
                             if p.op.kind == OpKind.H2D)
        self.d2h_bytes = sum(p.op.bytes for p in placed
                             if p.op.kind == OpKind.D2H)
        self.flops = sum(p.op.flops for p in placed
                         if p.op.kind == OpKind.COMPUTE)
        self.busy_by_pool: Dict[str, float] = {}
        for p in placed:
            self.busy_by_pool[p.pool] = (self.busy_by_pool.get(p.pool, 0.0)
                                         + (p.end - p.start))
        self._recorder: Dict[str, _Placed] = {
            p.op.records.name: p for p in placed if p.op.records is not None}
        self._by_end: Dict[float, List[_Placed]] = defaultdict(list)
        for p in placed:
            self._by_end[p.end].append(p)
        self.path = self._critical_path()
        self.class_seconds: Dict[str, float] = {}
        for seg in self.path:
            self.class_seconds[seg.cls] = (self.class_seconds.get(seg.cls,
                                                                  0.0)
                                           + seg.duration)
        span = self.makespan - self.origin
        self.shares: Dict[str, float] = {
            cls: (secs / span if span > 0 else 0.0)
            for cls, secs in self.class_seconds.items()}
        self.verdict = self._verdict()
        self.streams, self.gaps = self._stream_stats()

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_sim(cls, sched: Schedule, res: SimResult,
                 hw: Optional[HardwareModel] = None) -> "TraceAnalysis":
        """Exact attribution of one ``simulate()`` result."""
        return cls(sched, res.op_spans, makespan=res.makespan, hw=hw,
                   tolerance=0.0, source="sim")

    @classmethod
    def from_spans(cls, sched: Schedule, spans: Sequence[FlatSpan],
                   hw: Optional[HardwareModel] = None,
                   tolerance: Optional[float] = None) -> "TraceAnalysis":
        """Best-effort attribution of wall-clock (executor/Tracer) spans.

        Wall times carry host scheduling noise, so predecessors match
        within ``tolerance`` (default: 1 % of the observed makespan) and
        un-certificated waiting shows up as ``idle-wait`` segments."""
        end = max(e for _, _, _, e in spans)
        tol = tolerance if tolerance is not None else max(1e-9, 0.01 * end)
        return cls(sched, spans, makespan=None, hw=hw, tolerance=tol,
                   source="spans")

    @classmethod
    def analyze(cls, sched: Schedule, hw: HardwareModel
                ) -> Tuple["TraceAnalysis", SimResult]:
        """Simulate ``sched`` under ``hw`` and attribute it, in one call."""
        from repro_torch.core.simulator import simulate

        res = simulate(sched, hw)
        return cls.from_sim(sched, res, hw=hw), res

    # -- critical path -------------------------------------------------------
    def _ends_at(self, p: _Placed, t: float) -> bool:
        if self.exact:
            return p.end == t
        return abs(p.end - t) <= self.tolerance

    def _predecessor(self, cur: _Placed
                     ) -> Tuple[Optional[_Placed], str, str]:
        """The certificate predecessor whose end equals ``cur.start``:
        stream predecessor, waited-event recorder, or same-pool op (engine
        contention), in that preference order."""
        t = cur.start
        if cur.idx > 0:
            sp = self._rows[cur.stream][cur.idx - 1]
            if self._ends_at(sp, t):
                return sp, "stream", ""
        for ev in cur.op.waits:
            rec = self._recorder.get(ev.name)
            if rec is not None and self._ends_at(rec, t):
                return rec, "event", ev.name
        for cand in self._by_end.get(t, ()):
            if cand is not cur and cand.pool == cur.pool:
                return cand, "engine", cur.pool
        if not self.exact:
            # wall-clock fallback: the latest dependency ending at or
            # before t (+tol); any remaining gap becomes idle-wait filler
            cands: List[Tuple[str, str, _Placed]] = []
            if cur.idx > 0:
                cands.append(("stream", "",
                              self._rows[cur.stream][cur.idx - 1]))
            for ev in cur.op.waits:
                rec = self._recorder.get(ev.name)
                if rec is not None:
                    cands.append(("event", ev.name, rec))
            cands = [c for c in cands if c[2].end <= t + self.tolerance]
            if cands:
                kind, detail, pred = max(cands, key=lambda c: c[2].end)
                return pred, kind, detail
        return None, "", ""

    def _critical_path(self) -> List[PathSegment]:
        tail = max(self._placed, key=lambda p: (p.end, -p.stream))
        links: List[Tuple[_Placed, _Placed, str, str]] = []
        cur = tail
        seen = {id(cur)}
        while cur.start > self.origin + self.tolerance:
            pred, kind, detail = self._predecessor(cur)
            if pred is None:
                if self.exact:
                    raise RuntimeError(
                        f"no exact predecessor for {cur.op.tag!r} at "
                        f"t={cur.start!r}: these spans are not simulate() "
                        f"output — use from_spans(tolerance=...)")
                break
            if id(pred) in seen:
                # zero-length spans that end where each other start, in
                # one pool: the walk would cycle between them
                raise RuntimeError(
                    f"critical path cycles at {pred.op.tag!r} "
                    f"(t={pred.start!r}): zero-length spans in pool "
                    f"{pred.pool!r} end where each other start")
            seen.add(id(pred))
            links.append((pred, cur, kind, detail))
            cur = pred
        links.reverse()
        chain = [cur] + [succ for _, succ, _, _ in links]

        segs: List[PathSegment] = []
        prev_end = self.origin
        for i, p in enumerate(chain):
            start = max(p.start, prev_end)
            if start > prev_end:
                segs.append(PathSegment("(waiting)", -1, prev_end, start,
                                        "idle-wait", ""))
            if p.end <= start:
                prev_end = max(prev_end, p.end)
                continue
            base = _op_class(p.op)
            detail = ""
            if i > 0:
                _, _, kind, d = links[i - 1]
                detail = {"event": f"after {d}",
                          "engine": f"{d} engine busy",
                          "stream": "in-stream order"}.get(kind, "")
            link = links[i] if i < len(links) else None
            if (link is not None and link[2] == "event"
                    and link[1].op.kind == OpKind.H2D):
                # the next path op is a transfer gated on this op's event:
                # from the moment that transfer's stream went idle, this
                # op's remaining execution is an eviction stall
                succ = link[1]
                ready = (self._rows[succ.stream][succ.idx - 1].end
                         if succ.idx > 0 else self.origin)
                cut = min(max(start, ready), p.end)
                if cut > start:
                    segs.append(PathSegment(p.op.tag, p.stream, start, cut,
                                            base, detail))
                segs.append(PathSegment(
                    p.op.tag, p.stream, cut, p.end, "eviction-stall",
                    f"holding {succ.op.tag} (waits {link[3]})"))
            else:
                segs.append(PathSegment(p.op.tag, p.stream, start, p.end,
                                        base, detail))
            prev_end = p.end
        if self.makespan > prev_end:
            segs.append(PathSegment("(waiting)", -1, prev_end,
                                    self.makespan, "idle-wait", ""))
        return segs

    def _verdict(self) -> str:
        transfer = self.shares.get("h2d", 0.0) + self.shares.get("d2h", 0.0)
        compute = self.shares.get("compute", 0.0)
        if transfer >= 0.5:
            return "transfer-bound"
        if compute >= 0.5:
            return "compute-bound"
        return "dependency-bound"

    # -- streams -------------------------------------------------------------
    def _gap_cause(self, nxt: Optional[_Placed]) -> str:
        if nxt is None:
            return "drained (no further ops this stream)"
        t = nxt.start
        for ev in nxt.op.waits:
            rec = self._recorder.get(ev.name)
            if rec is not None and self._ends_at(rec, t):
                return f"event {ev.name} <- {rec.op.tag}"
        for cand in self._by_end.get(t, ()):
            if cand is not nxt and cand.pool == nxt.pool:
                return f"{nxt.pool} engine busy ({cand.op.tag})"
        return "host/dependency"

    def _stream_stats(self) -> Tuple[List[StreamStats], List[IdleGap]]:
        stats: List[StreamStats] = []
        gaps: List[IdleGap] = []
        span = self.makespan - self.origin
        for si, row in enumerate(self._rows):
            busy = sum(p.end - p.start for p in row)
            stats.append(StreamStats(
                stream=si, n_ops=len(row), busy_seconds=busy,
                idle_seconds=span - busy,
                utilization=busy / span if span > 0 else 0.0))
            prev = self.origin
            for p in row:
                if p.start > prev + self.tolerance:
                    gaps.append(IdleGap(si, prev, p.start, p.op.tag,
                                        self._gap_cause(p)))
                prev = max(prev, p.end)
            if self.makespan > prev + self.tolerance:
                gaps.append(IdleGap(si, prev, self.makespan, "",
                                    self._gap_cause(None)))
        return stats, gaps

    # -- accessors -----------------------------------------------------------
    def stream_utilization(self) -> Dict[int, float]:
        return {s.stream: s.utilization for s in self.streams}

    def pool_utilization(self, pool: str) -> float:
        span = self.makespan - self.origin
        return self.busy_by_pool.get(pool, 0.0) / span if span > 0 else 0.0

    def top_gaps(self, n: int = 5) -> List[IdleGap]:
        return sorted(self.gaps, key=lambda g: -g.duration)[:n]

    def digest(self) -> str:
        """One line: verdict, class shares, per-stream utilization."""
        shares = " ".join(f"{c}={self.shares[c]*100:.0f}%"
                          for c in PATH_CLASSES if c in self.shares)
        utils = " ".join(f"s{s.stream}={s.utilization*100:.0f}%"
                         for s in self.streams)
        return (f"{self.verdict}; critical path: {shares}; "
                f"stream utilization: {utils}")

    # -- reconciliation ------------------------------------------------------
    def verify_reconciliation(self, res: Optional[SimResult] = None,
                              stats: Optional[dict] = None) -> dict:
        """Assert the attribution's accounting is exact (raises otherwise).

        Checks: the critical path tiles ``[0, makespan]`` with float-exact
        abutment and its durations sum to the makespan; per-stream busy
        totals equal the span totals; the attributed H2D/D2H bytes and
        flops equal ``SimResult`` / ``schedule_stats`` totals; per-pool
        busy time matches the simulator's engine accounting.
        """
        assert self.exact, "reconciliation is defined for exact analyses"
        p = self.path
        assert p[0].start == 0.0, f"path starts at {p[0].start}, not 0.0"
        assert p[-1].end == self.makespan, \
            f"path ends at {p[-1].end}, not makespan {self.makespan}"
        for a, b in zip(p, p[1:]):
            assert a.end == b.start, \
                f"path gap: {a.tag} ends {a.end}, {b.tag} starts {b.start}"
        assert not any(seg.cls == "idle-wait" for seg in p), \
            "exact critical path must not contain idle-wait filler"
        total = sum(seg.duration for seg in p)
        assert abs(total - self.makespan) <= 1e-12 * max(self.makespan, 1.0)
        busy_streams = sum(s.busy_seconds for s in self.streams)
        busy_spans = sum(pl.end - pl.start for pl in self._placed)
        assert abs(busy_streams - busy_spans) <= 1e-12 * max(busy_spans, 1.0)
        out = {"critical_path_seconds": total,
               "busy_seconds": busy_spans}
        if res is not None:
            assert self.h2d_bytes == res.h2d_bytes, \
                f"h2d {self.h2d_bytes} != SimResult {res.h2d_bytes}"
            assert self.d2h_bytes == res.d2h_bytes
            assert self.flops == res.flops
            assert self.makespan == res.makespan
            for pool, b in res.busy.items():
                mine = self.busy_by_pool.get(pool, 0.0)
                assert abs(mine - b) <= 1e-9 * max(b, 1.0), \
                    f"pool {pool}: busy {mine} != simulator {b}"
        if stats is not None:
            assert self.h2d_bytes == stats["h2d_bytes"], \
                f"h2d {self.h2d_bytes} != schedule_stats {stats['h2d_bytes']}"
            assert self.d2h_bytes == stats["d2h_bytes"]
            assert self.flops == stats["flops"]
            assert self.n_ops == stats["n_ops"]
        return out

    # -- export --------------------------------------------------------------
    def to_json(self, max_path: int = 0, max_gaps: int = 10) -> dict:
        """Plain-JSON attribution document (``max_path=0`` = full path)."""
        path = self.path if max_path <= 0 else self.path[:max_path]
        return {
            "source": self.source,
            "exact": self.exact,
            "makespan_seconds": self.makespan,
            "verdict": self.verdict,
            "shares": dict(sorted(self.shares.items())),
            "class_seconds": dict(sorted(self.class_seconds.items())),
            "critical_path": [seg.to_json() for seg in path],
            "critical_path_ops": len(self.path),
            "streams": [s.to_json() for s in self.streams],
            "top_gaps": [g.to_json() for g in self.top_gaps(max_gaps)],
            "pool_busy_seconds": dict(sorted(self.busy_by_pool.items())),
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
            "flops": self.flops,
            "n_ops": self.n_ops,
        }


def analyze_plan(plan, profile) -> Tuple[TraceAnalysis, SimResult]:
    """Attribute a :class:`~repro_torch.tune.search.TunedPlan`: recompile the
    exact schedule the tuner ranked and analyze it under the profile's
    engine model for the plan's stream count."""
    from repro_torch.core.pipeline import (compile_pipeline,
                                           gemm_pipeline_spec,
                                           syrk_pipeline_spec)

    if plan.kernel == "gemm":
        spec = gemm_pipeline_spec(plan.gemm_partition(),
                                  write_back=plan.write_back,
                                  traversal=plan.traversal, band=plan.nbuf)
    elif plan.kernel == "syrk":
        spec = syrk_pipeline_spec(plan.gemm_partition(),
                                  traversal=plan.traversal, band=plan.nbuf)
    else:
        raise ValueError(f"analyze_plan cannot recompile {plan.kernel!r}")
    sched = compile_pipeline(spec, nstreams=plan.nstreams, nbuf=plan.nbuf,
                             evict=plan.evict)
    return TraceAnalysis.analyze(sched, profile.model_for(plan.nstreams))
