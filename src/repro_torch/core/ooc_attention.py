"""Out-of-core attention — the engine's second data-parallel kernel.

Port of ``src/repro/core/ooc_attention.py``, held against it by
``tests/test_torch_attention.py`` and on the card by ``chip_smoke.py``.

The KV cache plays the role of the out-of-core operand; queries stay
resident; each streamed (K, V) block updates an online-softmax carry
(m, l, acc) — a different merge operator in the same schedule as MMOOC.
The :func:`attention_pipeline_spec` schedule runs on the shared
:class:`~repro_torch.core.runtime.ScheduleExecutor`, with the ``attn`` /
``attn_out`` handlers below running the two passes of the hand-written
flash-decoding kernel (``csrc/flash_attention.cu``) where the reference
calls XLA.

Device memory.  The carry (f32, in ``state.scratch``), q in f32 and the
partials scratch are allocated once, at step 0, and updated in place; no
block allocates anything.  In ``concurrent`` mode consecutive ``attn`` ops
run on different streams and ``attn_out`` on the D2H stream, ordered by the
schedule's ``carry`` buffer edges: a tensor freed and re-made per block
could be freed on one stream while another still reads it.

``tune="auto"`` plans the KV block length, stream count and buffer depth
through an :class:`~repro_torch.tune.AutoTuner` and records the run's
measured wall and bytes against the plan's prediction
(``obs.record_drift``).

``devices=`` co-executes the query across a device set
(``repro_torch.hybrid``): the KV cache is split into contiguous position
chunks, each member folds its chunk into an online-softmax partial on its
own executor, and the partials merge exactly on the host.

A page-locked cache.  A server that keeps a long KV cache in host RAM
keeps it page-locked; :func:`~repro_torch.core.runtime.page_lock` locks a
caller's tensor in place.  The executor then copies every (contiguous)
block of K and V straight from the cache by DMA, with no pinned staging
and no host copy (``last_direct_h2d_bytes``); a pageable cache is staged
as before.  The results are the same either way.

Each call is one ``obs.call("attention")``: when the executor records
spans, or a tracer is active, its host work is recorded by span
(``attention.intake``: the operands as host tensors and q's move to the
device; ``attention.plan``: the partition and the schedule;
``attention.execute``: the executor's run; ``attention.out``: the final
cast; ``attention.drift`` when tuned) on ``get_observability().calls``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.core.oocgemm import (_entry_call, _hybrid_kwargs,
                                      _record_host_drift)
from repro_torch.core.partitioner import plan_attention_partition
from repro_torch.core.pipeline import build_attention_schedule
from repro_torch.core.runtime import (ExecState, ScheduleExecutor,
                                      as_tensor, compute_dtype, host_tensor,
                                      register_op_handler, resolve_device)
from repro_torch.core.streams import BlockRef, Op, validate_schedule
from repro_torch.kernels import flash_attention as kfa
from repro_torch.obs import get_observability

# positions per split of the partial pass inside each streamed KV block
BLOCK_S = 512


def _step0(st: ExecState, kb: torch.Tensor) -> None:
    """Carry (NEG_INF, 0, 0), q in f32 and the partials scratch, on the KV
    buffers' device, sized for step 0's block (the largest: only the last
    block of a schedule is ragged).

    On a card the buffers come from the default stream's pool, whose freed
    blocks every run reuses.  A ``concurrent`` executor keeps its engine
    streams across runs, but its first run's streams are new, and
    :func:`ooc_attention` makes a new executor per call unless the caller
    passes one: allocating on such a stream makes the caching allocator
    call cudaMalloc in the run's first ``attn`` op, which with H2D copies
    in flight stalled that op by up to ~0.1 s.  The current stream first
    waits for the default stream, so no work still queued there can touch
    a reused block; the buffers are initialised on the current stream."""
    rows, _, d = kb.shape
    dev = kb.device
    q = torch.as_tensor(st.ctx["q"]).to(device=dev, dtype=torch.float32)
    q = q.reshape(1, -1, d).contiguous()
    H = q.shape[1]
    n = kfa.nsplits(rows, BLOCK_S)
    f32 = dict(dtype=torch.float32, device=dev)
    pool = contextlib.nullcontext()
    if dev.type == "cuda":
        default = torch.cuda.default_stream(dev)
        torch.cuda.current_stream(dev).wait_stream(default)
        pool = torch.cuda.stream(default)
    with pool:
        carry = tuple(torch.empty(s, **f32)
                      for s in ((1, H), (1, H), (1, H, d)))
        st.scratch["partials"] = tuple(torch.empty(s, **f32)
                                       for s in (H * n, H * n, H * n * d))
        st.scratch["final"] = torch.empty((1, H, d), **f32)
    carry[0].fill_(kfa.NEG_INF)
    carry[1].zero_()
    carry[2].zero_()
    st.scratch["q"] = q
    st.scratch["carry"] = carry


@register_op_handler("attn")
def _attn_handler(st: ExecState, op: Op, ref: BlockRef) -> None:
    """Online-softmax merge of one KV block into the (m, l, acc) carry: the
    partial pass over the block's splits, then the combine pass folding
    them into the carry in place."""
    kb = st.bufs[op.buffers_read[0]]     # (rows, Hkv, d) parity-buffer view
    vb = st.bufs[op.buffers_read[1]]
    if "carry" not in st.scratch:
        _step0(st, kb)
    q = st.scratch["q"]
    rows, _, d = kb.shape
    H = q.shape[1]
    n = kfa.nsplits(rows, BLOCK_S)
    flat = st.scratch["partials"]
    if n * H > flat[0].numel():
        raise ValueError(f"KV block of {rows} rows is larger than step 0's")
    parts = (flat[0][:H * n].view(1, H, n), flat[1][:H * n].view(1, H, n),
             flat[2][:H * n * d].view(1, H, n, d))
    kfa.flash_partial(q, kb.unsqueeze(0), vb.unsqueeze(0), rows,
                      block_s=BLOCK_S, out=parts)
    kfa.flash_combine(parts, carry=st.scratch["carry"])


@register_op_handler("attn_out")
def _attn_out_handler(st: ExecState, op: Op, ref: BlockRef) -> None:
    """Finalize: normalise the carry (l clamped at 1e-20) on the device and
    land it in the host output, on the current stream."""
    res = kfa.flash_combine(None, carry=st.scratch["carry"], normalise=True,
                            out=st.scratch["final"])
    out = st.outputs["out"]
    out.copy_(res[0].reshape(out.shape))


@_entry_call("attention")
def ooc_attention(
    q,
    k_cache,
    v_cache,
    *,
    budget_bytes: int,
    nstreams: int = 2,
    nbuf: int = 2,
    validate: bool = False,
    tune=None,
    tuner=None,
    devices=None,
    tolerance=None,
    executor: Optional[ScheduleExecutor] = None,
    torch_device=None,
) -> torch.Tensor:
    """Single-query (decode-shaped) attention over an out-of-core KV cache.

    q: (H, d); k_cache/v_cache: (S, Hkv, d) in host memory (numpy arrays or
    CPU tensors; the KV dtype stays as it is on the device).  Returns an
    (H, d) CPU tensor in q's dtype: the f32 carry lands in an f32 host
    buffer and is cast once at the end, so a narrower KV dtype does not
    quantize the result.

    executor: a prepared :class:`ScheduleExecutor` (for instance one with
    ``mode="concurrent"`` or ``record_spans=True``); its torch device is
    used.  ``torch_device`` (default: CUDA) otherwise; with no card pass
    ``torch_device="cpu"`` for the kernels' plain versions.

    tune: ``None`` uses the defaults above; ``"auto"`` plans the KV block
    length, stream count and buffer depth through an
    :class:`~repro_torch.tune.AutoTuner` (``tuner`` or the process
    default), served from the plan cache on repeat calls.

    devices: a set of :class:`~repro_torch.hybrid.DeviceSpec` co-executes
    the query across all of them — the KV cache is split into contiguous
    position chunks sized so the profiles predict equal finish times
    (``tolerance`` overrides the balancer default), each member folds its
    chunk into an online-softmax partial on ``torch_device`` (or the
    executor's), and the partials merge exactly.  Budgets come from the
    specs, so ``budget_bytes`` is ignored on this path.
    """
    if tune not in (None, "auto"):
        raise ValueError(f"unknown tune mode {tune!r}; expected None/'auto'")
    if devices is not None:
        from repro_torch.hybrid import (plan_hybrid_attention,
                                        run_hybrid_attention)
        from repro_torch.tune.search import dtype_name

        dev = executor.torch_device if executor is not None \
            else resolve_device(torch_device)
        q = as_tensor(q)
        k_cache = host_tensor(k_cache)
        S, hkv, d = k_cache.shape
        hplan = plan_hybrid_attention(S, hkv, d, q.shape[0], devices,
                                      dtype=dtype_name(k_cache.dtype),
                                      **_hybrid_kwargs(tolerance))
        out, _ = run_hybrid_attention(q, k_cache, v_cache, hplan,
                                      validate=validate, torch_device=dev)
        return out.to(compute_dtype(q.dtype))
    if executor is None:
        dev = resolve_device(torch_device)
        obs = get_observability()
        executor = ScheduleExecutor(record_spans=obs.tracer is not None,
                                    torch_device=dev)
    elif torch_device is not None \
            and resolve_device(torch_device) != executor.torch_device:
        raise ValueError(f"torch_device {torch_device} differs from the "
                         f"executor's {executor.torch_device}")
    obs = get_observability()
    with obs.span("attention.intake"):
        q = as_tensor(q)
        k_cache = host_tensor(k_cache)
        v_cache = host_tensor(v_cache)
        q_dev = q.to(device=executor.torch_device, dtype=torch.float32)
    S, hkv, d = k_cache.shape
    H = q.shape[0]

    plan = None
    with obs.span("attention.plan"):
        if tune == "auto":
            from repro_torch.tune import get_default_tuner
            from repro_torch.tune.search import dtype_name

            if tuner is None:
                tuner = get_default_tuner()
            plan = tuner.attention_plan(S, hkv, d, H, budget_bytes,
                                        dtype=dtype_name(k_cache.dtype))
            part = plan.attention_partition()
            nstreams, nbuf = plan.nstreams, plan.nbuf
        else:
            part = plan_attention_partition(
                S, hkv, d, budget_bytes, bytes_per_el=k_cache.element_size())
        sched = build_attention_schedule(part, hkv, d, H,
                                         nstreams=nstreams, nbuf=nbuf)
        if validate:
            validate_schedule(sched)

    out = torch.zeros((H, d), dtype=torch.float32)
    with obs.span("attention.execute"):
        executor.run(
            sched,
            operands={"K": k_cache, "V": v_cache},
            outputs={"out": out},
            ctx={"q": q_dev},
        )
    _record_host_drift(plan, executor, sched, "attention")
    with obs.span("attention.out"):
        return out.to(compute_dtype(q.dtype))
