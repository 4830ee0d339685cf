"""``attn_roofline``: kernel 2's share of its roofline over the schedules'
``attn`` ops.  Each such op runs the flash-decoding kernel pair on one
streamed KV block (the partial pass over the block's splits, then the
combine into the carry).  The least time the card could take for an op is
the larger of its flops over the float32 peak (kernel 2 computes in
float32 on the CUDA cores) and its bytes over the peak bandwidth; the
share is their sum over the ops' summed device seconds (the executor's
spans).

The work is what the inputs need, whatever the kernels read again:
``4 H rows d`` flops (``q . k`` and ``p v``, ``2 d`` each a query head and
position); the block's K and V read once in the cache's dtype, q read once
and the carry (``m``, ``l``, ``acc`` of every query head, float32) read and
written once.  The split partials that the partial pass writes and the
combine reads are the kernel's own traffic and are not counted.  The
shapes come from the slices the schedule's transfers land in each op's
buffers and from the output's shape, so the metric reads the same work
whatever computes it."""

from oocbench.harness.ops import spans_of
from oocbench.harness.traffic import dtype_of


def attn_blocks(er):
    """``(op index, rows)`` of every ``attn`` op of the run: the positions
    of the K block it reads, from the slice landed in its first buffer."""
    positions = er.shapes["K"][0]
    landed = {}
    for i, op in enumerate(er.sched.ops):
        kind = op.kind.name
        if kind == "H2D":
            landed[op.buffers_written[0]] = op.payload
        elif kind == "COMPUTE" and getattr(op.payload, "kernel", None) \
                == "attn":
            ref = landed[op.buffers_read[0]]
            yield i, (ref.rows[1] if ref.rows is not None else positions)


def block_flops(rows, heads, d):
    return 4 * heads * rows * d


def block_bytes(rows, heads, kv_heads, d, element_bytes):
    return (2 * rows * kv_heads * d * element_bytes   # K and V
            + heads * d * 4                           # q, float32
            + 2 * heads * (d + 2) * 4)                # carry read, written


def read(run):
    if run.peaks is None:
        return None
    flops_peak = run.peaks["flops"]["float32"]
    bw = run.peaks["bytes_per_s"]
    elt = dtype_of(run.config).itemsize
    bound = secs = 0.0
    compute_bound = True
    for e in run.execs:
        heads, d = e.shapes["out"]
        kv_heads = e.shapes["K"][1]
        blocks = list(attn_blocks(e))
        s = spans_of(e, [i for i, _ in blocks])
        if not blocks or s is None:
            return None
        for _, rows in blocks:
            t_ops = block_flops(rows, heads, d) / flops_peak
            t_mem = block_bytes(rows, heads, kv_heads, d, elt) / bw
            compute_bound &= t_ops >= t_mem
            bound += max(t_ops, t_mem)
        secs += s
    if secs <= 0:
        return None
    run.note(f"attn_roofline: bound by "
             f"{'operations' if compute_bound else 'bytes, in part'}: "
             f"{bound!r} s at the peaks against {secs!r} s of spans")
    return 100.0 * bound / secs
