"""``dgemm_roofline``: the least time the card could take for the
schedules' ``dgemm`` block products, the sum over them of the larger of
``2 m n k`` over the peak FLOP/s and the operands' bytes over the peak
bandwidth, over the summed device seconds of their spans.  The shapes come
from the schedule's transfers (``oocbench/harness/ops.py``), the time from
the executor's spans, so the metric reads the same work whatever computes
the products."""

from oocbench.harness.ops import (block_products, product_bytes,
                                  product_flops, spans_of)
from oocbench.harness.traffic import dtype_of


def read(run):
    flops_peak = run.peak_flops()
    if flops_peak is None:
        return None
    bw = run.peaks["bytes_per_s"]
    elt = dtype_of(run.config).itemsize
    bound = secs = 0.0
    compute_bound = True
    for e in run.execs:
        beta = float(e.ctx.get("beta", 0.0))
        prods = list(block_products(e))
        s = spans_of(e, [i for i, *_ in prods])
        if not prods or s is None:
            return None
        for _, m, n, k in prods:
            t_ops = product_flops(m, n, k) / flops_peak
            t_mem = product_bytes(m, n, k, beta, elt) / bw
            compute_bound &= t_ops >= t_mem
            bound += max(t_ops, t_mem)
        secs += s
    if secs <= 0:
        return None
    run.note(f"dgemm_roofline: bound by "
             f"{'operations' if compute_bound else 'bytes, in part'}: "
             f"{bound!r} s at the peaks against {secs!r} s of spans")
    return 100.0 * bound / secs
