"""Driver of ``repro_torch.core.ooc_gemm``, the out-of-core MMOOC.

One long-lived :class:`~repro_torch.core.HostOocRuntime` over the harness's
executor serves every call, as a caller that multiplies many matrices keeps
one; its memory tier is the configuration's ``budget_bytes``, the budget the
entry point plans with.  The call passes the mix's operands ``A``, ``B`` and,
where the mix has one, ``C``; ``alpha``/``beta`` from the mix's scalars;
``budget_bytes`` and the configuration's ``options``.  Everything else is the
library's default.
"""

from repro_torch.core import Device, HostOocRuntime, ooc_gemm


def prepare(config, executor):
    return HostOocRuntime(Device("HBM", 0, int(config["budget_bytes"])),
                          executor=executor)


def call(runtime, operands, scalars, config):
    return ooc_gemm(operands["A"], operands["B"], operands.get("C"),
                    budget_bytes=int(config["budget_bytes"]),
                    runtime=runtime, **scalars,
                    **config.get("options", {}))
