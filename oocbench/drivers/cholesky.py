"""Driver of ``repro_torch.core.ooc_cholesky``, the out-of-core Cholesky.

The harness's executor is passed as ``executor=`` to every call, as a
caller that factors many matrices keeps one.  The call passes the mix's
operand ``A``, the configuration's ``budget_bytes``, ``panel`` and
``options``; everything else is the library's default.
"""

from repro_torch.core import ooc_cholesky


def prepare(config, executor):
    return executor


def call(executor, operands, scalars, config):
    return ooc_cholesky(operands["A"], budget_bytes=int(config["budget_bytes"]),
                        panel=int(config["panel"]), executor=executor,
                        **scalars, **config.get("options", {}))
