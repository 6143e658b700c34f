"""Sweep kernel: launches of ``csrc/sweep_cost.cu`` (``ops.sweep.launches``)
per case."""


def read(ctx):
    if not ctx.cases or not ctx.launches:
        return None
    return ctx.launches / ctx.cases
