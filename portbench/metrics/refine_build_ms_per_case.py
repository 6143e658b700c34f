"""Centerline refine build: span ``centerline.refine_build`` per case (every
shift's candidates made on the host)."""


def read(ctx):
    span = ctx.spans.get("centerline.refine_build")
    if span is None or not ctx.cases:
        return None
    return 1e3 * span[0] / ctx.cases
