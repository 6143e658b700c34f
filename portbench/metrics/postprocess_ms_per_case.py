"""Postprocess: span ``postprocess.pair`` (the four pairs)."""


def read(ctx):
    span = ctx.spans.get("postprocess.pair")
    if span is None or not ctx.cases:
        return None
    return 1e3 * span[0] / ctx.cases
