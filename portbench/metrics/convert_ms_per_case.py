"""Converters: span ``converters.numpy_to_inputdata`` per case (the arrays
of a case turned into the port's input bundles)."""

SPAN = "converters.numpy_to_inputdata"


def read(ctx):
    span = ctx.spans.get(SPAN)
    if span is None or not ctx.cases:
        return None
    return 1e3 * span[0] / ctx.cases
