"""Centerline entry glue: the self time of span ``entry.align_combined``
per case (the geometry's copies, the turns, the refine's angle grid and
first-wins scan: what no child span names)."""

SPAN = "entry.align_combined"


def read(ctx):
    span = ctx.spans.get(SPAN)
    if span is None or len(span) < 3 or not ctx.cases:
        return None
    return 1e3 * span[2] / ctx.cases
