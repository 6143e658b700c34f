"""Centerline three-point: spans ``centerline.preprocess``,
``centerline.three_point`` and ``centerline.apply`` (the start's mapping
and the finish's) per case."""

SPANS = ("centerline.preprocess", "centerline.three_point", "centerline.apply")


def read(ctx):
    if not ctx.cases or not any(n in ctx.spans for n in SPANS):
        return None
    return 1e3 * sum(ctx.spans[n][0] for n in SPANS if n in ctx.spans) / ctx.cases
