"""Between: spans ``align_between.search``, ``.repair`` and ``.epilogue``
of both stages."""

SPANS = ("align_between.search", "align_between.repair", "align_between.epilogue")


def read(ctx):
    if not ctx.cases or not any(n in ctx.spans for n in SPANS):
        return None
    return 1e3 * sum(ctx.spans[n][0] for n in SPANS if n in ctx.spans) / ctx.cases
