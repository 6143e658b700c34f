"""Within search: the outermost ``align_within.*`` spans.  ``batch`` holds
``sweep``, ``repair`` and the finishes where it runs; without it the three
stand side by side."""

OUTER = "align_within.batch"
INNER = ("align_within.sweep", "align_within.repair", "align_within.finish_tensor",
         "align_within.finish")


def read(ctx):
    if not ctx.cases:
        return None
    names = (OUTER,) if OUTER in ctx.spans else INNER
    total = sum(ctx.spans[n][0] for n in names if n in ctx.spans)
    if not any(n in ctx.spans for n in names):
        return None
    return 1e3 * total / ctx.cases
