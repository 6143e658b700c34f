"""Cases completed in the window over the window's seconds (to the end of
the last case)."""

from portbench.harness import stats


def read(ctx):
    return stats.rate(ctx.cases, ctx.window_s)
