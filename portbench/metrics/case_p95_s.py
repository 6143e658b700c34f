"""The 95th percentile of the wall clock of every case in the window."""

from portbench.harness import stats


def read(ctx):
    return stats.p95(ctx.case_s)
