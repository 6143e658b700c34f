"""Rotation search: the share of pruned stages whose certificate failed, so
that the stage swept every candidate exactly (``rotation_search.prune_stats``)."""


def read(ctx):
    stages = ctx.prune.get("stages", 0)
    if not stages:
        return None
    return 100.0 * ctx.prune.get("fallbacks", 0) / stages
