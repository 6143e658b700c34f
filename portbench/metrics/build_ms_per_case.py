"""Build funnel: span ``entry.prepare_n_geometries``."""


def read(ctx):
    span = ctx.spans.get("entry.prepare_n_geometries")
    if span is None or not ctx.cases:
        return None
    return 1e3 * span[0] / ctx.cases
