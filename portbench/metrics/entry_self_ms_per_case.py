"""Entry glue: the self time of the configuration's ``entry_span`` per
case, the entry's time that none of its child spans names."""


def read(ctx):
    span = ctx.spans.get(ctx.config["entry_span"])
    if span is None or len(span) < 3 or not ctx.cases:
        return None
    return 1e3 * span[2] / ctx.cases
