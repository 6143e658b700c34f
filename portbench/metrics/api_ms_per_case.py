"""API and converters: each case's wall clock less the entry's span
(``numpy_to_inputdata``, the ``_processing`` wrapper, the pull)."""


def read(ctx):
    span = ctx.spans.get(ctx.config["entry_span"])
    if span is None or not ctx.cases:
        return None
    return 1e3 * (sum(ctx.case_s) - span[0]) / ctx.cases
