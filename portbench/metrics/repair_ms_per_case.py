"""Certification: the repair tiers per case, spans
``argmin_repair.device_f64`` (the flagged searches again in float64 on the
card) and ``argmin_repair.host_exact`` (the exact host ladder).  A window
that flagged nothing spent nothing on repair: 0.0.  A program that flagged
searches but has neither span gives nothing to read."""

SPANS = ("argmin_repair.device_f64", "argmin_repair.host_exact")


def read(ctx):
    if not ctx.cases:
        return None
    if not any(n in ctx.spans for n in SPANS):
        return 0.0 if not ctx.repair.get("flagged", 0) else None
    return 1e3 * sum(ctx.spans[n][0] for n in SPANS if n in ctx.spans) / ctx.cases
