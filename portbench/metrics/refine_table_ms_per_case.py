"""Refine table: spans ``centerline.refine_pack`` (padding and masks),
``centerline.refine_sweep`` (upload, kernel, pull) and
``centerline.refine_repair`` (the float64 re-run and host-exact
candidates) per case; the spans a program has, where it lacks one."""

SPANS = ("centerline.refine_pack", "centerline.refine_sweep", "centerline.refine_repair")


def read(ctx):
    if not ctx.cases or not any(n in ctx.spans for n in SPANS):
        return None
    return 1e3 * sum(ctx.spans[n][0] for n in SPANS if n in ctx.spans) / ctx.cases
