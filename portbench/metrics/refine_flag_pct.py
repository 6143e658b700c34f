"""Certification of the refine: grids flagged as near ties and re-decided
in float64 (``argmin_repair.stats["flagged"]``) per refine table swept
(calls of span ``centerline.refine_sweep``)."""


def read(ctx):
    sweep = ctx.spans.get("centerline.refine_sweep")
    if sweep is None or not sweep[1]:
        return None
    return 100.0 * ctx.repair.get("flagged", 0) / sweep[1]
