"""Certification: searches flagged as near ties and re-decided in float64
(``argmin_repair.stats["flagged"]``) per search made."""


def read(ctx):
    if not ctx.searches:
        return None
    return 100.0 * ctx.repair.get("flagged", 0) / ctx.searches
