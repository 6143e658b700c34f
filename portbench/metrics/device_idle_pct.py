"""Device: the share of the traced window in which no kernel, copy or memset
ran on the card."""


def read(ctx):
    return ctx.device["idle_pct"]
