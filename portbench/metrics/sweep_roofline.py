"""Sweep kernel: the least time of every cost table of the window
(``harness/sweepwork.py``: 4 operations a distinct point pair, 1 a directed
use, or the bytes, at the card's peaks) over the device time of the
``sweep_cost_kernel`` events."""

from portbench.harness import devtrace, sweepwork

KERNEL = "sweep_cost_kernel"


def read(ctx):
    device_s = devtrace.device_seconds(ctx.device, KERNEL)
    if not ctx.tables or device_s <= 0.0:
        return None
    least_s, bound = sweepwork.least_time(ctx.tables, ctx.n_sms)
    return {"value": 100.0 * least_s / device_s, "bound": bound,
            "power_limit": ctx.card["power_limit"]}
