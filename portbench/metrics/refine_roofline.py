"""Refine kernel: the least time of every refine table of the window
(``harness/refinework.py``: 6 operations a valid pair, or the bytes, at the
card's peaks for the table's type) over the device time of the
``hausdorff_batch_kernel`` events."""

from portbench.harness import devtrace, refinework

KERNEL = "hausdorff_batch_kernel"


def read(ctx):
    counts = refinework.window_counts()
    device_s = devtrace.device_seconds(ctx.device, KERNEL)
    if not counts or device_s <= 0.0:
        return None
    least = refinework.least_time(counts, ctx.n_sms)
    if least is None:
        return None
    return {"value": 100.0 * least[0] / device_s, "bound": least[1],
            "power_limit": ctx.card["power_limit"]}
