"""The least work of the centerline refine's Hausdorff tables, from the
counts the port keeps of them (``multimodars_torch.utils.trace.counts()``).

A table entry (candidate c) is the squared symmetric 2-D Hausdorff distance
of c's points against its shift's filtered cloud: every valid (candidate
point, cloud point) pair's squared distance serves both directions.  By
``sweepwork.py``'s rule, whatever implements it: 4 operations (2
subtractions, 1 multiplication, 1 fused multiply-add) a distinct point pair
and 1 (a running minimum) a directed use of its squared distance, so 6 a
valid pair.  Bytes: each input read once, the output written once, as the
port counts them (``hausdorff_batch.bytes.<dtype>``).  The least time of a
dtype's tables is the larger of its operations over the card's peak rate
for that type and its bytes over the memory's peak rate; every refine table
is bound by its operations some 700 times over, so the larger of
the two sums equals the sum of each table's larger."""

from __future__ import annotations

from portbench.harness.sweepwork import (FP_LANES_PER_SM, HBM_BYTES_PER_S, MAX_SM_CLOCK_HZ,
                                         OPS_PER_DIRECTED_USE, OPS_PER_DISTINCT_PAIR)

OPS_PER_VALID_PAIR = OPS_PER_DISTINCT_PAIR + 2 * OPS_PER_DIRECTED_USE
ELEMENT_SIZE = {"float32": 4, "float64": 8}
PREFIX = "hausdorff_batch."


def least_time(counts: dict, n_sms: int):
    """(least seconds of every counted table, "operations" or "bytes", the
    bound of most of that time), or None where no table was counted."""
    total = 0.0
    by = {"operations": 0.0, "bytes": 0.0}
    for name, elem in ELEMENT_SIZE.items():
        if not counts.get(f"{PREFIX}tables.{name}"):
            continue
        ops = OPS_PER_VALID_PAIR * counts.get(f"{PREFIX}valid_pairs.{name}", 0)
        ops_s = ops / (n_sms * FP_LANES_PER_SM[elem] * MAX_SM_CLOCK_HZ)
        bytes_s = counts.get(f"{PREFIX}bytes.{name}", 0) / HBM_BYTES_PER_S
        which = "operations" if ops_s >= bytes_s else "bytes"
        total += max(ops_s, bytes_s)
        by[which] += max(ops_s, bytes_s)
    if not total:
        return None
    return total, max(by, key=by.get)


def window_counts():
    """The port's counters since the harness last reset its spans (which
    clears them too), or None where the port keeps none."""
    from multimodars_torch.utils import trace

    counts = getattr(trace, "counts", None)
    return counts() if counts is not None else None
