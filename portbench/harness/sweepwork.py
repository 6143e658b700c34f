"""The least work of the rotation sweep's cost tables, and the card's peaks.

A table entry (pair f, angle k) is the larger of two directed Hausdorff
terms between the turned test set and the reference set: the forward term
over the test rows 0, st, 2st, ... (outer stride st) against every valid
reference point, the backward term over the reference rows 0, sr, ... against
every valid test point.  Its least work, whatever implements it:

- 4 operations (2 subtractions, 1 multiplication, 1 fused multiply-add) for
  each distinct point pair whose squared distance the entry needs: the
  forward pairs and the backward pairs, the pairs of a strided test row and
  a strided reference row counted once;
- 1 operation (a running minimum) for each directed use of a squared
  distance.

So a dense exact table counts 6 an unordered point pair.  Only valid
angles, valid points and non-empty pairs count.  Bytes: each input read
once, the output written once.  The least time of a table is the larger of
its operations over the card's peak rate for the points' type and its bytes
over the memory's peak rate."""

from __future__ import annotations

import contextlib

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): 3.35 TB/s of
# HBM3; 128 FP32 and 64 FP64 lanes an SM at up to 1980 MHz.
HBM_BYTES_PER_S = 3.35e12
MAX_SM_CLOCK_HZ = 1.98e9
FP_LANES_PER_SM = {4: 128, 8: 64}
OPS_PER_DISTINCT_PAIR = 4
OPS_PER_DIRECTED_USE = 1


def table_work(F, N, M, K, elem, st, sr, dense, nt, nr, nts, nrs, valid_k):
    """(operations, bytes) of one table.  ``nt`` / ``nr``: valid test /
    reference points per pair; ``nts`` / ``nrs``: valid strided rows per
    pair; ``valid_k``: valid angles per pair (sequences of length F)."""
    ops = 0
    for f in range(F):
        if nt[f] == 0 or nr[f] == 0:
            continue
        directed = nts[f] * nr[f] + nrs[f] * nt[f]
        distinct = directed - nts[f] * nrs[f]
        ops += valid_k[f] * (OPS_PER_DISTINCT_PAIR * distinct + OPS_PER_DIRECTED_USE * directed)
    nbytes = F * (N + M) * 2 * elem + (0 if dense else F * (N + M)) + F * K * (2 * elem + 1)
    return ops, nbytes


def least_seconds(ops, nbytes, elem, n_sms):
    """(seconds, "operations" or "bytes")."""
    ops_s = ops / (n_sms * FP_LANES_PER_SM[elem] * MAX_SM_CLOCK_HZ)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


@contextlib.contextmanager
def recorded_tables(sweep_module):
    """Record every ``sweep_module.cost_table`` call's shapes, strides and
    masks while the block runs (the masks are kept as they are: nothing is
    read from the card until :func:`work_of` is called after the block)."""
    calls = []
    inner = sweep_module.cost_table

    def recording(test, ref, test_mask, ref_mask, angles, angles_valid, *,
                  dense=False, outer_stride_test=1, outer_stride_ref=1):
        F, N, _ = test.shape
        calls.append((F, N, ref.shape[1], test.element_size(), None if dense else test_mask,
                      None if dense else ref_mask, angles_valid, bool(dense),
                      int(outer_stride_test), int(outer_stride_ref)))
        return inner(test, ref, test_mask, ref_mask, angles, angles_valid, dense=dense,
                     outer_stride_test=outer_stride_test, outer_stride_ref=outer_stride_ref)

    sweep_module.cost_table = recording
    try:
        yield calls
    finally:
        sweep_module.cost_table = inner


def work_of(call):
    """(operations, bytes, element size) of one recorded call."""
    F, N, M, elem, tm, rm, valid, dense, st, sr = call
    K = valid.shape[1]
    if dense:
        nt, nr = [N] * F, [M] * F
        nts, nrs = [-(-N // st)] * F, [-(-M // sr)] * F
    else:
        nt, nr = tm.sum(1).tolist(), rm.sum(1).tolist()
        nts, nrs = tm[:, ::st].sum(1).tolist(), rm[:, ::sr].sum(1).tolist()
    ops, nbytes = table_work(F, N, M, K, elem, st, sr, dense, nt, nr, nts, nrs,
                             valid.sum(1).tolist())
    return ops, nbytes, elem


def least_time(calls, n_sms):
    """Least seconds of all recorded tables, and the bound that holds for
    most of that time."""
    total = 0.0
    by = {"operations": 0.0, "bytes": 0.0}
    for call in calls:
        ops, nbytes, elem = work_of(call)
        s, which = least_seconds(ops, nbytes, elem, n_sms)
        total += s
        by[which] += s
    return total, max(by, key=by.get)
