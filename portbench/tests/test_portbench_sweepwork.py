"""The sweep's least work against hand counts and a brute-force count of
the distinct point pairs each table entry needs."""

import itertools

import pytest
import torch

from portbench.harness import sweepwork


def _call(F, N, M, K, st=1, sr=1, dense=True, tm=None, rm=None, valid=None, elem=4):
    valid = torch.ones((F, K), dtype=torch.bool) if valid is None else valid
    return (F, N, M, elem, tm, rm, valid, dense, st, sr)


def _brute(N, M, st, sr, tm, rm):
    """(distinct pairs, directed uses) of one entry, enumerated."""
    t = [i for i in range(N) if tm[i]]
    r = [j for j in range(M) if rm[j]]
    if not t or not r:
        return 0, 0
    fwd = {(i, j) for i in t if i % st == 0 for j in r}
    bwd = {(i, j) for j in r if j % sr == 0 for i in t}
    return len(fwd | bwd), len(fwd) + len(bwd)


def test_dense_exact_table_counts_six_an_unordered_pair():
    ops, nbytes, elem = sweepwork.work_of(_call(3, 10, 7, 5))
    assert ops == 3 * 5 * 6 * 10 * 7
    assert nbytes == 3 * 17 * 2 * 4 + 3 * 5 * 9 and elem == 4


def test_dense_strided_table():
    # test rows 0, 6 of 10 (2), ref rows 0, 6 of 7 (2)
    ops, _, _ = sweepwork.work_of(_call(1, 10, 7, 1, st=6, sr=6))
    directed = 2 * 7 + 2 * 10
    distinct = directed - 2 * 2
    assert ops == 4 * distinct + directed


def test_invalid_angles_count_nothing():
    valid = torch.tensor([[True, False, True], [False, False, False]])
    ops, _, _ = sweepwork.work_of(_call(2, 4, 4, 3, valid=valid))
    assert ops == 2 * 6 * 16


@pytest.mark.parametrize("st,sr", [(1, 1), (6, 6), (2, 3), (5, 1)])
def test_masked_tables_against_enumeration(st, sr):
    g = torch.Generator().manual_seed(st * 10 + sr)
    F, N, M, K = 4, 13, 11, 3
    tm = torch.rand((F, N), generator=g) < 0.7
    rm = torch.rand((F, M), generator=g) < 0.6
    tm[2] = False  # an empty set: no work
    valid = torch.rand((F, K), generator=g) < 0.8
    ops, nbytes, _ = sweepwork.work_of(_call(F, N, M, K, st, sr, False, tm, rm, valid, 8))
    want = 0
    for f in range(F):
        distinct, directed = _brute(N, M, st, sr, tm[f].tolist(), rm[f].tolist())
        want += int(valid[f].sum()) * (4 * distinct + directed)
    assert ops == want
    assert nbytes == F * (N + M) * 2 * 8 + F * (N + M) + F * K * 17


def test_dense_equals_masked_all_valid():
    tm, rm = torch.ones((2, 9), dtype=torch.bool), torch.ones((2, 8), dtype=torch.bool)
    for st, sr in itertools.product((1, 3), (1, 4)):
        dense = sweepwork.work_of(_call(2, 9, 8, 4, st, sr))[0]
        masked = sweepwork.work_of(_call(2, 9, 8, 4, st, sr, False, tm, rm))[0]
        assert dense == masked


def test_least_seconds_names_its_bound():
    s, which = sweepwork.least_seconds(132 * 128 * 1.98e9, 1.0, 4, 132)
    assert which == "operations" and s == pytest.approx(1.0)
    s, which = sweepwork.least_seconds(1.0, 3.35e12, 8, 132)
    assert which == "bytes" and s == pytest.approx(1.0)


def test_recorded_tables_keeps_shapes_and_masks():
    class Sweep:
        @staticmethod
        def cost_table(test, ref, tm, rm, angles, valid, *, dense=False,
                       outer_stride_test=1, outer_stride_ref=1):
            return "table"

    mod = Sweep()
    test, ref = torch.zeros((2, 5, 2)), torch.zeros((2, 4, 2))
    valid = torch.ones((2, 3), dtype=torch.bool)
    with sweepwork.recorded_tables(mod) as calls:
        assert mod.cost_table(test, ref, None, None, None, valid, dense=True,
                              outer_stride_test=6, outer_stride_ref=6) == "table"
    assert calls == [(2, 5, 4, 4, None, None, valid, True, 6, 6)]
    assert mod.cost_table is Sweep.cost_table
