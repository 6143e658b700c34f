"""The shared-reference masked Hausdorff table of the PyTorch port
(``ops.hausdorff_batch``), the centerline refine's grid, against the JAX
package's ``hausdorff_sq_masked`` on the broadcast inputs the JAX refine
builds (centerline_align.py:505-516 there).

On the CPU the port takes the plain version; float64 values must agree to
rel 1e-12.  The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from multimodars_torch.ops import hausdorff_batch as hb
from multimodars_tpu.ops.hausdorff import hausdorff_sq_masked as jax_masked


def _case(S, K, n, m, seed, empty=None):
    """Candidates p [S*K, n, 2] and reference sets q [S, m, 2] with random
    masks and slots of unequal width; ``empty`` = "p" or "q" empties one
    set of the first candidate or reference slot."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0.0, 3.0, (S * K, n, 2)) + 200.0
    q = rng.normal(0.0, 3.0, (S, m, 2)) + 200.0
    pmask = rng.random((S * K, n)) > 0.2
    qmask = rng.random((S, m)) > 0.2
    # unequal widths: each slot's tail is padding
    for c in range(S * K):
        pmask[c, rng.integers(n // 2, n + 1):] = False
    for s in range(S):
        qmask[s, rng.integers(m // 2, m + 1):] = False
    pmask[:, 0] = True
    qmask[:, 0] = True
    if empty == "p":
        pmask[0] = False
    elif empty == "q":
        qmask[0] = False
    return p, pmask, q, qmask


def _jax_table(p, pmask, q, qmask, K):
    """The JAX refine's evaluation: q broadcast to every candidate."""
    S, m = q.shape[:2]
    qb = np.broadcast_to(q[:, None], (S, K, m, 2)).reshape(S * K, m, 2)
    qmb = np.broadcast_to(qmask[:, None], (S, K, m)).reshape(S * K, m)
    return np.asarray(jax_masked(qb, p, qmb, pmask), dtype=np.float64)


def _torch_args(p, pmask, q, qmask):
    return (torch.tensor(p), torch.tensor(pmask), torch.tensor(q),
            torch.tensor(qmask))


@pytest.mark.parametrize("empty", [None, "p", "q"])
@pytest.mark.parametrize("K", [1, 7])
@pytest.mark.parametrize("S", [1, 3])
def test_shared_ref_matches_jax_broadcast(S, K, empty):
    p, pmask, q, qmask = _case(S, K, 37, 45, seed=10 * S + K, empty=empty)
    want = _jax_table(p, pmask, q, qmask, K)
    got = hb.hausdorff_sq_shared_ref(*_torch_args(p, pmask, q, qmask), K)
    assert got.dtype == torch.float64 and tuple(got.shape) == (S * K,)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    if empty == "p":
        assert got[0] == 0.0
    if empty == "q":
        assert (got[:K] == 0.0).all()
    assert (got[want > 0] > 0).all()


def test_plain_version_chunks_without_changing_values(monkeypatch):
    """The plain version evaluates bounded chunks of candidates; a budget
    of one candidate per chunk gives the same table bit for bit."""
    p, pmask, q, qmask = _case(3, 7, 30, 41, seed=4)
    args = _torch_args(p, pmask, q, qmask)
    whole = hb.hausdorff_sq_shared_ref_plain(*args, 7)
    monkeypatch.setattr(hb, "_PLAIN_TILE_BUDGET", 1)
    one_by_one = hb.hausdorff_sq_shared_ref_plain(*args, 7)
    assert torch.equal(whole, one_by_one)


def test_float64_table_equals_numpy_exact():
    """The float64 table equals the host's exact numpy expression
    (dx*dx + dy*dy, exact min and max) bit for bit: the property the
    refine's certification relies on."""
    p, pmask, q, qmask = _case(2, 3, 25, 33, seed=8)
    got = hb.hausdorff_sq_shared_ref(*_torch_args(p, pmask, q, qmask), 3).numpy()
    for c in range(6):
        a, b = p[c][pmask[c]], q[c // 3][qmask[c // 3]]
        dx = a[:, None, 0] - b[None, :, 0]
        dy = a[:, None, 1] - b[None, :, 1]
        d2 = dx * dx + dy * dy
        assert got[c] == max(d2.min(axis=1).max(), d2.min(axis=0).max())


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda a: a.update(p=a["p"].float()), "dtype"),
        (lambda a: a.update(pmask=a["pmask"].to(torch.uint8)), "dtype"),
        (lambda a: a.update(q=a["q"][:, :, :1].contiguous()), "shape"),
        (lambda a: a.update(qmask=a["qmask"][:-1]), "shape"),
        (lambda a: a.update(p=a["p"].transpose(0, 1).contiguous()
                            .transpose(0, 1)), "contiguous"),
        (lambda a: a.update(K=4), "reference sets"),
    ],
)
def test_kernel_input_checks_raise(mutate, match):
    p, pmask, q, qmask = _case(3, 7, 12, 15, seed=2)
    args = dict(zip(("p", "pmask", "q", "qmask"), _torch_args(p, pmask, q, qmask)))
    args["K"] = 7
    mutate(args)
    with pytest.raises(ValueError, match=match):
        hb.check_inputs(args["p"], args["pmask"], args["q"], args["qmask"], args["K"])


def test_unsupported_device_raises():
    p, pmask, q, qmask = _case(1, 1, 5, 6, seed=1)
    args = [t.to("meta") for t in _torch_args(p, pmask, q, qmask)]
    with pytest.raises(ValueError, match="no hausdorff_batch kernel"):
        hb.hausdorff_sq_shared_ref(*args, 1)


# --- the kernel's launch planner and its tile and merge order --------------

# (C, n, m): sets of 1-3 points; OCT-280's 279 pairs of 520 points; the
# refine table (S 5 x K 31); n << m and n >> m; a set above 2**16 points
PLAN_SHAPES = [(1, 1, 1), (3, 2, 3), (2, 3, 1), (279, 520, 520), (155, 11200, 11178),
               (4, 100, 5000), (4, 5000, 100), (2, 70000, 300)]


def _plan_shape_cases():
    for C, n, m in PLAN_SHAPES:
        for elem in (4, 8):
            for sms, occ in ((hb.SMS, None), (1, None), (hb.SMS, "narrow")):
                yield C, n, m, elem, sms, occ


def _occupancy(elem, occ):
    """The model's table, or one where wide blocks cannot be resident at all
    and narrow ones only once (a card the planner must still cover)."""
    table = hb.model_occupancy(elem)
    if occ == "narrow":
        table = tuple((R, tuple(1 if w <= 4 else 0 for w in range(1, hb.MAX_WARPS + 1)))
                      for R, _ in table)
    return table


@pytest.mark.parametrize("C, n, m, elem, sms, occ", list(_plan_shape_cases()))
def test_plan_covers_every_pair_once_in_whole_waves(C, n, m, elem, sms, occ):
    """Every (candidate, row, column) pair is in exactly one block; where
    there is work for a block an SM, the blocks come in whole waves (the
    busiest SM holds at most a quarter more than the mean); no row tile is
    under half the planned rows; the plan's variant, widths and counts are
    what the kernel checks before it launches."""
    table = _occupancy(elem, occ)
    plan = hb.plan_launch(C, n, m, elem, sms, table)
    rows, cols = (m, n) if plan.swap else (n, m)
    U = hb.UNIT[elem]
    assert plan.rows_per_thread in hb.ROWS_PER_THREAD[elem]
    assert 1 <= plan.warps <= hb.MAX_WARPS
    assert dict(table)[plan.rows_per_thread][plan.warps - 1] >= 1
    assert plan.groups == -(-rows // (32 * plan.rows_per_thread))
    assert plan.chunks == -(-cols // (hb.CHUNK * U))
    assert 1 <= plan.tiles <= plan.groups and -(-plan.groups // plan.tiles) <= plan.warps
    assert plan.splits * plan.chunks_per_split >= plan.chunks
    assert (plan.splits - 1) * plan.chunks_per_split < plan.chunks
    assert plan.blocks == C * plan.tiles * plan.splits
    assert (plan.waves - 1) * plan.slots < plan.blocks <= plan.waves * plan.slots
    per_sm = -(-plan.blocks // sms)
    if C * n * m >= 32 * 64 * sms:  # work enough for a block an SM
        assert per_sm * sms <= hb._WAVE_SLACK * plan.blocks
    by_c = [[] for _ in range(C)]
    for c, (r0, r1), (j0, j1) in hb.blocks_of(C, n, m, elem, plan):
        by_c[c].append((r0, r1, j0, j1))
    planned = -(-rows // plan.tiles)
    first = sorted(by_c[0])
    row_ranges = sorted({b[:2] for b in first})
    col_ranges = sorted({b[2:] for b in first})
    assert len(first) == len(row_ranges) * len(col_ranges) == plan.tiles * plan.splits
    assert set(first) == {r + c for r in row_ranges for c in col_ranges}
    for ranges, total in ((row_ranges, rows), (col_ranges, cols)):
        assert ranges[0][0] == 0 and ranges[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(r1 > r0 for r0, r1 in ranges)
    assert all(2 * (r1 - r0) >= planned for r0, r1 in row_ranges)
    assert all(sorted(blocks) == first for blocks in by_c)


def test_plan_refuses_what_the_kernel_cannot_take():
    for args in ((0, 5, 5, 4), (3, 0, 5, 4), (3, 5, 0, 8), (3, 5, 5, 2), (3, 5, 5, 4, 0)):
        with pytest.raises(ValueError):
            hb.plan_launch(*args)


def _forced_plan(C, n, m, elem, swap, R, W, Z):
    """A plan of the kernel's form with the given row side, R, block width
    and split count: the fewest tiles of W groups."""
    rows, cols = (m, n) if swap else (n, m)
    G = -(-rows // (32 * R))
    T = -(-G // W)
    chunks = -(-cols // (hb.CHUNK * hb.UNIT[elem]))
    cps = -(-chunks // Z)
    Z = -(-chunks // cps)
    return hb.LaunchPlan(swap, R, W, T, Z, cps, G, chunks, C * T * Z, 1, C * T * Z)


def _ordered_case(S, K, n, m, seed):
    """Seeded masked inputs with an empty candidate and an empty cloud, and
    invalid rows of every candidate against invalid columns of its cloud."""
    p, pmask, q, qmask = _case(S, K, n, m, seed)
    pmask[1 % (S * K)] = False
    qmask[-1] = False
    pmask[:, -3:] = False
    qmask[:, -3:] = False
    return p, pmask, q, qmask


@pytest.mark.parametrize("how", ["planned", "one SM", "tiles and splits", "swapped, tiles and splits"])
@pytest.mark.parametrize("S, K, n, m", [(2, 3, 70, 90), (1, 2, 300, 41), (3, 1, 41, 300)])
def test_kernel_order_equals_plain_and_jax(S, K, n, m, how):
    """The kernel's tile and merge order (:func:`hausdorff_sq_ordered`)
    against the plain version and the JAX package's ``hausdorff_sq_masked``
    on the broadcast inputs: bit for bit in float64 (and against plain in
    float32), under the planner's plans and under forced plans with several
    row tiles and column splits on either side; no invalid point makes a
    NaN (the emulation raises on one)."""
    p, pmask, q, qmask = _ordered_case(S, K, n, m, seed=n * m + S)
    C = S * K
    plan = {
        "planned": lambda e: hb.plan_launch(C, n, m, e),
        "one SM": lambda e: hb.plan_launch(C, n, m, e, 1),
        "tiles and splits": lambda e: _forced_plan(C, n, m, e, False, 1, 1, 3),
        "swapped, tiles and splits": lambda e: _forced_plan(C, n, m, e, True, 1, 1, 3),
    }[how]
    args = _torch_args(p, pmask, q, qmask)
    if how.endswith("splits"):
        assert plan(8).tiles > 1 and plan(8).splits > 1
    got = hb.hausdorff_sq_ordered(*args, K, plan(8))
    want = hb.hausdorff_sq_shared_ref_plain(*args, K)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), _jax_table(p, pmask, q, qmask, K))
    assert got[1 % C] == 0.0 and (got[-K:] == 0.0).all()
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    assert torch.equal(hb.hausdorff_sq_ordered(*f32, K, plan(4)),
                       hb.hausdorff_sq_shared_ref_plain(*f32, K))


def test_kernel_order_all_points_invalid_on_one_side():
    """Every row invalid against every column invalid, and one side empty
    with the other full: 0, with no NaN from inf - inf."""
    p, pmask, q, qmask = _case(2, 2, 40, 50, seed=3)
    for pm, qm in ((np.zeros_like(pmask), np.zeros_like(qmask)),
                   (np.zeros_like(pmask), np.ones_like(qmask)),
                   (np.ones_like(pmask), np.zeros_like(qmask))):
        args = _torch_args(p, pm, q, qm)
        for plan in (None, _forced_plan(4, 40, 50, 8, False, 1, 1, 2)):
            assert torch.equal(hb.hausdorff_sq_ordered(*args, 2, plan), torch.zeros(4, dtype=torch.float64))
