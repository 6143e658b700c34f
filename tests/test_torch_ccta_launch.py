"""The launch path of the CCTA toolkit's radius-count and nearest-pick
kernels, on the CPU: the launch planners (``radius_count.plan`` /
``items_of``, ``nearest.plan_lanes``), the plain emulation of the nearest
kernel's lane split (``nearest.nearest_lanes``), the batched entries'
plain versions against per-pair plain calls, and the batched glue
(``min_sqdist_pairs``, ``count_within_radius_pairs``) against the JAX
package.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
everything here is the work decomposition they follow, held bit for bit in
float64 against the single scan.
"""

import numpy as np
import pytest
import torch

import multimodars_torch as mt
from multimodars_torch.ccta import kernels as tk
from multimodars_torch.ops import nearest as nst
from multimodars_torch.ops import radius_count as rct
from multimodars_torch.utils import device as dev
from multimodars_tpu.ccta import kernels as jk
from native_route import one_native_route  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def _on_cpu(one_native_route):  # noqa: F811
    with mt.config.use(device="cpu"):
        yield


def _t(x, dtype=torch.float64):
    return torch.tensor(np.ascontiguousarray(x), dtype=dtype)


def _lattice(n, seed, step=0.5, span=6):
    """Lattice points: exact distance ties, duplicates (last three rows
    repeat the first three)."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(-span, span, (n, 3)) * step + np.array([30.0, -2.0, 8.0])
    if n > 6:
        pts[-3:] = pts[:3]
    return pts.astype(np.float64)


# phase 8's recorded shapes of one launch, and shapes at the planner's edges
PLAN_CASES = [
    [(18864, 21587), (18864, 18864)],
    [(18864, 21587)],
    [(4514, 4032), (4514, 4514)],
    [(8609, 4032), (8609, 8609)],
    [(57606, 60)],
    [(18864, 1047)],
    [(1, 1)],
    [(0, 50), (50, 0), (3, 7)],
    [(2_000_000, 64)],
    [(1024, 1_000_000)],
]


@pytest.mark.parametrize("sizes", PLAN_CASES, ids=lambda s: "-".join(f"{n}x{m}" for n, m in s))
@pytest.mark.parametrize("sms, bps", [(132, 7), (132, 4), (4, 2)])
def test_radius_count_plan_covers_every_pair_once(sizes, sms, bps):
    """Every (row, b point) of every pair falls in exactly one item; splits
    are whole planning chunks; the items fit on the card at once unless
    the row tiles alone exceed it; the grid stays within its limits."""
    plans = rct.plan(sizes, sms, bps)
    assert len(plans) == len(sizes)
    items = rct.items_of(sizes, plans)
    assert len(items) <= 2**31 - 1
    for (n, m), (splits, per) in zip(sizes, plans):
        assert per % rct.CHUNK == 0 and splits >= 1
        if n and m:
            assert splits == -(-m // per)
    for p, (n, m) in enumerate(sizes):
        mine = [it for it in items if it[0] == p]
        if not (n and m):
            assert not mine
            continue
        rows = {}
        for _, r0, r1, j0, j1 in mine:
            assert 0 <= r0 < r1 <= n and r1 - r0 <= rct.ROWS_PER_BLOCK
            assert 0 <= j0 < j1 <= m
            rows.setdefault((r0, r1), []).append((j0, j1))
        covered = 0
        for (r0, r1), spans in rows.items():
            spans.sort()
            assert spans[0][0] == 0 and spans[-1][1] == m
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            covered += r1 - r0
        assert covered == n
    tiles = sum(-(-n // rct.ROWS_PER_BLOCK) for n, m in sizes if n and m)
    assert len(items) <= sms * bps or tiles > sms * bps or len(items) == tiles


def test_radius_count_plan_fills_whole_waves():
    """At the island shapes the busiest SM carries at most 10% above the
    mean."""
    for sizes in PLAN_CASES[:2]:
        items = rct.items_of(sizes, rct.plan(sizes))
        loads = [0] * rct.SMS
        for k, (_, r0, r1, j0, j1) in enumerate(items):
            loads[k % rct.SMS] += rct.ROWS_PER_BLOCK * (j1 - j0)
        assert max(loads) <= 1.1 * sum(loads) / rct.SMS


@pytest.mark.parametrize("n, m, want", [
    (4036, 576, 8), (26449, 50, 1), (17155, 60, 1), (3739, 60, 8), (1009, 60, 32),
    (60, 12, 16), (5, 1, 1), (3, 2, 2), (16896, 500, 1), (16895, 500, 2),
    (1_000_000, 500, 1), (70000, 1, 1),
])
def test_nearest_plan_lanes(n, m, want):
    """The fewest lanes (a power of two, at most 32, below 2 M) that give
    a launch 128 threads an SM on 132 SMs; 1 when N already fills the
    card."""
    lanes = nst.plan_lanes(n, m)
    assert lanes == want
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32 and lanes < 2 * m
    blocks = -(-n * lanes // nst.THREADS)
    rows = nst.THREADS // lanes
    assert (blocks - 1) * rows < n <= blocks * rows  # every row once, no empty block


NEAREST_CASES = {
    "ties": (_lattice(300, 1), _lattice(200, 2)),
    "duplicates": (_lattice(50, 3), np.repeat(_lattice(20, 4), 3, axis=0)),
    "M = 1": (_lattice(40, 5), _lattice(1, 6)),
    "N < L": (_lattice(3, 7), _lattice(90, 8)),
    "M < L": (_lattice(64, 9), _lattice(5, 10)),
}


@pytest.mark.parametrize("lanes", [1, 2, 3, 8, 32])
@pytest.mark.parametrize("case", list(NEAREST_CASES))
def test_nearest_lane_split_equals_plain(case, lanes):
    """The kernel's split of b over lanes and its shuffle merge give the
    single scan's (m1, idx, m2) bit for bit: first index on ties, the
    runner-up equal to m1 on a later tie, +inf with one point."""
    a, b = (_t(x) for x in NEAREST_CASES[case])
    want = nst.nearest_plain(a, b)
    got = nst.nearest_lanes(a, b, lanes)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_nearest_lane_merge_is_order_free():
    """Merging lanes in any order gives the same bits (a minimum over a set)."""
    a, b = (_t(x) for x in NEAREST_CASES["ties"])
    states = [nst.nearest_lanes(a, b[k::4], 1) for k in range(4)]
    states = [(m1, idx * 4 + k, m2) for k, (m1, idx, m2) in enumerate(states)]
    orders = ([0, 1, 2, 3], [3, 2, 1, 0], [2, 0, 3, 1])
    outs = []
    for order in orders:
        out = states[order[0]]
        for k in order[1:]:
            out = nst.merge_lanes(out, states[k])
        outs.append(out)
    for out in outs[1:]:
        for g, w in zip(out, outs[0]):
            assert torch.equal(g, w)
    for g, w in zip(outs[0], nst.nearest_plain(a, b)):
        assert torch.equal(g, w)


def _buffers(dtype):
    a = np.concatenate([_lattice(400, 11), _lattice(130, 12)])
    b = np.concatenate([_lattice(77, 13), _lattice(260, 14)])
    return _t(a, dtype), _t(b, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("flags", [False, True])
def test_radius_count_batch_plain_equals_per_pair(dtype, flags):
    """Each pair's words of the batch (empty pairs included) equal
    ``radius_count`` on its own rows with its own band."""
    a, b = _buffers(dtype)
    pairs = [(0, 400, 0, 77, 1.0, 1.1), (400, 130, 77, 260, 2.25, 2.3),
             (10, 0, 0, 77, 1.0, 2.0), (3, 9, 300, 0, 1.0, 2.0), (0, 530, 0, 337, 0.25, 0.26)]
    out = rct.radius_count_batch(a, b, pairs, flags=flags)
    assert out.dtype == torch.int32
    assert out.shape == (sum(p[1] for p in pairs) * (1 if flags else 2),)
    for view, (a_off, n, b_off, m, lo, hi) in zip(rct.batch_views(out, pairs, flags), pairs):
        want = rct.radius_count(a[a_off:a_off + n], b[b_off:b_off + m], lo, hi, flags=flags)
        if flags:
            assert torch.equal(view, want.to(torch.int32))
        else:
            assert torch.equal(view[0], want[0]) and torch.equal(view[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nearest_batch_plain_equals_per_pair(dtype):
    """Each pair's rows of the batch's byte buffer equal ``nearest`` on its
    own rows; an empty pair takes no rows."""
    a, b = _buffers(dtype)
    pairs = [(0, 400, 0, 77), (400, 0, 0, 5), (400, 130, 77, 260), (5, 3, 336, 1)]
    buf = nst.nearest_batch(a, b, pairs)
    m1, idx, m2 = nst.views(buf, dtype)
    assert buf.dtype == torch.uint8 and m1.dtype == m2.dtype == dtype
    assert idx.dtype == torch.int64 and m1.shape == (533,)
    o = 0
    for a_off, n, b_off, m in pairs:
        want = nst.nearest(a[a_off:a_off + n], b[b_off:b_off + m])
        for g, w in zip((m1, idx, m2), want):
            assert torch.equal(g[o:o + n], w)
        o += n


def test_batched_entries_refuse_bad_pairs():
    a, b = _buffers(torch.float64)
    with pytest.raises(ValueError, match="outside"):
        rct.radius_count_batch(a, b, [(500, 40, 0, 1, 1.0, 2.0)])
    with pytest.raises(ValueError, match="outside"):
        nst.nearest_batch(a, b, [(0, 1, 300, 40)])
    with pytest.raises(ValueError, match="at least one point"):
        nst.nearest_batch(a, b, [(0, 3, 5, 0)])
    with pytest.raises(ValueError, match="dtype"):
        nst.nearest_batch(a, b.float(), [(0, 3, 5, 1)])
    meta = torch.zeros((2, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no radius_count kernel"):
        rct.radius_count_batch(meta, meta, [])
    with pytest.raises(ValueError, match="no nearest kernel"):
        nst.nearest_batch(meta, meta, [])


def test_packed_upload_and_pull_on_the_cpu():
    """``to_device_packed`` stacks and casts the sets with their offsets,
    each set on a 16-byte boundary after zero rows; ``to_host`` hands a CPU
    tensor's own memory back."""
    sets = [np.arange(6.0).reshape(2, 3), np.zeros((0, 3)), np.ones((3, 3)) / 3.0,
            np.full((4, 3), 2.0)]
    for dtype, size in (("float32", 4), ("float64", 8)):
        with mt.config.use(dtype=dtype):
            pts, offs = dev.to_device_packed(sets, mt.config.compute_dtype)
        assert offs == [0, 4, 4, 8] and pts.shape == (12, 3)
        assert pts.dtype == getattr(torch, dtype) and pts.element_size() == size
        assert all(3 * size * o % 16 == 0 for o in offs)
        assert torch.equal(pts[:2], torch.arange(6.0, dtype=pts.dtype).reshape(2, 3))
        assert torch.equal(pts[4:7], torch.from_numpy(sets[2]).to(pts.dtype))
        assert torch.equal(pts[8:], torch.full((4, 3), 2.0, dtype=pts.dtype))
        assert not pts[2:4].any() and not pts[7].any()
    assert np.array_equal(dev.to_host(pts), pts.numpy())


PAIR_CASES = {
    "lattice pairs": [(_lattice(500, 21), _lattice(300, 22)), (_lattice(300, 22), _lattice(500, 21))],
    "with empty and one-point sets": [(_lattice(200, 23), np.zeros((0, 3))),
                                      (_lattice(1, 24), _lattice(1, 25)),
                                      (np.zeros((0, 3)), _lattice(9, 26)),
                                      (_lattice(120, 27), _lattice(400, 28))],
    "a shared": [(_lattice(400, 29), _lattice(350, 30)), (_lattice(400, 29), _lattice(400, 29))],
}


@pytest.mark.parametrize("case", list(PAIR_CASES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_min_sqdist_pairs_matches_jax(case, dtype):
    """The batched picks equal the JAX package's per-pair ``min_sqdist``:
    argmins exactly (first wins on ties), distances to 1e-12."""
    pairs = PAIR_CASES[case]
    with mt.config.use(dtype=dtype):
        got = tk.min_sqdist_pairs(pairs)
    for (gd, gi), (a, b) in zip(got, pairs):
        wd, wi = jk.min_sqdist(a, b)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("case", list(PAIR_CASES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_count_within_radius_pairs_matches_jax(case, dtype):
    """The batched counts equal the JAX package's per-pair exact counts at
    radii the lattice hits exactly and one it does not."""
    pairs = PAIR_CASES[case]
    for radius in (1.0, 1.5, 2.0 + 1e-9):
        with mt.config.use(dtype=dtype):
            got = tk.count_within_radius_pairs(pairs, radius)
        for g, (a, b) in zip(got, pairs):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, jk.count_within_radius(a, b, radius))


def test_batched_glue_notes_each_pair():
    """One batched call notes each pair's rows as separate calls would."""
    pairs = PAIR_CASES["lattice pairs"]
    with mt.config.use(dtype="float32"):
        tk.reset_stats()
        tk.min_sqdist_pairs(pairs)
        tk.count_within_radius_pairs(pairs, 1.5)
        batched = {k: dict(v) for k, v in tk.stats.items()}
        tk.reset_stats()
        for a, b in pairs:
            tk.min_sqdist(a, b)
            tk.count_within_radius(a, b, 1.5)
        single = {k: dict(v) for k, v in tk.stats.items()}
    assert batched == single
    assert batched["nearest"]["rows"] == 800 and batched["radius_count"]["flagged"] > 0
