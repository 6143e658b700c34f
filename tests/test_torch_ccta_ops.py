"""The CCTA toolkit's three pairwise primitives in the PyTorch port
(``ops.radius_count``, ``ops.nearest``, ``ops.morph_sweep``) and their
certified wrappers in ``ccta.kernels``, against the JAX package on seeded
clouds.

Both run on the CPU, the JAX package in float64 (tests/conftest.py).  The
certified wrappers must give the JAX package's exact answers: counts and
argmin indices equal, distances to 1e-12, sweep winners equal, in float64
and, through certification, in float32 too.  The plain versions hold
against the JAX package's device programs (float64, distances to rel
1e-12), and against emulations of each kernel's tiling.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import multimodars_torch as mt
from multimodars_torch.ccta import kernels as tk
from multimodars_torch.ops import morph_sweep as msw
from multimodars_torch.ops import nearest as nst
from multimodars_torch.ops import radius_count as rct
from multimodars_tpu.ccta import kernels as jk
from native_route import one_native_route  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def _on_cpu(one_native_route):  # noqa: F811
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU, with one native route for both packages."""
    with mt.config.use(device="cpu"):
        yield


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _lattice(n, seed, step=0.5, span=12):
    """Points on a lattice: exact distance ties and points exactly at
    lattice radii; the last three rows repeat the first three."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(-span, span, (n, 3)) * step + np.array([36.0, -4.0, 12.0])
    if n > 6:
        pts[-3:] = pts[:3]
    return pts.astype(np.float64)


def _gauss(n, seed, scale=4.0):
    return np.random.default_rng(seed).standard_normal((n, 3)) * scale + 20.0


CLOUDS = {
    "empty a": (np.zeros((0, 3)), _gauss(40, 1)),
    "empty b": (_gauss(40, 2), np.zeros((0, 3))),
    "one each": (_gauss(1, 3), _gauss(1, 4)),
    "M < 128": (_gauss(500, 5), _gauss(60, 6)),
    "M > 128": (_gauss(700, 7), _gauss(1500, 8)),
    "lattice": (_lattice(900, 9), _lattice(1300, 10)),
    "lattice, duplicates, M < 128": (_lattice(600, 11), _lattice(90, 12)),
    "a = b": (_lattice(800, 13), None),
}


def _pair(name):
    a, b = CLOUDS[name]
    return a, (a if b is None else b)


@pytest.mark.parametrize("name", list(CLOUDS))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_count_within_radius_matches_jax(name, dtype):
    """Counts equal the JAX package's exact counts, at radii that lattice
    points hit exactly (1.0, 1.5) and one they do not (2.0 + 1e-9)."""
    a, b = _pair(name)
    for radius in (1.0, 1.5, 2.0 + 1e-9):
        want = jk.count_within_radius(a, b, radius)
        with mt.config.use(dtype=dtype):
            got = tk.count_within_radius(a, b, radius)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(CLOUDS))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_min_sqdist_matches_jax(name, dtype):
    """The first-wins argmin equals the JAX package's on ties too, and the
    winning distance is its exact float64 value."""
    a, b = _pair(name)
    want_d, want_i = jk.min_sqdist(a, b)
    with mt.config.use(dtype=dtype):
        got_d, got_i = tk.min_sqdist(a, b)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-12, atol=0.0)


def test_certification_counts_flagged_rows():
    """On a lattice, float32 flags rows at the radius (pairs exactly at
    r = 1.5) and argmins tied within the band; every flag is re-decided."""
    a, b = _pair("lattice")
    tk.reset_stats()
    with mt.config.use(dtype="float32"):
        tk.count_within_radius(a, b, 1.5)
        tk.min_sqdist(a, b)
    for name in ("radius_count", "nearest"):
        s = tk.stats[name]
        assert s["rows"] == len(a) and 0 < s["flagged"] == s["redecided"] <= len(a)
    tk.reset_stats()
    assert tk.stats["radius_count"]["rows"] == 0


def _sweep_case(n, m, seed):
    rng = np.random.default_rng(seed)
    cl = np.linspace([0.0, 0.0, 0.0], [0.0, 0.0, 20.0], 40) + 30.0
    t = rng.uniform(0.0, 20.0, n)
    ang = rng.uniform(0.0, 2 * np.pi, n)
    pts = np.stack([30.0 + 1.3 * np.cos(ang), 30.0 + 1.3 * np.sin(ang), 30.0 + t], 1)
    t2 = rng.uniform(2.0, 18.0, m)
    ang2 = rng.uniform(0.0, 2 * np.pi, m)
    ref = np.stack([30.0 + 1.9 * np.cos(ang2), 30.0 + 1.9 * np.sin(ang2), 30.0 + t2], 1)
    return pts, ref, cl


@pytest.mark.parametrize("n, m", [(0, 50), (50, 0), (1, 1), (90, 384), (700, 576)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_grid_sweep_scaling_matches_jax(n, m, dtype):
    """The winning offset of the morph sweep equals the JAX package's
    (host scan below its device threshold, certified table above)."""
    pts, ref, cl = _sweep_case(n, m, n + m)
    want = jk._grid_sweep_scaling(pts, ref, cl)
    with mt.config.use(dtype=dtype):
        got = tk._grid_sweep_scaling(pts, ref, cl)
    assert got == want


def _t(x, dtype=torch.float64):
    return torch.tensor(np.ascontiguousarray(x), dtype=dtype)


@pytest.mark.parametrize("name", ["M < 128", "M > 128", "lattice"])
def test_radius_count_plain_matches_jax_window_program(name):
    """``radius_count_plain`` against the JAX package's banded count
    program (``_count_band_window_block``) on the same centred float64
    sets: equal certain counts and near flags."""
    import jax.numpy as jnp

    a, b = _pair(name)
    mid = 0.5 * (np.minimum(a.min(0), b.min(0)) + np.maximum(a.max(0), b.max(0)))
    ac, bc = a - mid, b - mid
    r2lo, r2hi = 1.5 ** 2 - 1e-3, 1.5 ** 2 + 1e-3
    packed = np.asarray(jk._count_band_window_block(
        jnp.asarray(ac), jnp.asarray(bc), jnp.asarray(0), jnp.asarray(r2lo),
        jnp.asarray(r2hi), ch=len(bc), w=len(bc),
    ))
    certain, near = rct.radius_count(_t(ac), _t(bc), r2lo, r2hi)
    np.testing.assert_array_equal(certain.numpy(), packed.astype(np.int64) & 0x7FFFFFFF)
    np.testing.assert_array_equal(near.numpy() > 0, packed < 0)
    flags = rct.radius_count(_t(ac), _t(bc), r2lo, r2hi, flags=True).numpy()
    np.testing.assert_array_equal(flags & 1, certain.numpy() > 0)
    np.testing.assert_array_equal((flags & 2) > 0, near.numpy() > 0)


@pytest.mark.parametrize("name", ["M < 128", "M > 128", "one each"])
def test_nearest_plain_matches_jax_block_program(name):
    """``nearest_plain`` against ``_min_sqdist_block2`` (float64): equal
    argmins, minima and runner-ups to rel 1e-12."""
    import jax.numpy as jnp

    a, b = _pair(name)
    (m12, am) = jk._min_sqdist_block2(jnp.asarray(a), jnp.asarray(b))
    m1, idx, m2 = nst.nearest(_t(a), _t(b))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(am))
    np.testing.assert_allclose(m1.numpy(), np.asarray(m12)[0], rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(m2.numpy(), np.asarray(m12)[1], rtol=1e-12, atol=0.0)


def test_nearest_ties_and_duplicates():
    """First-wins on exact ties; the runner-up equals the minimum when a
    later point ties it, +inf with one point."""
    a = _t([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]])
    b = _t([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [9.0, 9.0, 9.0], [1.0, 0.0, 0.0]])
    m1, idx, m2 = nst.nearest(a, b)
    assert idx.tolist() == [0, 2] and m1[0] == m2[0] == 1.0
    m1, idx, m2 = nst.nearest(a, b[2:3])
    assert idx.tolist() == [0, 0] and torch.isinf(m2).all()
    with pytest.raises(ValueError, match="at least one point"):
        nst.nearest(a, b[:0])


@pytest.mark.parametrize("cols", [1, 7, 128, 1024])
def test_nearest_tiling_equals_plain(cols):
    """The kernel's tile-by-tile scan, emulated with ``cols`` columns per
    tile, equals plain bit for bit (minima are exact, ties first-wins)."""
    a, b = _pair("lattice")
    want = nst.nearest_plain(_t(a), _t(b))
    got = nst.nearest_tiled(_t(a), _t(b), cols)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_radius_count_splits_equal_plain():
    """The kernel's work items (``plan`` / ``items_of``: row tiles x splits
    of ``b``) sum to the unsplit counts; a split never falls under one
    planning chunk."""
    a, b = _pair("M > 128")
    r2lo, r2hi = 1.0, 1.2
    whole = rct.radius_count_plain(_t(a), _t(b), r2lo, r2hi)
    for n, m in ((len(a), len(b)), (17000, 40000), (57606, 60)):
        (s, per), = rct.plan([(n, m)], sms=4, blocks_per_sm=2)
        assert per % rct.CHUNK == 0 and 1 <= s == -(-m // per)
    sizes = [(len(a), len(b))]
    certain = torch.zeros(len(a), dtype=torch.int32)
    near = torch.zeros(len(a), dtype=torch.int32)
    for _, r0, r1, j0, j1 in rct.items_of(sizes, rct.plan(sizes, sms=4, blocks_per_sm=2)):
        c, nr = rct.radius_count_plain(_t(a[r0:r1]), _t(b[j0:j1]), r2lo, r2hi)
        certain[r0:r1] += c
        near[r0:r1] += nr
    assert torch.equal(certain, whole[0])
    assert torch.equal(near, whole[1])


def test_radius_count_band_edges():
    """A pair exactly at r2lo is certain, exactly at r2hi near, above it
    nothing."""
    a = _t([[0.0, 0.0, 0.0]])
    b = _t([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, 3.0]])
    certain, near = rct.radius_count(a, b, 1.0, 4.0)
    assert certain.tolist() == [1] and near.tolist() == [1]
    assert rct.radius_count(a, b, 1.0, 4.0, flags=True).tolist() == [3]
    assert rct.radius_count(a, b[2:], 1.0, 4.0, flags=True).tolist() == [0]


@pytest.mark.parametrize("n, m", [(1, 1), (90, 384), (700, 2000)])
def test_morph_sweep_plain_matches_jax_table(n, m):
    """Costs from ``morph_sweep_plain`` equal the JAX package's
    ``_sweep_cost_table`` (float64) to rel 1e-12, and the kernel-ordered
    sums equal plain to rel 1e-12."""
    import jax.numpy as jnp

    pts, ref, cl = _sweep_case(n, m, 3 * n + m)
    _, nearest = jk.min_sqdist(pts, cl)
    rel = pts - cl[nearest]
    unit = rel / np.linalg.norm(rel, axis=1)[:, None]
    xs = -2.0 + 0.1 * np.arange(41)
    want = np.asarray(jk._sweep_cost_table(
        jnp.asarray(pts), jnp.asarray(unit), jnp.ones(n, bool), jnp.asarray(ref),
        jnp.ones(m, bool), jnp.asarray(xs),
    ))
    fwd, bwd = msw.morph_sweep(_t(pts), _t(unit), _t(ref), _t(xs))
    got = np.sqrt((fwd.numpy() / n + bwd.numpy() / m) / 2.0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    ofwd, obwd = msw.morph_sweep_ordered(_t(pts), _t(unit), _t(ref), _t(xs))
    np.testing.assert_allclose(ofwd.numpy(), fwd.numpy(), rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(obwd.numpy(), bwd.numpy(), rtol=1e-12, atol=0.0)


def test_morph_sweep_refuses_empty_sets():
    p = _t(np.zeros((3, 3)))
    with pytest.raises(ValueError, match="at least one"):
        msw.morph_sweep(p, p, p[:0], _t(np.zeros(2)))


def test_wrappers_raise_for_other_devices():
    p = torch.zeros((2, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no radius_count kernel"):
        rct.radius_count(p, p, 1.0, 2.0)
    with pytest.raises(ValueError, match="no nearest kernel"):
        nst.nearest(p, p)
    with pytest.raises(ValueError, match="no morph_sweep kernel"):
        msw.morph_sweep(p, p, p, p[:, 0])
