"""The ray-triangle hits of the PyTorch port (``ops.ray_triangle``) on the
CPU, where the wrapper takes its plain PyTorch version: the launch
planner, the PyTorch emulation of the kernel's work decomposition and its
exact filter (``ray_hits_ordered``, ``u_filter_keeps``) against plain and
both host twins on seeded, adversarial and occlusion rays, the cases of
tests/test_ccta.py's TestRayTriangleIntersection, the t-table against both
packages' host twins bit for bit and against the JAX package's XLA program
(equal hit masks, rtol 1e-12: it sums with ``jnp.cross`` and ``.sum(-1)``),
``(n_hits, closest)`` against the native grid DDA, and the occlusion mask
of ``occlusion_remove_mask`` on the ray kernel's route against the native
route and the JAX package's device route.  The kernel itself runs in
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import ccta_case
import chip_smoke
import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch.ccta import kernels as tk
from multimodars_torch.io import native as t_native
from multimodars_torch.ops import ray_triangle as rt
from multimodars_tpu.ccta import kernels as jk
from native_route import pin_route


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.config.use(device="cpu"):
        yield


def _tri():
    v0 = np.array([[1.0, -1.0, -1.0]])
    v1 = np.array([[1.0, 1.0, -1.0]])
    v2 = np.array([[1.0, 0.0, 1.0]])
    return np.stack([v0, v1, v2], 1)  # [1, 3, 3]


def _hits(o, d, tris):
    out = rt.ray_hits(*(torch.as_tensor(np.ascontiguousarray(x)) for x in (o, d, tris)))
    return tuple(v.numpy() for v in rt.views(out))


def test_single_ray_hits_at_t1():
    o, d = np.array([[0.0, 0.0, 0.0]]), np.array([[1.0, 0.0, 0.0]])
    n_hits, closest, t_min = _hits(o, d, _tri())
    assert n_hits.tolist() == [1] and closest.tolist() == [0]
    assert t_min[0] == 1.0


def test_parallel_backward_and_side_rays_miss():
    o = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 5.0, 0.0]])
    d = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    t = rt.ray_t_plain(torch.tensor(o), torch.tensor(d), torch.tensor(_tri())).numpy()
    assert np.isinf(t).all()  # parallel to the plane, behind the origin, off the side
    n_hits, closest, t_min = _hits(o, d, _tri())
    assert n_hits.tolist() == [0, 0, 0] and closest.tolist() == [0, 0, 0]
    assert np.isinf(t_min).all()


def _random_batch(seed, R=24, F=16):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 2, (R, 3))
    d = rng.normal(0, 1, (R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v0 = rng.normal(0, 2, (F, 3))
    v1 = v0 + rng.normal(0, 1, (F, 3))
    v2 = v0 + rng.normal(0, 1, (F, 3))
    return o, d, v0, v1, v2


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_t_table_equals_host_twins_and_jax(seed):
    o, d, v0, v1, v2 = _random_batch(seed, R=64, F=48)
    tris = np.stack([v0, v1, v2], 1)
    got = rt.ray_t_plain(torch.tensor(o), torch.tensor(d), torch.tensor(tris)).numpy()
    assert np.isfinite(got).sum() >= 10
    np.testing.assert_array_equal(got, tk._ray_triangle_hits_np(o, d, v0, v1, v2))
    np.testing.assert_array_equal(got, jk._ray_triangle_hits_np(o, d, v0, v1, v2))
    xla = np.asarray(jk._ray_triangle_hits(*(jnp.asarray(x) for x in (o, d, v0, v1, v2))))
    hit = np.isfinite(got)
    np.testing.assert_array_equal(hit, np.isfinite(xla))
    np.testing.assert_allclose(got[hit], xla[hit], rtol=1e-12, atol=0.0)
    n_hits, closest, t_min = _hits(o, d, tris)
    np.testing.assert_array_equal(n_hits, hit.sum(1))
    np.testing.assert_array_equal(closest, np.argmin(got, axis=1))
    np.testing.assert_array_equal(t_min, got.min(1))


def test_plain_chunks_and_empty_inputs(monkeypatch):
    o, d, v0, v1, v2 = _random_batch(5, R=40, F=30)
    tris = np.stack([v0, v1, v2], 1)
    whole = _hits(o, d, tris)
    monkeypatch.setattr(rt, "_PLAIN_TILE", 60)  # two rays a chunk
    for a, b in zip(_hits(o, d, tris), whole):
        np.testing.assert_array_equal(a, b)
    n_hits, closest, t_min = _hits(o, d, np.zeros((0, 3, 3)))
    assert (n_hits == 0).all() and (closest == 0).all() and np.isinf(t_min).all()
    assert _hits(np.zeros((0, 3)), np.zeros((0, 3)), tris)[0].shape == (0,)
    with pytest.raises(ValueError, match="float64"):
        rt.ray_hits(torch.zeros(2, 3, dtype=torch.float32), torch.zeros(2, 3),
                    torch.zeros(1, 3, 3))


@pytest.mark.parametrize("R, F, sms", [(1000, 37905, 132), (3, 100, 132), (5000, 40, 132),
                                       (1, 0, 132), (100_000, 1_000_000, 132)])
def test_plan_covers_the_faces(R, F, sms):
    p = rt.plan(R, F, sms)
    assert 1 <= p.per_split <= rt.MAX_SPLIT and p.splits >= 1
    assert p.splits * p.per_split >= F and (p.splits - 1) * p.per_split < max(F, 1)
    assert p.groups * rt.RAYS_PER_BLOCK >= R > (p.groups - 1) * rt.RAYS_PER_BLOCK or R == 0


@pytest.mark.parametrize("sms, blocks_per_sm", [(1, 1), (4, 2), (132, 4), (132, 5)])
@pytest.mark.parametrize("R, F", [(1, 1), (1, 37), (255, 511), (256, 512), (257, 513),
                                  (1000, 37905), (100_000, 1_000_000), (3, 0)])
def test_plan_fills_whole_waves(R, F, sms, blocks_per_sm):
    """The fewest waves of ``sms * blocks_per_sm`` blocks in which a split
    holds at most MAX_SPLIT faces, the shortest split those waves allow, and
    a last wave that is not empty."""
    p = rt.plan(R, F, sms, blocks_per_sm)
    slots = sms * blocks_per_sm
    blocks = p.groups * p.splits
    assert (p.waves - 1) * slots < blocks <= p.waves * slots
    assert p.waves == -(-p.groups * -(-max(F, 1) // rt.MAX_SPLIT) // slots)
    assert p.per_split == max(1, -(-F // min(max(F, 1), p.waves * slots // p.groups)))


@pytest.mark.parametrize("sms, blocks_per_sm", [(1, 1), (4, 2), (132, 4)])
@pytest.mark.parametrize("R, F", [(1, 1), (1, 37), (257, 513), (600, 1100), (5, 0)])
def test_plan_blocks_cover_every_pair_once(R, F, sms, blocks_per_sm):
    p = rt.plan(R, F, sms, blocks_per_sm)
    seen = np.zeros((R, max(F, 1)), dtype=np.int64)
    order = []
    for rays, f0, f1 in rt.blocks_of(R, F, p):
        live = rays[rays < R].numpy()
        assert len(np.unique(live)) == len(live)
        seen[live, f0:f1] += 1
        order.append((f0, int(rays.min())))
    assert len(order) == p.groups * p.splits
    assert order == sorted(order)  # split major, ray group fastest
    assert (seen[:, :F] == 1).all()


def _twin_out(o, d, tris):
    """(n_hits, closest, t_min) of both packages' host twins, which must
    agree bit for bit."""
    with np.errstate(all="ignore"):
        t = tk._ray_triangle_hits_np(o, d, tris[:, 0], tris[:, 1], tris[:, 2])
        tj = jk._ray_triangle_hits_np(o, d, tris[:, 0], tris[:, 1], tris[:, 2])
    np.testing.assert_array_equal(t, tj)
    if t.shape[1] == 0:
        return np.zeros(len(o), np.int64), np.zeros(len(o), np.int64), np.full(len(o), np.inf)
    return np.isfinite(t).sum(1), np.argmin(t, axis=1), t.min(1)


def _check_ordered(o, d, tris, plans):
    """ray_hits_ordered at each plan equals plain and both host twins bit
    for bit; returns the pairs that took the exact path."""
    args = [torch.as_tensor(np.ascontiguousarray(x)) for x in (o, d, tris)]
    want = rt.ray_hits_plain(*args)
    twin = _twin_out(o, d, tris)
    for got, w in zip((v.numpy() for v in rt.views(want)), twin):
        np.testing.assert_array_equal(got, w)
    exact = set()
    for p in plans:
        got, n = rt.ray_hits_ordered(*args, p)
        assert torch.equal(got, want), p
        exact.add(n)
    assert len(exact) == 1  # the filter does not depend on the plan
    return exact.pop()


@pytest.mark.parametrize("seed, R, F", [(1, 24, 16), (2, 300, 90), (3, 257, 513), (4, 1, 7)])
def test_kernel_order_equals_plain_and_twins(seed, R, F):
    o, d, v0, v1, v2 = _random_batch(seed, R=R, F=F)
    tris = np.stack([v0, v1, v2], 1)
    exact = _check_ordered(o, d, tris, [rt.plan(R, F), rt.plan(R, F, 1, 1), rt.plan(R, F, 4, 2)])
    assert exact < R * F and (exact > 0 or R * F < 100)


def _adversarial():
    with np.errstate(all="ignore"):
        return chip_smoke.adversarial_ray_case(np)


def test_kernel_order_on_adversarial_rays():
    o, d, tris = _adversarial()
    R, F = len(o), len(tris)
    _check_ordered(o, d, tris, [rt.plan(R, F), rt.plan(R, F, 1, 1), rt.plan(R, F, 4, 3)])


def _pair_terms(o, d, tris):
    """Per (ray, face) pair: the twin's a, un, u and acceptance, the
    kernel's filter verdict on non-parallel pairs, and whether the pair is
    parallel."""
    args = [torch.as_tensor(np.ascontiguousarray(x)) for x in (o, d, tris)]
    t, kept = rt._block_t(*args)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    with np.errstate(all="ignore"):
        hx = d[:, 1:2] * e2[None, :, 2] - d[:, 2:3] * e2[None, :, 1]
        hy = d[:, 2:3] * e2[None, :, 0] - d[:, 0:1] * e2[None, :, 2]
        hz = d[:, 0:1] * e2[None, :, 1] - d[:, 1:2] * e2[None, :, 0]
        a = e1[None, :, 0] * hx + e1[None, :, 1] * hy + e1[None, :, 2] * hz
        un = ((o[:, 0:1] - v0[None, :, 0]) * hx + (o[:, 1:2] - v0[None, :, 1]) * hy
              + (o[:, 2:3] - v0[None, :, 2]) * hz)
        u = (1.0 / a) * un
    accepted = np.isfinite(_twin_t(o, d, tris))
    np.testing.assert_array_equal(t.numpy(), np.where(accepted, _twin_t(o, d, tris), np.inf))
    return a, un, u, accepted, kept.numpy(), np.abs(a) < rt.EPS


def _twin_t(o, d, tris):
    with np.errstate(all="ignore"):
        return tk._ray_triangle_hits_np(o, d, tris[:, 0], tris[:, 1], tris[:, 2])


def test_filter_keeps_every_hit_of_the_adversarial_rays():
    """Every pair the twin accepts takes the exact path, and the case holds
    the corners it was built for: hits at u = -0.0, u = 0 and u = 1, |a| at
    1e-8 and one ulp either side, |a| past 2^900 and infinite, un = +-0."""
    a, un, u, accepted, kept, parallel = _pair_terms(*_adversarial())
    assert accepted.sum() > 100
    assert (kept | ~accepted).all()
    hit_u = u[accepted]
    assert (np.signbit(hit_u) & (hit_u == 0.0)).any()  # -0.0
    assert ((hit_u == 0.0) & ~np.signbit(hit_u)).any() and (hit_u == 1.0).any()
    eps = rt.EPS
    for edge in (eps, np.nextafter(eps, 1.0)):
        assert (accepted & (np.abs(a) == edge)).any()
    assert (parallel & (np.abs(a) == np.nextafter(eps, 0.0))).any()
    assert (accepted & (np.abs(a) >= 2.0 ** 900)).any() and np.isinf(a).any()
    assert (accepted & (un == 0.0) & (np.abs(a) < 2.0 ** 900)).any()
    # the filter rejects: most non-parallel pairs that miss never divide
    assert (~kept & ~parallel).sum() > 0.5 * (~accepted & ~parallel).sum()


def test_filter_keeps_every_hit_of_the_occlusion_rays(occlusion_rays):
    o, d, tris = occlusion_rays
    _, _, _, accepted, kept, parallel = _pair_terms(o[::4], d[::4], tris)
    assert accepted.sum() > 50
    assert (kept | ~accepted).all()
    # few non-parallel pairs take the exact path: the division is rare
    assert kept.sum() < 0.1 * (~parallel).sum()


@pytest.fixture(scope="module")
def occlusion_rays():
    """The rays of the 6,406-vertex case's occlusion pass, recorded from
    ``occlusion_remove_mask`` on the RCA course."""
    mesh, cl_ao, cl_rca, _, _ = ccta_case.build_case(mt, 1)
    tris = mesh.vertices[mesh.faces]
    rays = []
    spied = tk.ray_occlusion
    try:
        tk.ray_occlusion = lambda *a: rays.append(a) or spied(*a)
        with mt.config.use(device="cpu"), contextlib.redirect_stdout(io.StringIO()):
            tk.occlusion_remove_mask(mt.numpy_to_centerline(cl_rca),
                                     mt.numpy_to_centerline(cl_ao), 40, mesh.vertices, tris, 1.0)
    finally:
        tk.ray_occlusion = spied
    (o, d, t), = rays
    return o, d, t


def test_kernel_order_on_occlusion_rays(occlusion_rays):
    o, d, tris = occlusion_rays
    R, F = len(o), len(tris)
    exact = _check_ordered(o, d, tris, [rt.plan(R, F), rt.plan(R, F, 4, 2)])
    assert 0 < exact < 0.05 * R * F


def _u_twin(a, un):
    with np.errstate(all="ignore"):
        return (1.0 / a) * un


def _keeps(a, un):
    return rt.u_filter_keeps(torch.tensor(a, dtype=torch.float64),
                             torch.tensor(un, dtype=torch.float64)).numpy()


_EDGE_A = [1e-8, np.nextafter(1e-8, 1.0), 1.0, 3.0, 0.1, 2.0 ** 899, np.nextafter(2.0 ** 900, 0.0),
           2.0 ** 900, 2.0 ** 1000, np.finfo(float).max]


@settings(max_examples=300, deadline=None)
@given(a=st.one_of(st.sampled_from(_EDGE_A),
                   st.floats(1e-8, 1e300, allow_nan=False, allow_infinity=False)),
       a_sign=st.sampled_from([1.0, -1.0]),
       ratio=st.one_of(st.sampled_from([0.0, -0.0, 1.0, -1.0, 0.5, 5e-324, -5e-324, 2.0, -2.0]),
                       st.floats(-3.0, 3.0, allow_nan=False)),
       ulps=st.integers(-4, 4),
       shift=st.sampled_from([0, -300, -1000, -1100, 100]))
def test_filter_never_rejects_a_u_the_twin_takes(a, a_sign, ratio, ulps, shift):
    """u_filter_keeps is True wherever the twin's u = (1 / a) * un lies in
    [0, 1] (as floats): un near a * ratio (ratio 0, 1, -0.0, tiny, ...),
    moved by a few ulps and scaled by 2^shift (un underflowing to +-0 or
    u to -0.0)."""
    a = a_sign * a
    with np.errstate(all="ignore"):
        un = np.float64(a) * np.float64(ratio) * np.float64(2.0) ** shift
    for _ in range(abs(ulps)):
        un = np.nextafter(un, np.inf if ulps > 0 else -np.inf)
    if not np.isfinite(un):
        return
    u = _u_twin(np.float64(a), un)
    keeps = bool(_keeps([a], [un])[0])
    assert keeps == (not rt._fma_drops(float(a), float(un)))
    if 0.0 <= u <= 1.0:
        assert keeps, (a, un, u)
    if not keeps:
        assert not (0.0 <= u <= 1.0)


@pytest.mark.parametrize("shape", [(4000,), (50, 80)])
def test_filter_equals_its_rational_definition(shape):
    """u_filter_keeps (Dekker's product, exact expansions) against the
    kernel's predicate evaluated in rationals, |RN(un a - h)| > h, on
    ratios un / a near 0 and 1 moved by a few ulps, at every scale of a,
    and on products that overflow or underflow."""
    rng = np.random.default_rng(int(np.prod(shape)))
    n = int(np.prod(shape))
    a = 10.0 ** rng.uniform(-8, 200, n) * rng.choice([-1.0, 1.0], n)
    ratio = rng.choice([0.0, -0.0, 1.0, -1.0, 0.5, 5e-324, 2.0 ** -60, 1e300], n)
    ratio = np.where(rng.uniform(size=n) < 0.3, rng.uniform(-2, 2, n), ratio)
    with np.errstate(all="ignore"):
        un = a * ratio
        for _ in range(3):
            step = rng.integers(-1, 2, n)
            un = np.where(step > 0, np.nextafter(un, np.inf), np.where(step < 0, np.nextafter(un, -np.inf), un))
    got = _keeps(a.reshape(shape), un.reshape(shape)).reshape(-1)
    want = np.array([not rt._fma_drops(float(x), float(y)) for x, y in zip(a, un)])
    np.testing.assert_array_equal(got, want)
    assert (~got).sum() > 0.2 * n


def test_filter_rejects_what_it_can_prove():
    """u > 1 by more than a few ulps and clear negative u are dropped; u
    rounding to -0.0 and |a| past 2^900 are kept."""
    a = np.array([2.0, 2.0, -2.0, 2.0, 2.0 ** 800, 2.0 ** 901, 1.0, 1.0, 1.0])
    un = np.array([2.0 * 1.001, -1e-3, 1e-3, 2.0, -2.0 ** -300, 3.0 * 2.0 ** 901, 0.0, -0.0,
                   np.nextafter(1.0, 2.0)])
    np.testing.assert_array_equal(_keeps(a, un), [False, False, False, True, True, True, True, True,
                                                  True])
    assert _u_twin(2.0 ** 800, -2.0 ** -300) == 0.0  # -0.0: the twin takes it


def test_ray_route_by_device_type(monkeypatch):
    """The occlusion pass takes the ray kernel's route only above the
    threshold of the rows' device type: on the CPU, which has none, the
    native grid DDA at every size; the route gives the same answer."""
    calls = []
    hits = rt.ray_hits
    monkeypatch.setattr(rt, "ray_hits", lambda *a: calls.append(len(a[0])) or hits(*a))
    o, d, v0, v1, v2 = _random_batch(3, R=20, F=10)
    tris = np.stack([v0, v1, v2], 1)
    assert "cpu" not in tk._RAY_NATIVE_THRESHOLD
    want = tk.ray_occlusion(o, d, tris)
    monkeypatch.setattr(tk, "_RAY_NATIVE_THRESHOLD", {"cpu": 200})  # 20 x 10 pairs
    tk.ray_occlusion(o, d, tris)
    assert calls == []
    monkeypatch.setattr(tk, "_RAY_NATIVE_THRESHOLD", {"cpu": 199})
    got = tk.ray_occlusion(o, d, tris)
    assert calls == [20]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _tube_rays():
    """Rays from the 6,406-vertex case's aorta centerline to its RCA
    centerline, against every face of the case: many rays pierce several
    faces, and rays graze shared edges."""
    mesh, cl_ao, cl_rca, _, _ = ccta_case.build_case(mt, 1)
    tris = mesh.vertices[mesh.faces]
    origins = np.repeat(cl_ao, 6, axis=0)
    directions = np.tile(cl_rca[::10], (len(cl_ao), 1)) - origins
    return origins, directions, tris


def test_hits_and_closest_equal_native_dda(monkeypatch):
    pin_route(monkeypatch, "native")
    origins, directions, tris = _tube_rays()
    n_hits, closest, _ = _hits(origins, directions, tris)
    want_hits, want_closest = t_native.ray_occlusion_native(
        origins, directions, tris.reshape(-1, 9))
    assert (n_hits >= 3).sum() > 10
    np.testing.assert_array_equal(n_hits, want_hits)
    np.testing.assert_array_equal(closest, want_closest)


@pytest.mark.parametrize("route", ["native", "python"])
def test_occlusion_mask_on_the_kernel_route(monkeypatch, route):
    """The occlusion pass with the ray route forced (threshold 0) against
    the port's native (or numpy) route and the JAX package's, on the
    6,406-vertex case's RCA course: the same mask.  The JAX package's own
    device route (its threshold 0) computes t with ``jnp.cross`` and
    ``.sum(-1)``, a few ulps off the twin's: on the rays that end on the
    mesh vertex where the RCA centerline starts, every face of the fan
    around it is hit at t = 1 to within 1e-13, XLA's rounding names another
    of them, and its mask differs from every float64 route in a few
    points."""
    pin_route(monkeypatch, route)
    mesh, cl_ao, cl_rca, _, _ = ccta_case.build_case(mt, 1)
    tris = mesh.vertices[mesh.faces]

    def mask(pkg, kernels):
        with contextlib.redirect_stdout(io.StringIO()):
            return kernels.occlusion_remove_mask(
                pkg.numpy_to_centerline(cl_rca), pkg.numpy_to_centerline(cl_ao), 40,
                mesh.vertices, tris, 1.0)

    default = mask(mt, tk)
    jax_default = mask(mj, jk)
    monkeypatch.setattr(tk, "_RAY_NATIVE_THRESHOLD", {"cpu": 0})
    rays = []
    spied = tk.ray_occlusion
    monkeypatch.setattr(tk, "ray_occlusion",
                        lambda *a: rays.append(a) or spied(*a))
    forced = mask(mt, tk)
    monkeypatch.setattr(jk, "_RAY_NATIVE_THRESHOLD", 0)
    jax_device = mask(mj, jk)
    assert forced.sum() > 200
    np.testing.assert_array_equal(forced, default)
    np.testing.assert_array_equal(forced, jax_default)
    assert (forced != jax_device).sum() <= 10
    if (forced != jax_device).any():
        (origins, directions, tri), = rays
        assert _end_vertex_ties(origins, directions, tri) > 0


def _end_vertex_ties(origins, directions, tri, chunk=64):
    """The occluding rays (3 or more hits) on which the JAX package's XLA
    program names another first face than the host twin, each checked to
    end (t = 1) on a vertex of the twin's face, with both faces hit there
    to within 1e-12 in t, so that rounding alone orders them; returns how
    many there are."""
    v = [tri[:, k] for k in range(3)]
    ties = 0
    for s in range(0, len(origins), chunk):
        o, d = origins[s:s + chunk], directions[s:s + chunk]
        twin = tk._ray_triangle_hits_np(o, d, *v)
        xla = np.asarray(jk._ray_triangle_hits(*(jnp.asarray(x) for x in (o, d, *v))))
        for r in np.flatnonzero(np.isfinite(twin).sum(1) >= 3):
            mine, theirs = int(np.argmin(twin[r])), int(np.argmin(xla[r]))
            if mine == theirs:
                continue
            assert abs(twin[r, mine] - 1.0) <= 1e-12 and abs(xla[r, theirs] - 1.0) <= 1e-12
            assert np.linalg.norm(tri[mine] - (o[r] + d[r]), axis=1).min() <= 1e-12
            ties += 1
    return ties
