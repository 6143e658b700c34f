"""The ray-triangle hits of the PyTorch port (``ops.ray_triangle``) on the
CPU, where the wrapper takes its plain PyTorch version: the cases of
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

import ccta_case
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
    splits, per = rt.plan(R, F, sms)
    assert per % rt.TILE == 0 and per > 0 and 1 <= splits <= 65535
    assert splits * per >= F and (splits - 1) * per < max(F, 1)


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
