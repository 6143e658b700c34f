"""Multi-device execution of the PyTorch port (``multimodars_torch.parallel``)
on meshes of 1, 2, 4 and 8 CPU shards, against the JAX package's sharded
functions on its virtual CPU devices (tests/conftest.py makes 8), in
float64: the counterparts of tests/test_parallel.py and of the four clauses
of ``__graft_entry__.dryrun_multichip``.

Every sharded result must equal the unsharded one bit for bit: a mesh only
splits pairs, candidate angles or query rows, and every reduction across
shards is exact (a first-wins minimum, an integer sum, rows joined in
order).  Against the JAX package, angles agree within 1e-13 rad and
coordinates within 1e-12 mm; counts, CCTA region sets and meshes are equal.
"""

import contextlib
import io
import math

import jax
import numpy as np
import pytest
import torch

import ccta_case
import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch.ccta import kernels as tk
from multimodars_torch.ops import argmin_repair as t_repair
from multimodars_torch.ops import nearest as t_nearest
from multimodars_torch.ops import radius_count as t_radius_count
from multimodars_torch.ops import ray_triangle as t_ray
from multimodars_torch.ops.rotation_search import multires_rotation_search
from multimodars_torch.parallel import (
    angle_mesh,
    batched_pairs_from_geometries,
    cohort_mesh,
    cohort_relative_rotations,
    rows_mesh,
    shard_rows_over,
    sharded_count_within_radius,
    sharded_multires_search,
)
from multimodars_torch.utils import device as t_device
from multimodars_tpu import parallel as jpar
from native_route import one_native_route  # noqa: F401  (fixture)

SIZES = (1, 2, 4, 8)
cpu_devices = jax.devices("cpu")


@pytest.fixture(autouse=True)
def _on_cpu(one_native_route):  # noqa: F811
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU, with one native route for both packages."""
    with mt.config.use(device="cpu"):
        yield


def _cpus(n):
    return ["cpu"] * n


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_mesh_defaults_and_slices():
    mesh = t_device.Mesh(["cpu", torch.device("cpu")], "rows")
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.axis_names == ("rows",)
    for make in (angle_mesh, rows_mesh, cohort_mesh):
        assert make().devices == (torch.device("cpu"),)
    assert cohort_mesh().axis_names == ("pairs",)
    assert [(s.start, s.stop) for s in t_device.row_slices(7, 4)] == [
        (0, 2), (2, 4), (4, 6), (6, 7)]
    assert [(s.start, s.stop) for s in t_device.row_slices(2, 4)] == [
        (0, 1), (1, 2), (2, 2), (2, 2)]
    shards = t_device.shards(t_device.Mesh(_cpus(3)), 10)
    assert [(s.index, s.rows.start, s.rows.stop, s.stream) for s in shards] == [
        (0, 0, 4, None), (1, 4, 7, None), (2, 7, 10, None)]
    with pytest.raises(ValueError, match="at least one device"):
        t_device.Mesh([])


def test_mesh_naming_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for make in (angle_mesh, rows_mesh, cohort_mesh):
        with pytest.raises(RuntimeError, match="names a CUDA card"):
            make(["cuda:0"])
    with mt.config.use(device="cuda"), pytest.raises(RuntimeError, match="CUDA card"):
        rows_mesh()


# ---------------------------------------------------------------------------
# the sharded cohort (parallel.cohort)
# ---------------------------------------------------------------------------

SQUAREISH = [(1.0, 3.0), (0.0, 2.0), (0.0, 0.0), (1.0, 0.0), (2.0, 0.0), (2.0, 2.0)]


def _dummy_geometry(pkg):
    """tests/conftest.py's dummy_geometry for either package: three
    square-ish frames rotated by 0/15/30 deg and shifted by (0,0)/(1,1)/(2,2)."""
    frames = []
    for fid, (orig, dz, rot_deg, t) in enumerate(
        [(1, 0.0, 0.0, (0.0, 0.0)), (2, 1.0, 15.0, (1.0, 1.0)), (3, 2.0, 30.0, (2.0, 2.0))]
    ):
        points = [pkg.PyContourPoint(fid, i, x, y, dz, False)
                  for i, (x, y) in enumerate(SQUAREISH)]
        c = pkg.PyContour(fid, orig, points, (0.0, 0.0, dz), None, None, "Lumen")
        c.compute_centroid()
        c = c.translate(t[0], t[1], 0.0)
        c.compute_centroid()
        cx, cy, _ = c.centroid
        c.rotate_rad_inplace(math.radians(rot_deg), (cx, cy))
        ref = pkg.PyContourPoint(1, 0, 3.0, 1.0, 0.0, False) if fid == 0 else None
        frames.append(pkg.PyFrame(c.id, c.centroid, c, {}, ref))
    return pkg.PyGeometry(frames, "dummy_geometry")


@pytest.mark.parametrize("n", SIZES)
def test_cohort_recovers_rotation_on_every_mesh(n):
    sets = batched_pairs_from_geometries([_dummy_geometry(mt) for _ in range(4)], 6)
    test, ref, tm, rm, counts = sets
    assert test.shape[0] == 8 and counts == [2, 2, 2, 2]
    got = cohort_relative_rotations(test, ref, tm, rm, 1.0, 30.0, cohort_mesh(_cpus(n)))
    np.testing.assert_allclose(np.degrees(got), -15.0, atol=1.0)
    want_sets = jpar.batched_pairs_from_geometries(
        [_dummy_geometry(mj) for _ in range(4)], 6, pad_pairs_to=8)
    want = jpar.cohort_relative_rotations(
        *want_sets[:4], 1.0, 30.0, jpar.cohort_mesh(cpu_devices[:8]))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-13)
    one = cohort_relative_rotations(test, ref, tm, rm, 1.0, 30.0, cohort_mesh(_cpus(1)))
    np.testing.assert_array_equal(got, one)


def test_cohort_matches_relative_rotations():
    from multimodars_tpu.pipelines.align_within import relative_rotations

    test, ref, tm, rm, _ = batched_pairs_from_geometries([_dummy_geometry(mt)], 6)
    results = {n: cohort_relative_rotations(test, ref, tm, rm, 0.1, 30.0,
                                            cohort_mesh(_cpus(n))) for n in SIZES}
    for n in SIZES:
        np.testing.assert_array_equal(results[n], results[1])
    single = relative_rotations(_dummy_geometry(mj), 0.1, 30.0, False, 6, None)
    np.testing.assert_allclose(results[8], single, rtol=0.0, atol=1e-13)


def _case_arrays(seed, n_frames, n_points=24):
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n_points, endpoint=False)
    rows = []
    for f in range(n_frames):
        r = 1.5 + 0.3 * np.abs(rng.standard_normal(n_points))
        phi = th + rng.uniform(-0.3, 0.3)
        rows.append(np.column_stack([np.full(n_points, f), 4.5 + r * np.cos(phi),
                                     4.5 + r * np.sin(phi), np.full(n_points, f * 0.2)]))
    return np.concatenate(rows)


def _uneven_sets():
    """Seven pairs of three pullbacks (4, 3 and 3 frames), with a few slots
    masked out so that the tables are masked."""
    geoms = [mt.numpy_to_geometry(_case_arrays(s, n, 20 + 4 * s))
             for s, n in ((1, 4), (2, 3), (3, 3))]
    test, ref, tm, rm, counts = batched_pairs_from_geometries(geoms, 20)
    tm[2, -3:] = False
    rm[5, :4] = False
    return test, ref, tm, rm, counts


def test_cohort_uneven_split_bit_identical():
    test, ref, tm, rm, counts = _uneven_sets()
    assert counts == [3, 2, 2] and not tm.all()
    plain = cohort_relative_rotations(test, ref, tm, rm, 0.1, 20.0)
    for n in (4, 8):
        got = cohort_relative_rotations(test, ref, tm, rm, 0.1, 20.0, cohort_mesh(_cpus(n)))
        np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("n", [9, 12])
def test_padded_batch_equals_jax_and_raises_no_flag(n):
    """``pad_pairs_to`` pads the seven pairs of three pullbacks to ``n`` as
    the JAX package pads them (the same shapes, dtypes and values: zero
    points, all-False masks).  A search of the padded batch, f64 and f32,
    flags no padded pair, so padding costs no repair: the flags and the
    repair counters equal the unpadded batch's, and so do its angles."""
    from multimodars_torch.parallel.cohort import sharded_search

    def geoms(pkg):
        return [pkg.numpy_to_geometry(_case_arrays(s, k, 20 + 4 * s))
                for s, k in ((1, 4), (2, 3), (3, 3))]

    got = batched_pairs_from_geometries(geoms(mt), 20, pad_pairs_to=n)
    want = jpar.batched_pairs_from_geometries(geoms(mj), 20, pad_pairs_to=n)
    assert got[4] == want[4] == [3, 2, 2]
    for g, w in zip(got[:4], want[:4]):
        assert g.shape[0] == n and g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    test, ref, tm, rm, _ = got
    assert not tm[7:].any() and not rm[7:].any()
    mesh = cohort_mesh(_cpus(2))
    for dtype in (torch.float64, torch.float32):
        with mt.config.use(dtype=dtype):
            best, ties = sharded_search(test, ref, tm, rm, 0.1, 20.0, mesh)
            best7, ties7 = sharded_search(test[:7], ref[:7], tm[:7], rm[:7], 0.1, 20.0, mesh)
            assert not ties[7:].any()
            np.testing.assert_array_equal(ties[:7], ties7)
            np.testing.assert_array_equal(best[:7], best7)
            stats = []
            for batch in (got[:4], [x[:7] for x in got[:4]]):
                for k in t_repair.stats:
                    t_repair.stats[k] = 0
                out = cohort_relative_rotations(*batch, 0.1, 20.0, mesh)
                stats.append((out[:7], dict(t_repair.stats)))
            np.testing.assert_array_equal(stats[0][0], stats[1][0])
            assert stats[0][1] == stats[1][1]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cohort_tensor_inputs_equal_numpy(dtype):
    """Tensors are cast to the compute dtype and placed per shard, as the
    JAX package's jax.Array branch is cast and re-laid on its mesh."""
    test, ref, tm, rm, _ = _uneven_sets()
    mesh = cohort_mesh(_cpus(4))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    from_numpy = cohort_relative_rotations(test.astype(np_dtype), ref.astype(np_dtype),
                                           tm, rm, 1.0, 30.0, mesh)
    staged = cohort_relative_rotations(
        torch.tensor(test, dtype=dtype), torch.tensor(ref, dtype=dtype),
        torch.tensor(tm), torch.tensor(rm), 1.0, 30.0, mesh)
    np.testing.assert_array_equal(staged, from_numpy)


def test_cohort_flagged_pairs_repaired_once():
    """A pair congruent under a quarter turn ties at several grid angles on
    every mesh: flagged, re-decided on the exact host ladder, equal to the
    unsharded answer."""
    th = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    sq = np.stack([np.cos(th) * (1 + 0.3 * np.cos(4 * th)),
                   np.sin(th) * (1 + 0.3 * np.cos(4 * th))], -1)
    test = np.stack([sq, sq * 1.01, sq])
    ref = np.stack([sq, sq, sq])
    masks = np.ones((3, 16), bool)
    want = cohort_relative_rotations(test, ref, masks, masks, 1.0, 90.0, cohort_mesh(_cpus(1)))
    for k in t_repair.stats:
        t_repair.stats[k] = 0
    got = cohort_relative_rotations(test, ref, masks, masks, 1.0, 90.0, cohort_mesh(_cpus(2)))
    assert t_repair.stats["flagged"] >= 1
    assert t_repair.stats["repaired"] == t_repair.stats["flagged"]
    np.testing.assert_array_equal(got, want)


def _cohort_cases(pkg):
    """tests/test_parallel.py's three 5-frame, 24-point cases."""
    rng = np.random.default_rng(2)
    cases = []
    for seed in range(3):
        rows = []
        for f in range(5):
            th = np.linspace(0, 2 * np.pi, 24, endpoint=False)
            r = 1.5 + 0.3 * np.abs(rng.standard_normal(24))
            rows.append(np.column_stack([np.full(24, f), 4.5 + r * np.cos(th),
                                         4.5 + r * np.sin(th), np.full(24, f * 0.2)]))
        cases.append(pkg.numpy_to_inputdata(np.concatenate(rows), np.array([0, 7.0, 4.5, 0.0]),
                                            True, label=f"c{seed}"))
    return cases


def test_from_array_cohort_devices_matches_local_and_jax():
    kw = dict(step_rotation_deg=1.0, range_rotation_deg=10.0, sample_size=24, smooth=False)
    plain = _quiet(mt.from_array_cohort, _cohort_cases(mt), **kw)
    sharded = _quiet(mt.from_array_cohort, _cohort_cases(mt), devices=_cpus(8), **kw)
    jax_sharded = _quiet(mj.from_array_cohort, _cohort_cases(mj), devices=cpu_devices[:8], **kw)
    for (g1, l1, a1), (g2, l2, a2), (g3, l3, a3) in zip(plain, sharded, jax_sharded):
        assert len(l1) == len(l2) == len(l3) == 4 and a1 == a2 == a3
        assert [l.rot_deg for l in l1] == [l.rot_deg for l in l2]
        for f1, f2, f3 in zip(g1.frames, g2.frames, g3.frames):
            np.testing.assert_array_equal(f1.lumen.xyz_view(), f2.lumen.xyz_view())
            np.testing.assert_allclose(f2.lumen.xyz_view(), f3.lumen.xyz_view(),
                                       rtol=0.0, atol=1e-12)


# ---------------------------------------------------------------------------
# the angle-sharded search (parallel.angle_shard)
# ---------------------------------------------------------------------------

def _ellipse_sets(seed=0, F=5, N=160):
    """tests/test_parallel.py's rotated-ellipse pairs."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * math.pi, N, endpoint=False)
    pts = []
    for _ in range(F + 1):
        a = 2.0 + 0.2 * rng.standard_normal()
        b = 1.4 + 0.2 * rng.standard_normal()
        rot = rng.uniform(-0.4, 0.4)
        x, y = a * np.cos(th), b * np.sin(th)
        pts.append(np.stack([x * math.cos(rot) - y * math.sin(rot),
                             x * math.sin(rot) + y * math.cos(rot)], -1))
    pts = np.asarray(pts)
    return pts[1:], pts[:-1]


def _port_search(test, ref, tm, rm, step, rng, bruteforce):
    t = lambda x: torch.as_tensor(x)  # noqa: E731
    best, _tie = multires_rotation_search(t(test), t(ref), t(tm), t(rm), step, rng, bruteforce)
    return best.numpy()


@pytest.mark.parametrize("seed, F, step, rng, bruteforce", [
    (0, 5, 0.1, 30.0, False),  # the ladder, tests/test_parallel.py's case
    (3, 3, 0.5, 20.0, True),   # the brute-force sweep
])
def test_angle_shard_identical_across_meshes(seed, F, step, rng, bruteforce):
    test, ref = _ellipse_sets(seed, F)
    tm = np.ones(test.shape[:2], bool)
    rm = np.ones(ref.shape[:2], bool)
    got = {n: sharded_multires_search(test, ref, tm, rm, step, rng,
                                      mesh=angle_mesh(_cpus(n)), bruteforce=bruteforce)
           for n in SIZES}
    for n in SIZES:
        np.testing.assert_array_equal(got[n], got[1])
    np.testing.assert_array_equal(got[1], _port_search(test, ref, tm, rm, step, rng, bruteforce))
    for n in (1, 8):
        want = jpar.sharded_multires_search(test, ref, tm, rm, step, rng,
                                            mesh=jpar.angle_mesh(cpu_devices[:n]),
                                            bruteforce=bruteforce)
        np.testing.assert_allclose(got[n], want, rtol=0.0, atol=1e-13)


def test_angle_shard_flags_and_repairs_ties():
    """The port's certification, which the JAX package's sharded search
    lacks: a pair whose grid angles tie is flagged by the band count over
    all shards and re-decided, landing where the unsharded search's repair
    lands."""
    th = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    sq = np.stack([np.cos(th) * (1 + 0.3 * np.cos(4 * th)),
                   np.sin(th) * (1 + 0.3 * np.cos(4 * th))], -1)
    test = np.stack([sq, sq * 1.01, np.roll(sq, 3, axis=0)])
    ref = np.stack([sq, sq, sq])
    masks = np.ones((3, 16), bool)
    want = cohort_relative_rotations(test, ref, masks, masks, 1.0, 90.0, cohort_mesh(_cpus(1)))
    for n in (1, 3, 8):
        for k in t_repair.stats:
            t_repair.stats[k] = 0
        got = sharded_multires_search(test, ref, masks, masks, 1.0, 90.0,
                                      mesh=angle_mesh(_cpus(n)))
        assert t_repair.stats["flagged"] >= 1
        assert t_repair.stats["repaired"] == t_repair.stats["flagged"]
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the row-sharded count (parallel.ccta_shard)
# ---------------------------------------------------------------------------

def _helix_clouds(seed=0, n=700, m=900):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * math.pi, n)
    a = np.stack([np.cos(t), np.sin(t), t / 4.0], -1) + 0.05 * rng.standard_normal((n, 3))
    s = np.linspace(0, 4 * math.pi, m)
    b = np.stack([np.cos(s), np.sin(s), s / 4.0], -1) + 0.05 * rng.standard_normal((m, 3))
    return a, b


def test_sharded_count_identical_across_meshes():
    from multimodars_tpu.ccta.kernels import count_within_radius as j_count

    a, b = _helix_clouds()
    got = {n: sharded_count_within_radius(a, b, 0.35, mesh=rows_mesh(_cpus(n))) for n in SIZES}
    for n in SIZES:
        np.testing.assert_array_equal(got[n], got[1])
    np.testing.assert_array_equal(got[1], tk.count_within_radius(a, b, 0.35))
    np.testing.assert_array_equal(got[1], j_count(a, b, 0.35))
    want = jpar.sharded_count_within_radius(a, b, 0.35, mesh=jpar.rows_mesh(cpu_devices[:8]))
    np.testing.assert_array_equal(got[8], want)


def test_sharded_count_empty_sets():
    mesh = rows_mesh(_cpus(2))
    assert sharded_count_within_radius(np.zeros((0, 3)), np.ones((5, 3)), 1.0, mesh).shape == (0,)
    out = sharded_count_within_radius(np.ones((3, 3)), np.zeros((0, 3)), 1.0, mesh)
    np.testing.assert_array_equal(out, np.zeros(3, dtype=np.int64))


@pytest.mark.parametrize("seed", range(4))
def test_sharded_count_matches_component_oracle(seed):
    """tests/test_ccta_fuzz.py's counterpart: lattice clouds whose pairs sit
    on the radius, against the brute-force oracle, on an uneven mesh."""
    from test_ccta_fuzz import _brute, _case

    a, b, r = _case(seed + 200)
    got = sharded_count_within_radius(a, b, r, mesh=rows_mesh(_cpus(3)))
    np.testing.assert_array_equal(got, _brute(a, b, r))


def test_rows_actually_sharded(monkeypatch):
    """Each shard's rows go to a launch of their own, made under that
    shard's context, with the target set whole; a shard whose slice is
    empty launches nothing."""
    seen = []
    for mod, name in ((t_radius_count, "radius_count_batch"), (t_nearest, "nearest_batch"),
                      (t_ray, "ray_hits")):
        fn = getattr(mod, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            shard = t_device.current_shard()
            rows = (args[0].shape[0] if _name == "ray_hits"
                    else [p[1] for p in args[2]])
            seen.append((_name, shard.index, rows))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, spy)
    a, b = _helix_clouds(n=10, m=30)
    with shard_rows_over(rows_mesh(_cpus(4))):
        tk.count_within_radius(a, b, 0.35)
        tk.min_sqdist_pairs([(a, b), (a[:3], b)])
        tk.within_radius_of_any(a[:3], b, 0.35)
    monkeypatch.setattr(tk, "_RAY_NATIVE_THRESHOLD", {"cpu": 0})
    with shard_rows_over(rows_mesh(_cpus(3))):
        tk.ray_occlusion(a, b[:10] - a, np.stack([b[:5], b[5:10], b[10:15]], 1))
    assert seen == [
        ("radius_count_batch", 0, [3]), ("radius_count_batch", 1, [3]),
        ("radius_count_batch", 2, [2]), ("radius_count_batch", 3, [2]),
        ("nearest_batch", 0, [3, 1]), ("nearest_batch", 1, [3, 1]),
        ("nearest_batch", 2, [2, 1]), ("nearest_batch", 3, [2, 0]),
        ("radius_count_batch", 0, [1]), ("radius_count_batch", 1, [1]),
        ("radius_count_batch", 2, [1]),
        ("ray_hits", 0, 4), ("ray_hits", 1, 3), ("ray_hits", 2, 3),
    ]


# ---------------------------------------------------------------------------
# the dry run's four clauses, at its sizes
# ---------------------------------------------------------------------------

def _synthetic_pairs(n_pairs, n_points, seed=0):
    """__graft_entry__._synthetic_pairs."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, 2.0 * math.pi, n_points, endpoint=False)
    base = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    radii = 2.0 + 0.4 * np.abs(rng.standard_normal((n_pairs, n_points, 1)))
    ref = base[None] * radii
    rot = rng.uniform(-0.15, 0.15, size=(n_pairs, 1))
    c, s = np.cos(rot), np.sin(rot)
    test = np.stack([ref[..., 0] * c - ref[..., 1] * s, ref[..., 0] * s + ref[..., 1] * c], -1)
    return test, ref, np.ones((n_pairs, n_points), dtype=bool)


def _dry_cases(pkg):
    rng = np.random.default_rng(1)
    cases = []
    for seed in range(2):
        rows = []
        for f in range(4):
            th = np.linspace(0, 2 * math.pi, 16, endpoint=False)
            r = 1.5 + 0.3 * np.abs(rng.standard_normal(16))
            rows.append(np.column_stack([np.full(16, f), 4.5 + r * np.cos(th),
                                         4.5 + r * np.sin(th), np.full(16, f * 0.2)]))
        cases.append(pkg.numpy_to_inputdata(np.concatenate(rows), np.array([0, 7.0, 4.5, 0.0]),
                                            True, label=f"dry{seed}"))
    return cases


def test_dryrun_clause_cohort():
    kw = dict(step_rotation_deg=1.0, range_rotation_deg=10.0, sample_size=16, smooth=False)
    cohort = _quiet(mt.from_array_cohort, _dry_cases(mt), devices=_cpus(8), **kw)
    assert len(cohort) == 2 and all(len(logs) == 3 for _, logs, _ in cohort)
    local = _quiet(mt.from_array_cohort, _dry_cases(mt), **kw)
    for (g1, _, _), (g2, _, _) in zip(cohort, local):
        for f1, f2 in zip(g1.frames, g2.frames):
            np.testing.assert_array_equal(f1.lumen.xyz_view(), f2.lumen.xyz_view())


def test_dryrun_clause_angle_shard():
    """The dry run's search (step 0.5, range 10): bit-identical on 8 shards
    and 1.  The port's plan takes the brute-force sweep here, as its
    unsharded search does, where the JAX package's sharded search runs the
    ladder; so both are held against the JAX package's unsharded search."""
    from multimodars_tpu.ops.rotation_search import multires_rotation_search as j_search

    t2, r2, m2 = _synthetic_pairs(3, 24, seed=7)
    ang_8 = sharded_multires_search(t2, r2, m2, m2, 0.5, 10.0, mesh=angle_mesh(_cpus(8)))
    ang_1 = sharded_multires_search(t2, r2, m2, m2, 0.5, 10.0, mesh=angle_mesh(_cpus(1)))
    np.testing.assert_array_equal(ang_8, ang_1)
    np.testing.assert_array_equal(ang_1, _port_search(t2, r2, m2, m2, 0.5, 10.0, False))
    want = np.asarray(j_search(t2, r2, m2, m2, 0.5, 10.0)[0])
    np.testing.assert_allclose(ang_1, want, rtol=0.0, atol=1e-13)


def test_dryrun_clause_count():
    rng = np.random.default_rng(3)
    s = np.linspace(0.0, 4.0 * math.pi, 96)
    cloud_a = np.stack([np.cos(s), np.sin(s), s / 4.0], -1) + 0.05 * rng.standard_normal((96, 3))
    cloud_b = cloud_a[::-1] + 0.02 * rng.standard_normal((96, 3))
    cnt_8 = sharded_count_within_radius(cloud_a, cloud_b, 0.3, mesh=rows_mesh(_cpus(8)))
    cnt_1 = sharded_count_within_radius(cloud_a, cloud_b, 0.3, mesh=rows_mesh(_cpus(1)))
    np.testing.assert_array_equal(cnt_8, cnt_1)
    np.testing.assert_array_equal(cnt_8, tk.count_within_radius(cloud_a, cloud_b, 0.3))


def _dry_fusion_case(pkg):
    """__graft_entry__._ccta_fusion_case for either package: an aorta tube,
    two coronary tubes and 6 IV frames across the RCA."""
    from importlib import import_module

    mesh_mod = import_module(pkg.__name__ + ".ccta.mesh")

    def tube(p0, p1, n_slices, radius, n_ring):
        centers = np.linspace(np.asarray(p0, float), np.asarray(p1, float), n_slices)
        u, v = ccta_case.basis_from_tangent(centers[-1] - centers[0])
        th = 2.0 * math.pi * np.arange(n_ring) / n_ring
        ring = np.cos(th)[:, None] * u + np.sin(th)[:, None] * v
        verts = (centers[:, None, :] + radius * ring[None]).reshape(-1, 3)
        faces = []
        for i in range(n_slices - 1):
            a0, b0 = i * n_ring, (i + 1) * n_ring
            for k in range(n_ring):
                k1 = (k + 1) % n_ring
                faces.append([a0 + k, b0 + k, b0 + k1])
                faces.append([a0 + k, b0 + k1, a0 + k1])
        return mesh_mod.Mesh(verts, np.asarray(faces, dtype=np.int64))

    rca_p0, rca_p1 = (30.0, 0.0, 14.0), (22.0, -2.0, -8.0)
    mesh = mesh_mod.concatenate([
        tube((36, 0, 0), (36, 0, 20), 13, 6.0, 24),
        tube(rca_p0, rca_p1, 17, 1.4, 16),
        tube((42, 0, 14), (50, 2, -8), 17, 1.4, 16),
    ])
    mesh.fix_normals()
    cl_ao = np.linspace([36.0, 0, 20], [36.0, 0, 0], 40)
    cl_rca = np.linspace(rca_p0, rca_p1, 48)
    cl_lca = np.linspace([42.0, 0, 14], [50.0, 2, -8], 48)
    p0, p1 = np.asarray(rca_p0), np.asarray(rca_p1)
    axis_v = p1 - p0
    u, v = ccta_case.basis_from_tangent(axis_v)
    lumen_rows, wall_rows = [], []
    for f, t in enumerate(np.linspace(0.42, 0.62, 6)):
        c = p0 + t * axis_v
        for k in range(16):
            th = 2.0 * math.pi * k / 16
            d = math.cos(th) * u + math.sin(th) * v
            lumen_rows.append([f, *(c + 1.2 * d)])
            wall_rows.append([f, *(c + 1.7 * d)])
    geom = pkg.numpy_to_geometry(np.asarray(lumen_rows), wall_arr=np.asarray(wall_rows),
                                 label="iv")
    geom.frames[0].lumen.aortic_thickness = 1.0
    return mesh, cl_ao, cl_rca, cl_lca, geom


def _fusion_run(pkg, case, ctx, n_removed=30):
    """label -> scale -> stitch as the dry run drives it (the case is
    rebuilt per run: the pipeline mutates its inputs)."""
    mesh0, cl_ao, cl_rca, cl_lca, geom = case(pkg)
    mesh_mod = __import__(pkg.__name__ + ".ccta.mesh", fromlist=["Mesh"])
    with contextlib.redirect_stdout(io.StringIO()), ctx:
        results, (rca_cl, _, ao_cl) = pkg.label(
            mesh_mod.Mesh(mesh0.vertices.copy(), mesh0.faces.copy()), cl_ao, cl_rca, cl_lca,
            aligned_frames=geom.frames, anomalous_rca=True, control_plot=False)
        results = dict(results)
        if not results["rca_removed_points"]:
            ao = np.asarray(results["aorta_points"])
            near = np.linalg.norm(ao - np.asarray(ccta_case.RCA_P0), axis=1) < 5.0
            results["rca_removed_points"] = [tuple(p) for p in ao[near][:n_removed]]
        results = pkg.scale(results, rca_cl, ao_cl, geom.frames)
        stitched = pkg.stitch(results, geom, region_remove=("anomalous_points",),
                              prox_start_mode="nearest_iv", dist_start_mode="nearest_iv")
    return results, stitched


REGION_KEYS = ("aorta_points", "rca_points", "lca_points", "rca_removed_points",
               "anomalous_points", "proximal_points", "distal_points")


def _assert_same_fusion(got, want, faces_too=True):
    (res_g, st_g), (res_w, st_w) = got, want
    for key in REGION_KEYS:
        assert sorted(map(tuple, res_g[key])) == sorted(map(tuple, res_w[key])), key
    np.testing.assert_array_equal(res_g["mesh"].vertices, res_w["mesh"].vertices)
    np.testing.assert_array_equal(st_g["mesh"].vertices, st_w["mesh"].vertices)
    np.testing.assert_array_equal(st_g["mesh"].faces, st_w["mesh"].faces)


def test_dryrun_clause_ccta_orchestration():
    """label -> scale -> stitch row-sharded over 8 shards, over 1 and with
    no mesh: bit-identical (the occlusion rays keep their default route, as
    the dry run keeps them)."""
    run8 = _fusion_run(mt, _dry_fusion_case, shard_rows_over(rows_mesh(_cpus(8))))
    run1 = _fusion_run(mt, _dry_fusion_case, shard_rows_over(rows_mesh(_cpus(1))))
    local = _fusion_run(mt, _dry_fusion_case, contextlib.nullcontext())
    _assert_same_fusion(run8, run1)
    _assert_same_fusion(run8, local)


# ---------------------------------------------------------------------------
# the 6,406-vertex CCTA case under the mesh, the ray kernel's route forced
# ---------------------------------------------------------------------------

def _case_run(pkg, ctx):
    return _fusion_run(pkg, lambda p: ccta_case.build_case(p, 1), ctx, n_removed=100)


def test_ccta_slice_under_mesh_with_ray_route(monkeypatch):
    """label -> scale -> stitch on 8 shards, on 1 and with no mesh, the
    ray kernel's route forced (one launch a shard), bit-identical; and equal
    to the JAX package's run on its 8-device mesh with every count and pick
    wave forced onto the device (``MMTPU_CCTA_RESIDENT=1``, pair threshold
    0).  The JAX package's rays keep their float64 native route there: its
    own device route (ray threshold 0) computes t a few ulps off the host
    twin and, on rays that end on a mesh vertex where a fan of faces meets,
    names another face of the fan (tests/test_torch_ray_triangle.py), which
    moves a few aorta points."""
    import multimodars_tpu.ccta.kernels as jk

    monkeypatch.setattr(tk, "_RAY_NATIVE_THRESHOLD", {"cpu": 0})
    launches = t_ray.launches
    calls = []
    hits = t_ray.ray_hits

    def spy(*args):
        calls.append(args[0].shape[0])
        return hits(*args)

    monkeypatch.setattr(t_ray, "ray_hits", spy)
    run8 = _case_run(mt, shard_rows_over(rows_mesh(_cpus(8))))
    assert len(calls) == 8 and t_ray.launches == launches  # the CPU takes plain
    run1 = _case_run(mt, shard_rows_over(rows_mesh(_cpus(1))))
    local = _case_run(mt, contextlib.nullcontext())
    _assert_same_fusion(run8, run1)
    _assert_same_fusion(run8, local)

    monkeypatch.setenv("MMTPU_CCTA_RESIDENT", "1")
    monkeypatch.setattr(jk, "_DEVICE_PAIR_THRESHOLD", 0)
    want = _case_run(mj, jpar.shard_rows_over(jpar.rows_mesh(cpu_devices[:8])))
    _assert_same_fusion(run8, want)
