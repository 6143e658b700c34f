"""Tests of the port that need an NVIDIA GPU: the hand-written sweep kernel
against its plain version (at the single path's and the between search's
shapes), the centerline refine's Hausdorff kernel against its plain version
and against numpy's float64 table, the CCTA kernels (radius count, nearest
pick, batched morph sweep) against theirs, and the single-pullback,
four-phase, centerline and CCTA paths on CUDA against the CPU path.  They skip where
``torch.cuda.is_available()`` is false.

The machine with the card has no JAX, so this file imports none and is run
there without the repository's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import contextlib
import io
import math

import numpy as np
import pytest
import torch

import multimodars_torch as mt
from multimodars_torch.ops import hausdorff_batch as hb
from multimodars_torch.ops import rotation_search as rs
from multimodars_torch.ops import sweep
from multimodars_torch.pipelines import align_between

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _sets(F=4, N=300, M=280, seed=0):
    rng = np.random.default_rng(seed)
    test = rng.standard_normal((F, N, 2))
    ref = rng.standard_normal((F, M, 2))
    tmask = np.ones((F, N), bool)
    rmask = np.ones((F, M), bool)
    tmask[:, -9:] = False
    tmask[0, 1] = False
    rmask[:, -4:] = False
    tmask[1] = False  # pair 1: empty test set -> cost 0
    rmask[-1] = False  # last pair: empty ref set -> cost 0
    return test, ref, tmask, rmask


def test_kernel_matches_plain(cuda):
    """Masked and dense, outer strides 1 and 6, f64 and f32, on the same
    CUDA tensors.  f64 to rtol 1e-12 with equal argmins; f32 within the
    argmin-certification band at each cost (last-ulp rounding and FMA
    contraction differ between the two)."""
    test, ref, tmask, rmask = _sets()
    s2 = np.maximum((test ** 2).sum(-1).max(-1), (ref ** 2).sum(-1).max(-1))
    for dtype in (torch.float64, torch.float32):
        centers = torch.tensor([0.01, -0.02, 0.0, 0.1], dtype=dtype, device=cuda)
        angles, valid = rs.candidate_angles(centers, 0.1, 5.0, 6.0)
        for dense in (False, True):
            for stride in (1, 6):
                args = (
                    torch.tensor(test, dtype=dtype, device=cuda),
                    torch.tensor(ref, dtype=dtype, device=cuda),
                    None if dense else torch.tensor(tmask, device=cuda),
                    None if dense else torch.tensor(rmask, device=cuda),
                    angles, valid,
                )
                kw = dict(dense=dense, outer_stride_test=stride,
                          outer_stride_ref=stride)
                launches = sweep.launches
                got = sweep.cost_table(*args, **kw)
                assert sweep.launches == launches + 1
                want = sweep.cost_table_plain(*args, **kw)
                torch.cuda.synchronize()
                got = got.double().cpu().numpy()
                want = want.double().cpu().numpy()
                assert (np.isinf(got) == np.isinf(want)).all()
                fin = np.isfinite(want)
                if dtype == torch.float64:
                    np.testing.assert_allclose(
                        got[fin], want[fin], rtol=1e-12, atol=0.0
                    )
                    assert (got.argmin(axis=1) == want.argmin(axis=1)).all()
                else:
                    w = want[fin]
                    s2f = np.broadcast_to(s2[:, None], want.shape)[fin]
                    band = rs._TIE_C * rs._eps_eff(torch.float32) * (
                        np.sqrt(s2f * w) + w
                    )
                    assert (np.abs(got[fin] - w) <= band).all()
                if not dense:
                    assert (got[[1, -1]][valid.cpu().numpy()[[1, -1]]] == 0).all()


def test_kernel_refuses_what_it_cannot_take(cuda):
    test, ref, tmask, rmask = _sets()
    centers = torch.zeros(4, dtype=torch.float64, device=cuda)
    angles, valid = rs.candidate_angles(centers, 1.0, 5.0, 6.0)
    t = torch.tensor(test, device=cuda)
    r = torch.tensor(ref, device=cuda)
    with pytest.raises(ValueError, match="expected cuda"):
        sweep.cost_table(t, r, torch.tensor(tmask), torch.tensor(rmask),
                         angles, valid)
    big = torch.zeros((1, 20000, 2), dtype=torch.float64, device=cuda)
    a1, v1 = rs.candidate_angles(centers[:1], 1.0, 5.0, 6.0)
    with pytest.raises(ValueError, match="shared memory"):
        sweep.cost_table(big, big, None, None, a1, v1, dense=True)


def _pullback(n_frames=12, n_points=200, seed=7):
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, 2.0 * math.pi, n_points, endpoint=False)
    rows, rot, cx, cy = [], 0.0, 4.5, 4.5
    for f in range(n_frames):
        rot += rng.uniform(-0.04, 0.04)
        cx += rng.uniform(-0.02, 0.02)
        cy += rng.uniform(-0.02, 0.02)
        a = 2.0 + 0.2 * math.sin(f / 17.0)
        b = 1.4 + 0.2 * math.cos(f / 23.0)
        wobble = 0.08 * np.sin(5 * theta + f / 5.0)
        r_x, r_y = (a + wobble) * np.cos(theta), (b + wobble) * np.sin(theta)
        x = cx + r_x * math.cos(rot) - r_y * math.sin(rot)
        y = cy + r_x * math.sin(rot) + r_y * math.cos(rot)
        rows.append(np.stack(
            [np.full(n_points, f), x, y, np.full(n_points, f * 0.2)], axis=-1
        ))
    return np.concatenate(rows), np.array([0, cx + 3.0, 4.5, 0.0])


def test_main_path_on_cuda_matches_cpu(cuda):
    """from_array_single at step 0.01 / range 6 (three ladder stages): CUDA
    f64 equals CPU f64 (rot to 1e-12 deg, coordinates to 1e-9 mm) and goes
    through the kernel; CUDA f32 picks the same grid angles."""
    lumen, ref = _pullback()
    kw = dict(step_rotation_deg=0.01, range_rotation_deg=6.0, write_obj=False)

    def run(device, dtype):
        data = mt.numpy_to_inputdata(lumen, ref, True)
        with mt.config.use(device=device, dtype=dtype):
            with contextlib.redirect_stdout(io.StringIO()):
                geom, logs = mt.from_array_single(data, **kw)
        coords = np.concatenate([f.lumen.xyz_view() for f in geom.frames])
        return np.array(logs, dtype=float), coords

    launches = sweep.launches
    l64, c64 = run(cuda, torch.float64)
    assert sweep.launches > launches
    l_cpu, c_cpu = run("cpu", torch.float64)
    np.testing.assert_allclose(l64[:, 2], l_cpu[:, 2], rtol=0.0, atol=1e-12)
    np.testing.assert_allclose(c64, c_cpu, rtol=0.0, atol=1e-9)
    l32, c32 = run(cuda, torch.float32)
    np.testing.assert_array_equal(
        np.rint(l32[:, 2] / 0.01), np.rint(l_cpu[:, 2] / 0.01)
    )
    np.testing.assert_array_equal(l32[:, 3:], l_cpu[:, 3:])
    np.testing.assert_allclose(c32, c_cpu, rtol=0.0, atol=1e-4)


def _between_case(widths, seed):
    """Between-search slots of the given (ref, test) widths: noisy elliptic
    clouds, packed by the between search's own
    align_between.pack_between."""
    rng = np.random.default_rng(seed)
    clouds = []
    for k, (m, n) in enumerate(widths):
        sets = []
        for w, turn in ((m, 0.0), (n, 0.2 + k)):
            th = np.linspace(0.0, 2.0 * math.pi, w, endpoint=False) + turn
            sets.append(np.stack([2.0 * np.cos(th), 1.4 * np.sin(th)], -1)
                        + rng.normal(0.0, 0.02, (w, 2)))
        clouds.append(tuple(sets))
    return align_between.pack_between(clouds)


@pytest.mark.parametrize("widths", [
    ((560, 530), (520, 560)),  # two slots, unequal widths near 560 points
    ((1200, 1180), (1100, 1150)),  # past 48 KB of f64 shared memory
])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_at_between_shapes(cuda, widths, dtype):
    """The masked tables of the between search (2 slots, the full path's
    step 0.5 / range 90 grid, strides 1 and 6) against the plain version:
    f64 to rtol 1e-12 with equal argmins, f32 within the certification
    band."""
    test, ref, tmask, rmask = _between_case(widths, seed=3)
    args = [torch.tensor(a, device=cuda) for a in (test, ref, tmask, rmask)]
    args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
    centers = torch.zeros(len(widths), dtype=dtype, device=cuda)
    angles, valid = rs.candidate_angles(centers, 0.5, 90.0, 90.0)
    s2 = np.maximum((test ** 2).sum(-1).max(-1), (ref ** 2).sum(-1).max(-1))
    for stride in (1, 6):
        kw = dict(dense=False, outer_stride_test=stride, outer_stride_ref=stride)
        masked = sweep.masked_launches
        got = sweep.cost_table(*args, angles, valid, **kw)
        assert sweep.masked_launches == masked + 1
        want = sweep.cost_table_plain(*args, angles, valid, **kw)
        torch.cuda.synchronize()
        got = got.double().cpu().numpy()
        want = want.double().cpu().numpy()
        assert (np.isinf(got) == np.isinf(want)).all()
        fin = np.isfinite(want)
        if dtype == torch.float64:
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=0.0)
            assert (got.argmin(axis=1) == want.argmin(axis=1)).all()
        else:
            w = want[fin]
            s2f = np.broadcast_to(s2[:, None], want.shape)[fin]
            band = rs._TIE_C * rs._eps_eff(torch.float32) * (np.sqrt(s2f * w) + w)
            assert (np.abs(got[fin] - w) <= band).all()


# (F, N, M, K, masked): ragged edges of the launch planner; each runs at
# outer strides (1, 1), (6, 6) and (1, 6)
RAGGED = [
    (1, 50, 60, 1, False),
    (2, 61, 47, 12, True),
    (3, 40, 44, 13, True),
    (2, 33, 52, 102, False),
    (3, 40, 36, 362, True),
    (2, 5, 7, 13, True),
]
RAGGED_CASES = [(c, d) for c in RAGGED for d in (torch.float64, torch.float32)] + [
    ((1, 14464, 14464, 2, False), torch.float32),  # the largest square f32 sets
    ((1, 7232, 7232, 2, True), torch.float64),     # the largest square f64 sets
]


@pytest.mark.parametrize(
    "case, dtype", RAGGED_CASES,
    ids=["x".join(map(str, c)) + ("-f64" if d == torch.float64 else "-f32")
         for c, d in RAGGED_CASES],
)
def test_kernel_matches_plain_at_ragged_shapes(cuda, case, dtype):
    """The redesigned kernel against plain where the planner cuts the work
    unevenly: f64 to rtol 1e-12 with equal argmins, f32 within the
    certification band, the same -inf / +inf / 0 slots, and every
    lower-bound entry at most the exact one, bit for bit."""
    F, N, M, K, masked = case
    rng = np.random.default_rng(F * 1000 + N + K)
    test = rng.standard_normal((F, N, 2))
    ref = rng.standard_normal((F, M, 2))
    tmask = rng.random((F, N)) > 0.2
    rmask = rng.random((F, M)) > 0.2
    if masked and F > 2:
        tmask[0] = False  # pair 0: empty test set
        rmask[1, ::6] = False  # pair 1: no stride-6 row of the ref set
    angles = rng.uniform(-math.pi, math.pi, (F, K))
    valid = rng.random((F, K)) > 0.1
    if F > 1:
        valid[-1] = False  # an all-invalid angle row
    args = [torch.tensor(test, dtype=dtype, device=cuda),
            torch.tensor(ref, dtype=dtype, device=cuda),
            torch.tensor(tmask, device=cuda) if masked else None,
            torch.tensor(rmask, device=cuda) if masked else None,
            torch.tensor(angles, dtype=dtype, device=cuda),
            torch.tensor(valid, device=cuda)]
    s2 = np.maximum((test ** 2).sum(-1).max(-1), (ref ** 2).sum(-1).max(-1))
    tables = {}
    for st, sr in ((1, 1), (6, 6), (1, 6)):
        kw = dict(dense=not masked, outer_stride_test=st, outer_stride_ref=sr)
        got = sweep.cost_table(*args, **kw)
        want = sweep.cost_table_plain(*args, **kw)
        torch.cuda.synchronize()
        got = got.double().cpu().numpy()
        want = want.double().cpu().numpy()
        tables[(st, sr)] = got
        for v in (np.inf, -np.inf, 0.0):
            assert ((got == v) == (want == v)).all(), v
        fin = np.isfinite(want)
        if dtype == torch.float64:
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=0.0)
            rows = np.isfinite(want).any(axis=1)
            assert (got[rows].argmin(axis=1) == want[rows].argmin(axis=1)).all()
        else:
            w = want[fin]
            s2f = np.broadcast_to(s2[:, None], want.shape)[fin]
            band = rs._TIE_C * rs._eps_eff(torch.float32) * (np.sqrt(s2f * w) + w)
            assert (np.abs(got[fin] - w) <= band).all()
    exact = tables[(1, 1)]
    for lb in (tables[(6, 6)], tables[(1, 6)]):
        assert (lb <= exact).all()


def test_full_path_on_cuda_matches_cpu(cuda):
    """from_file_full on the vendored ivus_rest + ivus_stress pullbacks at
    the canonical defaults: CUDA f64 equals CPU f64 (rot to 1e-12 deg,
    coordinates to 1e-9 mm), with dense and masked kernel launches."""
    from pathlib import Path

    fixtures = Path(__file__).resolve().parent / "data" / "fixtures"
    paths = (str(fixtures / "ivus_rest"), str(fixtures / "ivus_stress"))

    def run(device):
        with mt.config.use(device=device, dtype=torch.float64):
            with contextlib.redirect_stdout(io.StringIO()):
                out = mt.from_file_full(*paths, write_obj=False)
        coords = np.concatenate([
            f.lumen.xyz_view() for pair in out[:4]
            for g in (pair.geom_a, pair.geom_b) for f in g.frames
        ])
        return np.concatenate([np.array(l, dtype=float) for l in out[4]]), coords

    launches, masked = sweep.launches, sweep.masked_launches
    l_cuda, c_cuda = run(cuda)
    assert sweep.masked_launches > masked
    assert sweep.launches - launches > sweep.masked_launches - masked
    l_cpu, c_cpu = run("cpu")
    np.testing.assert_allclose(l_cuda[:, 2], l_cpu[:, 2], rtol=0.0, atol=1e-12)
    np.testing.assert_allclose(l_cuda[:, 3:], l_cpu[:, 3:], rtol=0.0, atol=1e-9)
    np.testing.assert_allclose(c_cuda, c_cpu, rtol=0.0, atol=1e-9)


def _refine_case(S, K, n, m, seed):
    """Refine-like inputs: candidates and clouds around (200, -200) mm with
    random masks, one empty candidate and one empty cloud."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0.0, 4.0, (S * K, n, 2)) + [200.0, -200.0]
    q = rng.normal(0.0, 4.0, (S, m, 2)) + [200.0, -200.0]
    pmask = rng.random((S * K, n)) > 0.1
    qmask = rng.random((S, m)) > 0.1
    pmask[1] = False
    qmask[-1] = False
    return p, pmask, q, qmask


@pytest.mark.parametrize("n, m", [(37, 45), (2500, 1300), (700, 3100)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_hausdorff_kernel_matches_plain(cuda, dtype, n, m):
    """The shared-reference kernel against its plain version on the same
    CUDA tensors, masked, with an empty candidate and an empty cloud, and
    with sets larger than one shared-memory tile (1024 points) and one
    block's rows (512): equal bit for bit, since both round every
    operation of d2 and min/max are exact."""
    S, K = 3, 5
    p, pmask, q, qmask = _refine_case(S, K, n, m, seed=n + m)
    args = (torch.tensor(p, dtype=dtype, device=cuda), torch.tensor(pmask, device=cuda),
            torch.tensor(q, dtype=dtype, device=cuda), torch.tensor(qmask, device=cuda))
    launches = hb.launches
    got = hb.hausdorff_sq_shared_ref(*args, K)
    assert hb.launches == launches + 1
    want = hb.hausdorff_sq_shared_ref_plain(*args, K)
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == (S * K,)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1] == 0.0 and (got[-K:] == 0.0).all() and (got[2:-K] > 0).all()


def test_hausdorff_kernel_f64_equals_numpy(cuda):
    """The kernel's float64 table equals numpy's dx*dx + dy*dy table with
    exact min and max, bit for bit (the refine's certification relies on
    it)."""
    S, K = 2, 3
    p, pmask, q, qmask = _refine_case(S, K, 900, 1500, seed=1)
    got = hb.hausdorff_sq_shared_ref(
        torch.tensor(p, device=cuda), torch.tensor(pmask, device=cuda),
        torch.tensor(q, device=cuda), torch.tensor(qmask, device=cuda), K,
    ).cpu().numpy()
    for c in range(S * K):
        a, b = p[c][pmask[c]], q[c // K][qmask[c // K]]
        if len(a) == 0 or len(b) == 0:
            assert got[c] == 0.0
            continue
        dx = a[:, None, 0] - b[None, :, 0]
        dy = a[:, None, 1] - b[None, :, 1]
        d2 = dx * dx + dy * dy
        assert got[c] == max(d2.min(axis=1).max(), d2.min(axis=0).max())


def test_hausdorff_kernel_refuses_what_it_cannot_take(cuda):
    p, pmask, q, qmask = _refine_case(1, 2, 10, 12, seed=2)
    args = [torch.tensor(a, device=cuda) for a in (p, pmask, q, qmask)]
    with pytest.raises(ValueError, match="expected cuda"):
        hb.hausdorff_sq_shared_ref(args[0], args[1].cpu(), args[2], args[3], 2)
    with pytest.raises(ValueError, match="reference sets"):
        hb.hausdorff_sq_shared_ref(*args, 3)


def _centerline_case():
    """A 40-frame x 60-point pullback, the vendored RCA centerline, three
    landmarks on branch 0 and a tube cloud around it: the recipe of
    tests/test_torch_centerline.py at a larger size."""
    from pathlib import Path

    vtp = str(Path(__file__).resolve().parent / "data" / "centerlines" / "rca_cl.vtp")
    rng = np.random.default_rng(3)
    th = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    rows = []
    for f in range(40):
        r = 1.6 + 0.25 * np.cos(2 * th + 0.2 * f) + 0.05 * rng.standard_normal(60)
        rows.append(np.stack([np.full(60, f), 4.5 + 0.02 * f + r * np.cos(th),
                              4.5 - 0.01 * f + r * np.sin(th), np.full(60, 0.3 * f)], -1))
    lumen, ref = np.concatenate(rows), np.array([0, 6.1, 4.5, 0.0])
    cl = mt.read_centerline_vtp(vtp)
    pos = cl.positions()[np.array([p.branch_id for p in cl.points]) == 0]
    main = pos[150]
    side = np.cross(pos[151] - pos[149], [0.0, 0.0, 1.0])
    side *= 1.6 / np.linalg.norm(side)
    ring = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    cloud = []
    for i in range(120, 220):
        t = pos[i + 1] - pos[i - 1]
        a = np.cross(t, [0.0, 0.0, 1.0])
        a /= np.linalg.norm(a)
        b = np.cross(t / np.linalg.norm(t), a)
        cloud.append(pos[i] + 1.7 * (np.cos(ring)[:, None] * a + np.sin(ring)[:, None] * b))
    landmarks = (tuple(main), tuple(main + side), tuple(main - side))
    return vtp, lumen, ref, landmarks, np.concatenate(cloud)


def test_align_combined_on_cuda_matches_cpu(cuda):
    """align_combined at the wrapper defaults: CUDA f64 equals CPU f64
    (coordinates to 1e-9 mm) through the refine kernel; CUDA f32 lands on
    the same (shift, angle) winner, coordinates within 1e-4 mm."""
    from multimodars_torch.pipelines import centerline_align as ca

    vtp, lumen, ref, landmarks, cloud = _centerline_case()

    def run(device, dtype):
        geom = mt.numpy_to_geometry(lumen, reference_arr=ref)
        with mt.config.use(device=device, dtype=dtype):
            with contextlib.redirect_stdout(io.StringIO()):
                out, _ = mt.align_combined(mt.read_centerline_vtp(vtp), geom,
                                           *landmarks, cloud)
        coords = np.concatenate([f.lumen.xyz_view() for f in out.frames])
        return coords, ca.refine_report["winner"]

    launches = hb.launches
    c64, w64 = run(cuda, torch.float64)
    assert hb.launches > launches
    c_cpu, w_cpu = run("cpu", torch.float64)
    assert w64 == w_cpu
    np.testing.assert_allclose(c64, c_cpu, rtol=0.0, atol=1e-9)
    c32, w32 = run(cuda, torch.float32)
    assert w32 == w_cpu
    np.testing.assert_allclose(c32, c_cpu, rtol=0.0, atol=1e-4)


# ---------------------------------------------------------------------------
# the CCTA toolkit's kernels: radius count, nearest pick, morph sweep
# ---------------------------------------------------------------------------

from multimodars_torch.ops import morph_sweep as msw  # noqa: E402
from multimodars_torch.ops import nearest as nst  # noqa: E402
from multimodars_torch.ops import radius_count as rct  # noqa: E402

CLOUD_SIZES = [(0, 5), (5, 0), (1, 1), (127, 129), (128, 128), (129, 1025),
               (1025, 127), (513, 1), (57606, 129), (129, 57606)]


def _cloud(n, seed, lattice=True):
    """Points on a 0.25 mm lattice (exact ties and exact radius hits) with
    some duplicated, or Gaussian points."""
    rng = np.random.default_rng(seed)
    if lattice:
        pts = rng.integers(-40, 40, (n, 3)) * 0.25
        if n > 4:
            pts[-3:] = pts[:3]
        return pts.astype(np.float64)
    return rng.standard_normal((n, 3)) * 5.0


@pytest.mark.parametrize("n, m", CLOUD_SIZES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_radius_count_kernel_matches_plain(cuda, n, m, dtype):
    """Counts and flags are integers: kernel = plain exactly, both dtypes,
    with the band edges on lattice distances (r^2 = 1 +- 1/16)."""
    a = torch.tensor(_cloud(n, n + 1), dtype=dtype, device=cuda)
    b = torch.tensor(_cloud(m, m + 2), dtype=dtype, device=cuda)
    for flags in (False, True):
        launches = rct.launches
        got = rct.radius_count(a, b, 1.0 - 1.0 / 16, 1.0 + 1.0 / 16, flags=flags)
        want = rct.radius_count_plain(a, b, 1.0 - 1.0 / 16, 1.0 + 1.0 / 16, flags=flags)
        torch.cuda.synchronize()
        assert rct.launches == launches + (1 if n and m else 0)
        for g, w in zip(got if not flags else (got,), want if not flags else (want,)):
            assert torch.equal(g.cpu(), w.cpu())
        if not flags and n * m >= 100_000:
            assert int(got[1].sum()) > 0  # the band saw pairs


@pytest.mark.parametrize("n, m", [c for c in CLOUD_SIZES if c[1] > 0])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nearest_kernel_matches_plain(cuda, n, m, dtype):
    """Minima are exact: (m1, idx, m2) equal plain bit for bit in both
    dtypes, first-wins on the lattice's ties, m2 = m1 on duplicates."""
    a = torch.tensor(_cloud(n, n + 3), dtype=dtype, device=cuda)
    b = torch.tensor(_cloud(m, m + 4), dtype=dtype, device=cuda)
    launches = nst.launches
    got = nst.nearest(a, b)
    want = nst.nearest_plain(a, b)
    torch.cuda.synchronize()
    assert nst.launches == launches + (1 if n else 0)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("n, m", [(1, 1), (127, 129), (128, 1025), (129, 1),
                                  (513, 300), (57606, 129), (300, 57606)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_morph_sweep_kernel_matches_plain(cuda, n, m, dtype):
    """The sums equal the kernel-ordered plain sums bit for bit in both
    dtypes; against plain's own order, float64 within rel 1e-12 and float32
    within rel 1e-4 (sums of up to 57,606 minima in another order)."""
    rng = np.random.default_rng(n + m)
    p = rng.standard_normal((n, 3)) * 3.0
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = rng.standard_normal((m, 3)) * 3.0
    xs = -2.0 + 0.1 * np.arange(41)
    args = [torch.tensor(x, dtype=dtype, device=cuda) for x in (p, u, r, xs)]
    launches = msw.launches
    got = msw.morph_sweep(*args)
    ordered = msw.morph_sweep_ordered(*args)
    plain = msw.morph_sweep_plain(*args)
    torch.cuda.synchronize()
    assert msw.launches == launches + 1
    rtol = 1e-12 if dtype == torch.float64 else 1e-4
    for g, o, w in zip(got, ordered, plain):
        assert torch.equal(g.cpu(), o.cpu())
        np.testing.assert_allclose(g.double().cpu().numpy(), w.double().cpu().numpy(),
                                   rtol=rtol, atol=0.0)


def _morph_inputs(n, m, seed, K, dtype, device):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3)) * 3.0
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = rng.standard_normal((m, 3)) * 3.0
    return [torch.tensor(x, dtype=dtype, device=device)
            for x in (p, u, r, -2.0 + 0.1 * np.arange(K))]


MORPH_BATCHES = {
    "stage shapes": [(1009, 576, 41), (1009, 384, 41), (1709, 96, 41)],
    "four unequal": [(1, 1, 41), (1025, 1300, 41), (37, 5, 1), (3000, 33, 40)],
    "N = 1, M > a split": [(1, 2500, 41)],
    "M = 1": [(2049, 1, 41)],
    "K = 1": [(700, 576, 1), (129, 17, 1)],
}


@pytest.mark.parametrize("case", list(MORPH_BATCHES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_morph_sweep_batch_kernel_matches_ordered_and_plain(cuda, case, dtype):
    """Up to four sweeps of unequal sizes in one launch: the [2, S, K]
    table equals ``morph_sweep_batch_ordered`` (at the plan the wrapper
    takes) bit for bit in both dtypes, and the plain version within rel
    1e-12 (float64) / 1e-4 (float32); entries past a sweep's K are 0."""
    sizes = MORPH_BATCHES[case]
    K_all = max(K for _, _, K in sizes)
    sets = [_morph_inputs(n, m, 7 * s + n, K_all, dtype, cuda) for s, (n, m, _) in
            enumerate(sizes)]
    pts = torch.cat([s[0] for s in sets])
    unit = torch.cat([s[1] for s in sets])
    ref = torch.cat([s[2] for s in sets])
    xs = sets[0][3]
    sweeps, po, ro = [], 0, 0
    for (n, m, K) in sizes:
        sweeps.append((po, n, ro, m, K))
        po += n
        ro += m
    launches = msw.launches
    got = msw.morph_sweep_batch(pts, unit, ref, xs, sweeps)
    torch.cuda.synchronize()
    assert msw.launches == launches + 1
    f64 = dtype == torch.float64
    plans = msw.launch_plan(sweeps, cuda, f64)
    ordered = msw.morph_sweep_batch_ordered(pts, unit, ref, xs, sweeps, plans)
    plain = msw.morph_sweep_batch_plain(pts, unit, ref, xs, sweeps)
    assert torch.equal(got.cpu(), ordered.cpu())
    rtol = 1e-12 if f64 else 1e-4
    np.testing.assert_allclose(got.double().cpu().numpy(), plain.double().cpu().numpy(),
                               rtol=rtol, atol=0.0)
    for s, (_, _, K) in enumerate(sizes):
        assert not got[:, s, K:].any()
    # the kernel leaves its scratch as it found it: a second launch agrees
    assert torch.equal(msw.morph_sweep_batch(pts, unit, ref, xs, sweeps), got)


def test_morph_sweep_batch_refuses_bad_sweeps_on_the_card(cuda):
    p, u, r, xs = _morph_inputs(20, 10, 1, 41, torch.float64, cuda)
    launches = msw.launches
    with pytest.raises(ValueError, match="outside"):
        msw.morph_sweep_batch(p, u, r, xs, [(15, 10, 0, 10, 41)])
    with pytest.raises(ValueError, match="offsets"):
        msw.morph_sweep_batch(p, u, r, xs, [(0, 20, 0, 10, 0)])
    with pytest.raises(ValueError, match="more than"):
        msw.morph_sweep_batch(p, u, r, xs, [(0, 20, 0, 10, 41)] * 5)
    with pytest.raises(ValueError, match="expected cuda"):
        msw.morph_sweep_batch(p, u.cpu(), r, xs, [(0, 20, 0, 10, 41)])
    assert msw.launches == launches


def _island(n, m, seed, dtype, device):
    """Two interleaved tube-like clouds on a 0.25 mm lattice, as the island
    count sees them: many pairs inside 2 mm, exact ties at lattice radii."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 400, (n + m, 1)) * 0.25
    ring = rng.integers(-6, 7, (n + m, 2)) * 0.25
    pts = np.concatenate([ring, t], 1)
    return (torch.tensor(pts[:n], dtype=dtype, device=device),
            torch.tensor(pts[n:], dtype=dtype, device=device))


@pytest.mark.parametrize("n, m", [(18864, 21587), (18864, 18864), (4514, 4032), (31, 1),
                                  (1, 5000), (1025, 513)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_radius_count_kernel_matches_plain_at_island_shapes(cuda, n, m, dtype):
    """Counts at 2 mm on the lattice (r^2 = 4 exactly hit), band edges
    bracketing it: kernel = plain exactly, and the near band saw pairs."""
    a, b = _island(n, m, n + m, dtype, cuda)
    got = rct.radius_count(a, b, 4.0 - 1e-3, 4.0 + 1e-3)
    # the wrapper rounds the band edges to the dtype; plain gets the same
    want = rct.radius_count_plain(a, b, rct._in_dtype(4.0 - 1e-3, dtype),
                                  rct._in_dtype(4.0 + 1e-3, dtype))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    if n * m > 1e6:
        assert int(got[1].sum()) > 0 and int(got[0].sum()) > 0


@pytest.mark.parametrize("per_split", [64, 128, 576, 1216, 5000])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_radius_count_batch_matches_plain_for_any_split(cuda, monkeypatch, per_split, dtype):
    """Several pairs in one launch (one of them empty on each side), with
    splits of ``per_split`` points forced on the planner: one or several
    tiles per split, a ring that wraps, ragged tails; counts and flags equal
    the per-pair plain calls exactly."""
    a, b = _island(3000, 2600, 7, dtype, cuda)
    pairs = [(0, 2000, 0, 2600, 1.0, 1.07), (100, 0, 0, 2600, 1.0, 1.1),
             (5, 2995, 2600, 0, 1.0, 1.1), (2000, 1000, 17, 2583, 4.0, 4.0001),
             (1, 1, 3, 1, 0.0, 100.0)]
    monkeypatch.setattr(rct, "_plan", lambda sizes, sms, bps: [
        (max(1, -(-m // per_split)), per_split) for _, m in sizes])
    for flags in (False, True):
        launches = rct.launches
        got = rct.radius_count_batch(a, b, pairs, flags=flags)
        want = rct.radius_count_batch_plain(a, b, pairs, flags=flags)
        torch.cuda.synchronize()
        assert rct.launches == launches + 1
        assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("n, m", [(4036, 576), (26449, 50), (31, 1), (5, 3), (300, 1300)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nearest_kernel_matches_plain_for_every_lane_count(cuda, monkeypatch, lanes, n, m,
                                                           dtype):
    """(m1, idx, m2) equal plain bit for bit for every lane count the
    planner can choose, on lattice ties and duplicates, with fewer points
    than lanes and a b set of one point."""
    monkeypatch.setattr(nst, "plan_lanes", lambda n, m, sms=132: lanes)
    a = torch.tensor(_cloud(n, n + 5), dtype=dtype, device=cuda)
    b = torch.tensor(_cloud(m, m + 6), dtype=dtype, device=cuda)
    got = nst.nearest(a, b)
    want = nst.nearest_plain(a, b)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nearest_batch_matches_plain(cuda, dtype):
    """Several pairs in one launch, an empty one among them and ranges that
    start off the 16-byte grid: the byte buffer equals the per-pair plain
    calls', launched once."""
    a = torch.tensor(_cloud(9000, 3), dtype=dtype, device=cuda)
    b = torch.tensor(_cloud(2000, 4), dtype=dtype, device=cuda)
    pairs = [(0, 4036, 1, 576), (4036, 0, 0, 5), (7, 4000, 3, 1), (1, 8999, 0, 2000),
             (3, 60, 11, 12)]
    launches = nst.launches
    got = nst.nearest_batch(a, b, pairs)
    want = nst.nearest_batch_plain(a, b, pairs)
    torch.cuda.synchronize()
    assert nst.launches == launches + 1
    assert torch.equal(got.cpu(), want.cpu())


def test_ccta_glue_on_cuda_matches_cpu(cuda):
    """The batched glue (``min_sqdist_pairs``, ``count_within_radius_pairs``,
    ``within_radius_of_any``) gives the CPU float64 answers on the card in
    both dtypes, in one launch per call."""
    from multimodars_torch.ccta import kernels as ck

    a, b = _cloud(3000, 8), _cloud(1500, 9)

    def run():
        picks = ck.min_sqdist_pairs([(a, b), (b, a), (a[:0], b)])
        counts = ck.count_within_radius_pairs([(a, b), (a, a), (b, a[:0])], 1.5)
        flags = ck.within_radius_of_any(a, b, 1.5)
        return picks, counts, flags

    with mt.config.use(device="cpu", dtype=torch.float64):
        want = run()
    for dtype in (torch.float64, torch.float32):
        launches = (rct.launches, nst.launches)
        with mt.config.use(device=cuda, dtype=dtype):
            got = run()
        assert (rct.launches, nst.launches) == (launches[0] + 2, launches[1] + 1)
        for (gd, gi), (wd, wi) in zip(got[0], want[0]):
            assert np.array_equal(gi, wi) and np.array_equal(gd, wd)
        for g, w in zip(got[1], want[1]):
            assert np.array_equal(g, w)
        assert np.array_equal(got[2], want[2])


def test_ccta_kernels_refuse_what_they_cannot_take(cuda):
    a = torch.zeros((4, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="expected cuda"):
        rct.radius_count(a, torch.zeros((4, 3), dtype=torch.float64), 1.0, 2.0)
    with pytest.raises(ValueError, match="at least one point"):
        nst.nearest(a, a[:0])
    with pytest.raises(ValueError, match="dtype"):
        msw.morph_sweep(a, a, a.float(), a[:, 0])


def test_ccta_slice_on_cuda_matches_cpu(cuda):
    """label -> scale -> stitch on the 6,406-vertex case: CUDA f32 and f64
    give the CPU f64 regions, scalings and stitched mesh exactly, through
    all three kernels."""
    import ccta_case
    from multimodars_torch.ccta import regions

    def run(device, dtype):
        with mt.config.use(device=device, dtype=dtype):
            with contextlib.redirect_stdout(io.StringIO()):
                return ccta_case.run_slice(mt, 1)

    launches = (rct.launches, nst.launches, msw.launches)
    want = run("cpu", torch.float64)
    assert (rct.launches, nst.launches, msw.launches) == launches
    for dtype in (torch.float64, torch.float32):
        got = run(cuda, dtype)
        for g, w in zip(got[:2], want[:2]):
            for key in regions.REGION_KEYS:
                if key in w:
                    assert np.array_equal(regions.get_idx(g, key), regions.get_idx(w, key)), key
        assert np.array_equal(got[2]["mesh"].faces, want[2]["mesh"].faces)
        assert np.array_equal(got[2]["mesh"].vertices, want[2]["mesh"].vertices)
    assert rct.launches > launches[0] and nst.launches > launches[1]
    assert msw.launches == launches[2] + 2  # one launch for the three sweeps of a run
