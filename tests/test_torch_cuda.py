"""Tests of the port that need an NVIDIA GPU: the hand-written sweep kernel
against its plain version (at the single path's and the between search's
shapes), the centerline refine's Hausdorff kernel against its plain version
and against numpy's float64 table, and through the public
``ops.hausdorff_sq_masked``, the CCTA kernels (radius count, nearest
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

# the f32 kernel against its plain version, in units eps32*(sqrt(scale2*c)+c)
# of each cost c: the value of the certification band of earlier checkouts,
# kept as the tolerance when the band was derived anew (ops/rotation_search.py)
KERNEL_PLAIN_F32_UNITS = 8.0


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
                    band = KERNEL_PLAIN_F32_UNITS * rs._eps_eff(torch.float32) * (
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
            band = KERNEL_PLAIN_F32_UNITS * rs._eps_eff(torch.float32) * (np.sqrt(s2f * w) + w)
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
            band = KERNEL_PLAIN_F32_UNITS * rs._eps_eff(torch.float32) * (np.sqrt(s2f * w) + w)
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


def _numpy_table(p, pmask, q, qmask, K):
    """numpy's dx*dx + dy*dy table with exact min and max, 0 for an empty
    set: what the f64 kernel must equal bit for bit."""
    out = np.zeros(len(p))
    for c in range(len(p)):
        a, b = p[c][pmask[c]], q[c // K][qmask[c // K]]
        if len(a) and len(b):
            dx = a[:, None, 0] - b[None, :, 0]
            dy = a[:, None, 1] - b[None, :, 1]
            d2 = dx * dx + dy * dy
            out[c] = max(d2.min(axis=1).max(), d2.min(axis=0).max())
    return out


# (S, K, n, m): the refine's layout, sets over one shared-memory tile; the
# public call on OCT-280's pairs (279 candidates of 520 points, K = 1); sets
# that left a one-row last tile under the 512-row grid of the first kernel;
# n >> m and n << m
HAUSDORFF_SHAPES = [(3, 5, 37, 45), (3, 5, 2500, 1300), (3, 5, 700, 3100),
                    (279, 1, 520, 520), (3, 5, 513, 1), (3, 5, 1, 513),
                    (2, 3, 9000, 40), (2, 3, 40, 9000)]


@pytest.mark.parametrize("S, K, n, m", HAUSDORFF_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_hausdorff_kernel_matches_plain(cuda, dtype, S, K, n, m):
    """The shared-reference kernel against its plain version on the same
    CUDA tensors, masked, with an empty candidate and an empty cloud: one
    launch a call, equal bit for bit, since both round every operation of
    d2 and min/max are exact; in float64 also numpy's table.  A candidate is
    0 exactly where one of its sets is empty."""
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
    both = pmask.any(1) & qmask[np.arange(S * K) // K].any(1)
    assert got[1] == 0.0 and (got[-K:] == 0.0).all()
    np.testing.assert_array_equal(got > 0, both)
    if dtype == torch.float64:
        np.testing.assert_array_equal(got, _numpy_table(p, pmask, q, qmask, K))


@pytest.mark.parametrize("S, K, n, m", [(1, 2, 300, 20000), (1, 2, 6000, 9000)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_hausdorff_kernel_split_columns(cuda, dtype, S, K, n, m):
    """Too few candidates to fill the card: the plan splits the columns
    over several blocks (row minima meet in the scratch), with several row
    tiles in the second case (column minima too).  Bit for bit the plain
    version in one launch, and the same table again after a call of
    another shape, so the kernel left its scratch as it found it."""
    p, pmask, q, qmask = _refine_case(S, K, n, m, seed=n)
    pmask[1 % (S * K)] = True
    qmask[-1] = True
    args = (torch.tensor(p, dtype=dtype, device=cuda), torch.tensor(pmask, device=cuda),
            torch.tensor(q, dtype=dtype, device=cuda), torch.tensor(qmask, device=cuda))
    plan = hb.launch_plan(S * K, n, m, args[0].element_size(), cuda)
    assert plan.splits > 1
    if n > 1000:
        assert plan.tiles > 1
    launches = hb.launches
    got = hb.hausdorff_sq_shared_ref(*args, K)
    assert hb.launches == launches + 1
    other = _refine_case(3, 5, 700, 3100, seed=2)
    hb.hausdorff_sq_shared_ref(torch.tensor(other[0], dtype=dtype, device=cuda),
                               torch.tensor(other[1], device=cuda),
                               torch.tensor(other[2], dtype=dtype, device=cuda),
                               torch.tensor(other[3], device=cuda), 5)
    again = hb.hausdorff_sq_shared_ref(*args, K)
    want = hb.hausdorff_sq_shared_ref_plain(*args, K)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    assert (got > 0).all()


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


@pytest.mark.parametrize("layout", ["pairs", "refine", "3-D points"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_public_hausdorff_launches_the_refine_kernel(cuda, dtype, layout):
    """``ops.hausdorff_sq_masked`` on CUDA tensors: one refine kernel launch
    a call, equal bit for bit to the plain version on the same tensors, with
    an empty set on either side; its distance is the square root."""
    from multimodars_torch import ops
    from multimodars_torch.ops.hausdorff import hausdorff_sq_masked_plain

    S, K = 3, 5
    p, pmask, q, qmask = _refine_case(S, K, 300, 420, seed=7)
    if layout == "pairs":  # one candidate a reference set
        p, pmask = p[::K], pmask[::K]
        pmask[0] = False
    elif layout == "refine":  # [S, K, n] against [S, 1, m]
        p, pmask = p.reshape(S, K, 300, 2), pmask.reshape(S, K, 300)
        q, qmask = q[:, None], qmask[:, None]
    else:  # x, y, z points: x and y are used
        p, pmask = p[::K], pmask[::K]
        p = np.concatenate([p, np.ones(p.shape[:-1] + (1,))], -1)
        q = np.concatenate([q, np.full(q.shape[:-1] + (1,), -3.0)], -1)
    args = (torch.tensor(p, dtype=dtype, device=cuda), torch.tensor(q, dtype=dtype, device=cuda),
            torch.tensor(pmask, device=cuda), torch.tensor(qmask, device=cuda))
    launches = hb.launches
    got = ops.hausdorff_sq_masked(*args)
    assert hb.launches == launches + 1
    want = hausdorff_sq_masked_plain(args[0][..., :2], args[1][..., :2], *args[2:])
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert (got.reshape(-1) == 0).any()
    dist = ops.hausdorff_distance_masked(*args)
    assert hb.launches == launches + 2
    assert torch.equal(dist, torch.sqrt(got))


def test_public_searches_take_any_strides(cuda):
    """The public searches on transposed views (as the build funnel's sample
    sets are laid out) give the bits of their contiguous copies, on the
    sweep kernel."""
    from multimodars_torch import ops

    test, ref, tmask, rmask = _sets(F=5, N=200, M=190, seed=3)
    views = [torch.tensor(np.ascontiguousarray(a.swapaxes(0, 1)), device=cuda).transpose(0, 1)
             for a in (test, ref, tmask, rmask)]
    assert not views[0].is_contiguous()
    dense = [v.contiguous() for v in views]
    launches = sweep.launches
    got = ops.multires_rotation_search(*views, 0.01, 6.0)
    assert sweep.launches > launches
    want = ops.multires_rotation_search(*dense, 0.01, 6.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    centers = got[0]
    got = ops.search_range_batched(*views, 0.01, 0.1, centers, 6.0)
    want = ops.search_range_batched(*dense, 0.01, 0.1, centers, 6.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    angles, valid = rs.candidate_angles(centers, 0.01, 0.1, 6.0)
    got = ops.rotation_cost_table(*views, angles, valid)
    assert torch.equal(got, ops.rotation_cost_table(*dense, angles, valid))


def test_public_hausdorff_refuses_what_the_kernel_cannot_take(cuda):
    """Integer points, or masks on another device, raise on the card: no
    plain version stands in."""
    from multimodars_torch import ops

    p = torch.zeros((2, 4, 2), dtype=torch.int32, device=cuda)
    mask = torch.ones((2, 4), dtype=torch.bool, device=cuda)
    launches = hb.launches
    with pytest.raises(ValueError, match="float32 or float64"):
        ops.hausdorff_sq_masked(p, p, mask, mask)
    with pytest.raises(ValueError, match="expected cuda"):
        ops.hausdorff_sq_masked(p.double(), p.double(), mask.cpu(), mask)
    assert hb.launches == launches


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


def test_refine_grid_on_cuda_equals_the_cpu_build(cuda):
    """The refine's candidate grid made on the card equals the CPU build of
    the same case bit for bit (elementwise float64 operations, each
    rounded once on either device), and both refines choose one winner."""
    from multimodars_torch.pipelines import centerline_align as ca

    vtp, lumen, ref, landmarks, cloud = _centerline_case()
    seen = []
    inner = ca.build_refine_grid

    def spy(*args):
        grid = inner(*args)
        seen.append((args, grid))
        return grid

    ca.build_refine_grid = spy
    try:
        winners = []
        for device in ("cpu", cuda):
            geom = mt.numpy_to_geometry(lumen, reference_arr=ref)
            with mt.config.use(device=device, dtype=torch.float64):
                with contextlib.redirect_stdout(io.StringIO()):
                    mt.align_combined(mt.read_centerline_vtp(vtp), geom, *landmarks, cloud)
            winners.append(ca.refine_report["winner"])
    finally:
        ca.build_refine_grid = inner
    (_, cpu), (_, card) = seen
    assert card.p.device.type == "cuda" and cpu.p.device.type == "cpu"
    for got, want in zip(card[:4], cpu[:4]):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.cpu(), want)
    assert (card.idx, card.n) == (cpu.idx, cpu.n)
    assert winners[0] == winners[1]


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


@pytest.mark.parametrize("n_pairs", [9, 13, 17])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nearest_batch_past_one_launch_equals_single_picks(cuda, dtype, n_pairs):
    """A pick batch of more than MAX_PAIRS pairs takes ceil(pairs / 8)
    launches, the later ones writing their rows at an offset: its buffer
    equals the plain version's, and each pair's rows equal the pair picked
    on its own on the card."""
    rng = np.random.default_rng(n_pairs)
    a = torch.tensor(_cloud(30000, 7), dtype=dtype, device=cuda)
    b = torch.tensor(_cloud(3000, 8), dtype=dtype, device=cuda)
    pairs = []
    for _ in range(n_pairs):
        n, m = int(rng.integers(0, 3000)), int(rng.integers(1, 200))
        pairs.append((int(rng.integers(0, 30000 - n)), n, int(rng.integers(0, 3000 - m)), m))
    launches = nst.launches
    got = nst.nearest_batch(a, b, pairs)
    torch.cuda.synchronize()
    assert nst.launches == launches + -(-n_pairs // nst.MAX_PAIRS)
    assert torch.equal(got.cpu(), nst.nearest_batch_plain(a, b, pairs).cpu())
    m1, idx, m2 = nst.views(got, dtype)
    o = 0
    for a_off, n, b_off, m in pairs:
        one = nst.nearest(a[a_off:a_off + n], b[b_off:b_off + m])
        for g, w in zip((m1, idx, m2), one):
            assert torch.equal(g[o:o + n].cpu(), w.cpu())
        o += n


def test_zero_cost_certificate_on_the_card(cuda):
    """C.4 (a) through the card's f32 pruned stage: the set of
    tests/test_torch_band.py (its points turned as the card's plain
    version turns them) returns the f64 winner or a flag, and the repair
    lands on the f64 grid angle."""
    from test_torch_band import ZERO_COST_SEEDS, zero_cost_prune_set

    from multimodars_torch.ops import argmin_repair

    centers = torch.zeros(1, dtype=torch.float64, device=cuda)
    for s0 in ZERO_COST_SEEDS:
        test, ref, angles, valid = zero_cost_prune_set(s0, device=cuda)
        t64 = sweep.cost_table(torch.tensor(test, device=cuda), torch.tensor(ref, device=cuda),
                               None, None, angles.to(cuda), valid.to(cuda), dense=True)
        want = float(angles[0, int(t64.argmin())])
        with mt.config.use(device="cuda", dtype=torch.float32):
            best, tie = rs.search_range_batched_pruned(
                torch.tensor(test, dtype=torch.float32, device=cuda),
                torch.tensor(ref, dtype=torch.float32, device=cuda),
                None, None, 1.0, 180.0, centers, 180.0, dense=True)
            assert float(best[0]) == want or bool(tie[0])
            fixed = argmin_repair.repair_sets(best.cpu().numpy(), tie.cpu().numpy(),
                                              lambda i: (test[0], ref[0]), 1.0, 180.0, True)
        assert fixed[0] == want


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


def _tree_parts(tree):
    """Every contour's coordinates, ids and point indices of a discretized
    tree, vessel by vessel and branch by branch, and its reference points."""
    stacks = [tree.discretized_aorta, tree.discretized_rca_main, tree.discretized_lca_main,
              *tree.rca_branches, *tree.lca_branches]
    contours = [[(c.id, c.point_indices.tolist(), c.xyz_view().copy()) for c in s]
                for s in stacks]
    refs = (tree.ao_rca, tree.ao_lca, tree.rca_references, tree.lca_references)
    return contours, refs


def test_vessel_tree_on_cuda_matches_cpu(cuda):
    """label -> prepare_centerlines -> discretize_vessel_tree on the
    6,406-vertex case, with and without the B-spline refit: CUDA f32 and f64
    give the CPU f64 contours and reference points exactly, the tree's
    walks in one nearest launch."""
    import ccta_case

    def prepared(device, dtype):
        with mt.config.use(device=device, dtype=dtype):
            with contextlib.redirect_stdout(io.StringIO()):
                mesh, cl_ao, cl_rca, cl_lca, geom = ccta_case.build_case(mt, 1)
                results, (rca_cl, lca_cl, ao_cl) = mt.label(
                    mesh, cl_ao, cl_rca, cl_lca, aligned_frames=geom.frames,
                    anomalous_rca=True, control_plot=False)
                rca2, lca2, results = mt.prepare_centerlines(rca_cl, lca_cl, results)
        return ao_cl, rca2, lca2, results

    want_prep = prepared("cpu", torch.float64)
    with mt.config.use(device="cpu", dtype=torch.float64):
        want = {b: _tree_parts(mt.discretize_vessel_tree(*want_prep, b_spline=b))
                for b in (False, True)}
    contours, refs = want[False]
    assert contours[0] and contours[1] and contours[2] and refs[2] and refs[3]
    for dtype in (torch.float64, torch.float32):
        prep = prepared(cuda, dtype)
        for key in ("rca_points_main", "lca_points_main", "aorta_points"):
            assert prep[3][key] == want_prep[3][key], key
        for b_spline in (False, True):
            launches = nst.launches
            with mt.config.use(device=cuda, dtype=dtype):
                got = _tree_parts(mt.discretize_vessel_tree(*prep, b_spline=b_spline))
            assert nst.launches == launches + 1  # three walks, one launch
            g_contours, g_refs = got
            w_contours, w_refs = want[b_spline]
            assert [len(s) for s in g_contours] == [len(s) for s in w_contours]
            for gs, ws in zip(g_contours, w_contours):
                for (gi, gp, gx), (wi, wp, wx) in zip(gs, ws):
                    assert gi == wi and gp == wp and np.array_equal(gx, wx)
            assert g_refs == w_refs


# ---------------------------------------------------------------------------
# the ray-triangle kernel and multi-device execution
# ---------------------------------------------------------------------------

def _ray_case(R, F, seed):
    """Rays and faces from a seed, with edge, vertex and parallel rays: the
    first rays aim at a face's vertex, at the middle of its edge, and along
    its plane."""
    rng = np.random.default_rng(seed)
    v0 = rng.normal(0, 2, (F, 3))
    tris = np.stack([v0, v0 + rng.normal(0, 1, (F, 3)), v0 + rng.normal(0, 1, (F, 3))], 1)
    o = rng.normal(0, 3, (R, 3))
    d = rng.normal(0, 1, (R, 3))
    if F and R >= 3:
        d[0] = tris[0, 1] - o[0]  # through a vertex
        d[1] = 0.5 * (tris[1 % F, 0] + tris[1 % F, 2]) - o[1]  # through an edge's middle
        o[2] = tris[0, 0] - (tris[0, 1] - tris[0, 0])
        d[2] = tris[0, 1] - tris[0, 0]  # in the face's plane
    return o, d, tris


@pytest.mark.parametrize("R, F", [(1000, 5000), (1, 300), (37, 0), (257, 1)])
def test_ray_kernel_matches_plain(cuda, R, F):
    """n_hits, closest and the bits of t_min equal the plain version's on
    the card and on the CPU."""
    from multimodars_torch.ops import ray_triangle as rt

    o, d, tris = _ray_case(R, F, seed=R + F)
    args = [torch.tensor(x, dtype=torch.float64, device=cuda) for x in (o, d, tris)]
    launches = rt.launches
    got = rt.ray_hits(*args)
    assert rt.launches == launches + 1
    want = rt.ray_hits_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    cpu = rt.ray_hits_plain(*(a.cpu() for a in args))
    assert torch.equal(got.cpu(), cpu)
    if F:
        assert int(rt.views(got)[0].sum()) > 0 or R < 10


@pytest.mark.parametrize("R, F", [(1, 1), (127, 255), (128, 256), (129, 257), (1000, 5000),
                                  (300, 37905)])
def test_ray_kernel_matches_plain_and_kernel_order(cuda, R, F):
    """Ragged ray groups and face splits: the kernel equals plain and the
    emulation of its work decomposition at the launch's plan, bit for bit,
    in one launch."""
    from multimodars_torch.ops import ray_triangle as rt

    o, d, tris = _ray_case(R, F, seed=7 * R + F)
    args = [torch.tensor(x, dtype=torch.float64, device=cuda) for x in (o, d, tris)]
    launches = rt.launches
    got = rt.ray_hits(*args)
    assert rt.launches == launches + 1
    want = rt.ray_hits_plain(*args)
    ordered, exact = rt.ray_hits_ordered(*args, rt.launch_plan(R, F, cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(ordered, want)
    assert 0 <= exact <= R * F


def _adversarial_args(device):
    import chip_smoke

    with np.errstate(all="ignore"):
        case = chip_smoke.adversarial_ray_case(np)
    return [torch.tensor(x, dtype=torch.float64, device=device) for x in case]


@pytest.mark.parametrize("per_split", [None, 64, 16, 4, 3, 1])
def test_ray_kernel_on_adversarial_rays(cuda, monkeypatch, per_split):
    """The adversarial rays (u, v at 0 and 1 and one ulp off, |a| at 1e-8
    and past 2^900, un underflowing, u = -0.0, degenerate faces, a fan's
    vertex, huge faces) equal plain on the card and on the CPU bit for bit,
    at the card's plan and at face splits that give one merge level (64,
    16 faces) or two (4, 3, 1)."""
    from multimodars_torch.ops import ray_triangle as rt

    args = _adversarial_args(cuda)
    R, F = len(args[0]), len(args[2])
    if per_split is not None:
        p = rt.Plan(-(-R // rt.RAYS_PER_BLOCK), -(-F // per_split), per_split, 1)
        monkeypatch.setattr(rt, "launch_plan", lambda n, m, device: p)
    got = rt.ray_hits(*args)
    want = rt.ray_hits_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), rt.ray_hits_plain(*(a.cpu() for a in args)))
    assert int((rt.views(got)[0] > 0).sum()) > 100


def test_ray_kernel_scratch_resets_between_launches(cuda):
    """Repeated launches, a launch that grows the scratch, and a launch on
    another stream give the same answers: the kernel leaves its tickets at
    0."""
    from multimodars_torch.ops import ray_triangle as rt

    small = [torch.tensor(x, dtype=torch.float64, device=cuda) for x in _ray_case(200, 3000, seed=3)]
    big = [torch.tensor(x, dtype=torch.float64, device=cuda) for x in _ray_case(1000, 9000, seed=4)]
    want_small, want_big = rt.ray_hits_plain(*small), rt.ray_hits_plain(*big)
    launches = rt.launches
    outs = [rt.ray_hits(*small), rt.ray_hits(*small), rt.ray_hits(*big), rt.ray_hits(*small)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs.append(rt.ray_hits(*small))
    side.synchronize()
    torch.cuda.synchronize()
    assert rt.launches == launches + 5
    for out, want in zip(outs, (want_small, want_small, want_big, want_small, want_small)):
        assert torch.equal(out, want)


def test_occlusion_rays_take_the_kernel_on_the_card_above_the_threshold(cuda):
    """On the card the occlusion pass's rays take the kernel in one launch
    above the threshold and the native grid DDA at or below it, with the
    same (n_hits, closest) as the CPU's native route."""
    from multimodars_torch.ccta import kernels as ck
    from multimodars_torch.ops import ray_triangle as rt

    o, d, tris = _ray_case(1300, 1000, seed=4)
    assert len(o) * len(tris) > ck._RAY_NATIVE_THRESHOLD["cuda"]
    with mt.config.use(device="cpu"):
        launches = rt.launches
        want = ck.ray_occlusion(o, d, tris)
        assert rt.launches == launches
    with mt.config.use(device=cuda):
        got = ck.ray_occlusion(o, d, tris)
        assert rt.launches == launches + 1
        below = ck.ray_occlusion(o[:100], d[:100], tris)
        assert rt.launches == launches + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(below, want):
        np.testing.assert_array_equal(g, w[:100])


def test_ray_kernel_refuses_float32(cuda):
    from multimodars_torch.ops import ray_triangle as rt

    o, d, tris = _ray_case(8, 8, seed=1)
    args = [torch.tensor(x, dtype=torch.float32, device=cuda) for x in (o, d, tris)]
    with pytest.raises(ValueError, match="float64"):
        rt.ray_hits(*args)


def _oct_sets(F=24, N=120, seed=3):
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * math.pi, N, endpoint=False)
    pts = []
    for _ in range(F + 1):
        a, b, rot = 2.0 + 0.2 * rng.standard_normal(), 1.4 + 0.2 * rng.standard_normal(), rng.uniform(-0.4, 0.4)
        x, y = a * np.cos(th), b * np.sin(th)
        pts.append(np.stack([x * math.cos(rot) - y * math.sin(rot),
                             x * math.sin(rot) + y * math.cos(rot)], -1))
    pts = np.asarray(pts)
    mask = np.ones(pts.shape[:2], bool)
    return pts[1:], pts[:-1], mask[1:], mask[:-1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_four_shards_of_one_card_equal_one(cuda, dtype):
    """The cohort, the angle-sharded search and the row-sharded count on a
    mesh naming cuda:0 four times (one stream a shard) equal one shard bit
    for bit, every shard launching its own kernels."""
    from multimodars_torch import parallel
    from multimodars_torch.ccta import kernels as ck
    from multimodars_torch.ops import radius_count as rc

    test, ref, tm, rm = _oct_sets()
    one, four = [cuda], [cuda] * 4
    with mt.config.use(device=cuda, dtype=dtype):
        launches = sweep.launches
        c4 = parallel.cohort_relative_rotations(test, ref, tm, rm, 0.5, 20.0,
                                                parallel.cohort_mesh(four))
        assert sweep.launches >= launches + 4
        c1 = parallel.cohort_relative_rotations(test, ref, tm, rm, 0.5, 20.0,
                                                parallel.cohort_mesh(one))
        np.testing.assert_array_equal(c4, c1)
        for brute in (False, True):
            a4 = parallel.sharded_multires_search(test, ref, tm, rm, 0.1, 6.0,
                                                  parallel.angle_mesh(four), brute)
            a1 = parallel.sharded_multires_search(test, ref, tm, rm, 0.1, 6.0,
                                                  parallel.angle_mesh(one), brute)
            np.testing.assert_array_equal(a4, a1)
        rng = np.random.default_rng(9)
        a, b = rng.normal(0, 3, (5000, 3)), rng.normal(0, 3, (7000, 3))
        launches = rc.launches
        n4 = parallel.sharded_count_within_radius(a, b, 1.0, parallel.rows_mesh(four))
        assert rc.launches == launches + 4
        n1 = parallel.sharded_count_within_radius(a, b, 1.0, parallel.rows_mesh(one))
        np.testing.assert_array_equal(n4, n1)
        np.testing.assert_array_equal(n1, ck._count_rows_exact_dense(a, b, 1.0))
