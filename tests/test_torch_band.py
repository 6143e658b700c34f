"""The float32 certification bands of the port, held against the float32
arithmetic that makes each table.

The rotation sweep's table (``csrc/sweep_cost.cu``) is emulated in numpy
float32, op for op: the f64 angle and points cast to f32, ``cosf`` /
``sinf`` pushed with ``np.nextafter`` to the far end of their documented
2-ulp error (in each direction), the rotation's products and sum or
difference each rounded, ``dx`` / ``dy``, and ``fma(dx, dx, dy*dy)`` as an
exact product and sum rounded once (or the plain version's unfused
``dx*dx + dy*dy``).  The plain versions of the sweep, the refine table, the
nearest pick and the morph sweep run in float32 on this CPU as they are.
Each is held against its float64 twin on seeded sets: every entry within
the derived bound of ``ops/rotation_search.py`` (or of the module that owns
the band), every float32 / float64 argmin swap inside the band, and the
cases the bands of earlier checkouts left unflagged pinned.
"""

import math

import numpy as np
import pytest
import torch

import multimodars_torch as mt
from multimodars_torch.ccta import kernels as ck
from multimodars_torch.ops import hausdorff_batch as hb
from multimodars_torch.ops import morph_sweep as ms
from multimodars_torch.ops import nearest as nn_op
from multimodars_torch.ops import rotation_search as rs
from multimodars_torch.ops import sweep
from multimodars_torch.pipelines import centerline_align as ca

EPS = 2.0 ** -23
F32, F64 = np.float32, np.float64
# the old band: 8 units of eps32·(sqrt(scale2·m) + m), no floor
OLD_TIE_C = 8.0
# (cos push, sin push): -1 / +1 pushes the value to the far end of its
# 2-ulp error below / above, 0 leaves it rounded to nearest
PUSHES = ((0, 0), (-1, -1), (1, 1), (-1, 1), (1, -1))
RADII = (0.5, 2.0, 10.0)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


# ---------------------------------------------------------------------------
# the emulation of csrc/sweep_cost.cu in numpy float32
# ---------------------------------------------------------------------------

def _ulp32(exact):
    """The f32 ulp of the binade holding ``exact`` (f64)."""
    a = np.abs(exact)
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 23), 2.0 ** -149)


def _pushed(exact, sign, ulps=2):
    """The f32 value farthest from ``exact`` in direction ``sign`` that is
    still within ``ulps`` ulp of it (``sign`` 0: rounded to nearest)."""
    v = exact.astype(F32)
    if sign == 0:
        return v
    lim = ulps * _ulp32(exact)
    for _ in range(2 * ulps + 2):
        w = np.nextafter(v, F32(sign * np.inf))
        v = np.where(np.abs(w.astype(F64) - exact) <= lim, w, v)
    return v


def _fma32(a, b, c):
    """f32 ``a*b + c`` rounded once: the product is exact in f64, the sum's
    f64 rounding error is carried (TwoSum) to settle f32 midpoints."""
    p = a.astype(F64) * b.astype(F64)
    c64 = c.astype(F64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r1 = s.astype(F32)
    toward = np.where(s > r1.astype(F64), F32(np.inf), F32(-np.inf)).astype(F32)
    r2 = np.nextafter(r1, toward)
    mid = (r1.astype(F64) + r2.astype(F64)) / 2 == s
    hi, lo = np.maximum(r1, r2), np.minimum(r1, r2)
    return np.where(mid & (err > 0), hi, np.where(mid & (err < 0), lo, r1))


def _hausdorff(d2):
    return np.maximum(d2.min(-1).max(-1), d2.min(-2).max(-1))


def table32(test, ref, theta, push=(0, 0), fused=True):
    """The kernel's f32 cost table [F, K] of f64 ``test [F, N, 2]``, ``ref
    [F, M, 2]`` and angles ``theta [F, K]``, emulated (every slot valid)."""
    th = theta.astype(F32).astype(F64)
    c = _pushed(np.cos(th), push[0])[..., None]
    s = _pushed(np.sin(th), push[1])[..., None]
    t = test.astype(F32)[:, None]
    q = ref.astype(F32)[:, None]
    rx = t[..., 0] * c - t[..., 1] * s
    ry = t[..., 0] * s + t[..., 1] * c
    dx = rx[..., :, None] - q[..., 0][..., None, :]
    dy = ry[..., :, None] - q[..., 1][..., None, :]
    d2 = _fma32(dx, dx, dy * dy) if fused else dx * dx + dy * dy
    return _hausdorff(d2).astype(F64)


def table64(test, ref, theta):
    """The same table in f64."""
    c = np.cos(theta)[..., None]
    s = np.sin(theta)[..., None]
    t, q = test[:, None], ref[:, None]
    rx = t[..., 0] * c - t[..., 1] * s
    ry = t[..., 0] * s + t[..., 1] * c
    dx = rx[..., :, None] - q[..., 0][..., None, :]
    dy = ry[..., :, None] - q[..., 1][..., None, :]
    return _hausdorff(dx * dx + dy * dy)


def scale2_32(test, ref):
    """``_point_scale2`` of the f32 sets, as the f32 search computes it."""
    return rs._point_scale2(torch.tensor(test, dtype=torch.float32),
                            torch.tensor(ref, dtype=torch.float32)).double().numpy()


def ties(costs32, scale2, tie_c=None):
    """The f32 search's tie flags of a table (``tie_c``: the old band)."""
    c = torch.tensor(costs32, dtype=torch.float32)
    m = c.amin(dim=1)
    s2 = torch.tensor(scale2, dtype=torch.float32)
    if tie_c is None:
        return rs._tie_flags(c, m, s2, torch.ones(len(m), dtype=torch.bool)).numpy()
    band = tie_c * F32(EPS) * (torch.sqrt(torch.clamp(s2 * m, min=0.0)) + m)
    return ((c <= (m + band)[:, None]).sum(dim=1) > 1).numpy()


def grid(center, step_deg, range_deg, F):
    a, v = rs.candidate_angles(torch.full((F,), center, dtype=torch.float64),
                               step_deg, range_deg, 180.0)
    a, v = a.numpy(), v.numpy()
    keep = v.all(axis=0)
    return a[:, keep]


def _turn(p, a):
    c, s = math.cos(a), math.sin(a)
    return p @ np.array([[c, s], [-s, c]])


def quarter_set(radius):
    """The 16-point set congruent under a quarter turn of
    tests/test_torch_parallel.py, scaled to ``radius``."""
    th = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    r = radius * (1 + 0.3 * np.cos(4 * th)) / 1.3
    return np.stack([np.cos(th) * r, np.sin(th) * r], -1)


def family(radius):
    """Seeded adversarial (test, ref) batches at point radius ``radius``:
    20-point catheter rings with noise, the test ring turned by a multiple
    of 18 degrees (near-ties a whole symmetry apart), and the quarter-turn
    set against itself and its 1.01 scaling."""
    rng = np.random.default_rng(int(radius * 1000) + 5)
    th = np.linspace(0, 2 * np.pi, 20, endpoint=False)
    ring = radius * np.stack([np.cos(th), np.sin(th)], -1)
    out = []
    for noise in (1e-6, 1e-5):
        refs, tests = [], []
        for _ in range(6):
            r = ring + rng.normal(0, noise * radius, ring.shape)
            refs.append(r)
            turn = 2 * np.pi * rng.integers(0, 20) / 20
            tests.append(_turn(r, turn) + rng.normal(0, noise * radius, r.shape))
        out.append((np.stack(tests), np.stack(refs)))
    sq = quarter_set(radius)
    out.append((np.stack([sq, sq * 1.01, sq]), np.stack([sq, sq, sq])))
    return out


# the coarse ladder stage over +-180 degrees and a fine grid across +-pi
GRIDS = ((0.0, 1.0, 180.0), (math.pi - 0.01, 0.01, 3.0))


def family_tables(radius):
    """Every (f64 table, scale2, [f32 tables by push and fusion]) of the
    family at ``radius`` on both grids."""
    out = []
    for test, ref in family(radius):
        s2 = scale2_32(test, ref)
        for g in GRIDS:
            theta = grid(*g, test.shape[0])
            t64 = table64(test, ref, theta)
            t32 = [table32(test, ref, theta, p) for p in PUSHES]
            t32.append(table32(test, ref, theta, (0, 0), fused=False))
            out.append((test, ref, theta, t64, s2, t32))
    return out


_TABLES = {}


def tables_at(radius):
    if radius not in _TABLES:
        _TABLES[radius] = family_tables(radius)
    return _TABLES[radius]


# ---------------------------------------------------------------------------
# the rotation sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", RADII)
def test_sweep_entries_within_derived_bound(radius):
    """(a) Every entry of every emulated f32 table, and of the plain
    version's f32 table on this CPU, lies within the derived bound of its
    f64 twin."""
    worst = 0.0
    for test, ref, theta, t64, s2, t32s in tables_at(radius):
        bound = rs._f32_error_bound(t64, s2[:, None])
        plain = sweep.cost_table_plain(
            torch.tensor(test, dtype=torch.float32), torch.tensor(ref, dtype=torch.float32),
            None, None, torch.tensor(theta, dtype=torch.float32),
            torch.ones(theta.shape, dtype=torch.bool), dense=True,
        ).double().numpy()
        for t32 in t32s + [plain]:
            ratio = np.abs(t32 - t64) / bound
            worst = max(worst, float(ratio.max()))
    assert 0.0 < worst <= 1.0, worst


def test_one_entry_exceeds_half_the_old_band():
    """(b) A one-point table entry (cost = d2) at r = 10 mm, d 1-100 um,
    with the angle near pi at its largest f32 cast error: its emulated
    error exceeds 4 units of eps32·(r·sqrt(c) + c), half of the old
    two-sided 8, so two candidates that differ by 8 units could swap; it
    stays within the derived bound."""
    rng = np.random.default_rng(1)
    n = 4000
    th = (math.pi - rng.uniform(0, 0.9, n)).astype(F32)
    theta = th.astype(F64) + rng.choice([-1, 1], n) * 0.4999 * np.spacing(th).astype(F64)
    phi = rng.uniform(0, 2 * np.pi, n)
    test = 10.0 * np.stack([np.cos(phi), np.sin(phi)], -1)[:, None]
    c, s = np.cos(theta), np.sin(theta)
    rot = np.stack([test[:, 0, 0] * c - test[:, 0, 1] * s,
                    test[:, 0, 0] * s + test[:, 0, 1] * c], -1)
    d = 10 ** rng.uniform(-3, -1, n)
    psi = rng.uniform(0, 2 * np.pi, n)
    ref = (rot + d[:, None] * np.stack([np.cos(psi), np.sin(psi)], -1))[:, None]
    t64 = table64(test, ref, theta[:, None])[:, 0]
    s2 = scale2_32(test, ref)
    unit = EPS * (np.sqrt(s2 * t64) + t64)
    worst = 0.0
    for push in PUSHES:
        err = np.abs(table32(test, ref, theta[:, None], push)[:, 0] - t64)
        assert (err <= rs._f32_error_bound(t64, s2)).all()
        worst = max(worst, float((err / unit).max()))
    assert worst > OLD_TIE_C / 2, worst


@pytest.mark.parametrize("radius", RADII)
def test_sweep_order_swaps_are_flagged(radius):
    """(c) Wherever an emulated f32 table's first-wins argmin differs from
    the f64 table's, the new band flags the search."""
    swaps = 0
    for _test, _ref, _theta, t64, s2, t32s in tables_at(radius):
        w64 = t64.argmin(axis=1)
        for t32 in t32s:
            swapped = t32.argmin(axis=1) != w64
            swaps += int(swapped.sum())
            assert ties(t32, s2)[swapped].all()
    assert swaps > 0


def diagonal_quarter_set():
    """Four points on the diagonals at (+-1.6, +-1.6): a quarter turn by
    the f64 grid angle of -90 degrees maps the set onto itself exactly in
    f64 (1.6 cos(-pi/2) = 9.8e-17 is under half an ulp of 1.6), so the f64
    table ties at 0 at -90, 0 and 90 degrees and first-wins takes -90; in
    f32 1.6 cosf(-pi/2) = 7.0e-8 is over half an ulp, and only the turn by 0
    is exact."""
    v = 1.6
    return np.array([[v, v], [-v, v], [-v, -v], [v, -v]])


def test_congruent_set_swap_missed_by_the_old_band():
    """(c) The pinned case: the f32 table's winner is 0 degrees at cost
    exactly 0, the f64 winner -90 degrees; the old band (no floor, 0 at a
    zero cost) leaves the search unflagged, the new band's floor flags it,
    and the f32 search through the plain table, then the repair, lands on
    the f64 grid angle."""
    sq = diagonal_quarter_set()[None]
    theta = grid(0.0, 1.0, 180.0, 1)
    t64 = table64(sq, sq, theta)
    s2 = scale2_32(sq, sq)
    k64 = int(t64.argmin())
    assert t64[0, k64] == 0.0 and math.isclose(math.degrees(theta[0, k64]), -90.0)
    # cos and sin rounded to nearest: what cosf / sinf and the CPU's
    # torch.cos / torch.sin return at 0 and -pi/2 (a cosf 2 ulp off at 0
    # would make no turn exact and the f32 minimum nonzero)
    for fused in (True, False):
        t32 = table32(sq, sq, theta, (0, 0), fused)
        assert t32.min() == 0.0 and int(t32.argmin()) != k64
        assert not ties(t32, s2, OLD_TIE_C)[0]
        assert ties(t32, s2)[0]
    pts = torch.tensor(sq)
    with mt.config.use(dtype=torch.float32):
        best, tie = rs.multires_rotation_search(pts.float(), pts.float(), None, None,
                                                1.0, 180.0, dense=True)
        assert bool(tie[0]) and float(best[0]) != float(theta[0, k64])
        from multimodars_torch.ops import argmin_repair

        fixed = argmin_repair.repair_sets(best.numpy(), tie.numpy(), lambda i: (sq[0], sq[0]),
                                          1.0, 180.0, True)
    best64, _ = rs.multires_rotation_search(pts, pts, None, None, 1.0, 180.0, dense=True)
    assert fixed[0] == float(best64[0]) == float(theta[0, k64])


def zero_cost_prune_set(s0, device="cpu", n=132):
    """A set whose f32 pruned stage (step 1 degree, +-180) finds an
    evaluated cost of exactly 0 while the f64 winner sits unevaluated at a
    lower grid index.  Its points: ``s0`` and its turns by +1 ... +11
    degrees as the plain f32 sweep rounds them on ``device`` (so the
    strided outer set ``s0`` lands on them exactly: twelve lower bounds of
    exactly 0 at 0 ... 11 degrees, whose exact costs are not near 0), the
    four quarter turns of those (each coordinate in [1, 1.8), where a turn
    by the f64 grid's -90 degrees is exact in f64 but, for |x| > 1.37, not
    in f32) and the origin.  ``test`` holds ``s0`` at every 6th row, ``ref``
    the origin (the lower bound's outer rows), both the same point set.
    Returns (test [1, n, 2], ref [1, n, 2], angles, valid), f64 numpy /
    torch."""
    angles, valid = rs.candidate_angles(torch.zeros(1, dtype=torch.float64), 1.0, 180.0, 180.0)
    th = angles.to(device=device, dtype=torch.float32).T
    c, s = torch.cos(th)[:, 0].cpu(), torch.sin(th)[:, 0].cpu()
    x, y = torch.tensor(s0, dtype=torch.float32)
    k0 = int(torch.nonzero(angles[0] == 0.0)[0])
    q = np.array([[float(x * c[k]- y * s[k]), float(x * s[k] + y * c[k])]
                  for k in range(k0, k0 + 12)])
    pts = np.concatenate([q, q[:, ::-1] * [1, -1], -q, q[:, ::-1] * [-1, 1], [[0.0, 0.0]]])
    test = np.array([pts[0] if i % 6 == 0 else pts[1 + (i - 1 - i // 6) % (len(pts) - 1)]
                     for i in range(n)])
    ref = np.array([pts[-1] if i % 6 == 0 else pts[(i - 1 - i // 6) % len(pts)]
                    for i in range(n)])
    return test[None], ref[None], angles, valid


# f32 points of coordinates in [1, 1.8): the first whose construction on
# this platform's cosf / sinf has the properties the test needs is taken
ZERO_COST_SEEDS = ((1.5, 1.25), (1.46, 1.25), (1.42, 1.25), (1.52, 1.15), (1.4, 1.1))


def zero_cost_prune_case(device="cpu"):
    """The first ``zero_cost_prune_set`` of ``ZERO_COST_SEEDS`` with: at
    least 13 f32 lower bounds within the band's floor, the f64 winner among
    them but not among the 12 the stage evaluates, and an evaluated f32
    cost of exactly 0 (and which set failed how, where none has).  Returns
    (test, ref, angles, valid, f64 winner index) or None."""
    for s0 in ZERO_COST_SEEDS:
        test, ref, angles, valid = zero_cost_prune_set(s0, device)
        assert {tuple(p) for p in test[0]} == {tuple(p) for p in ref[0]}
        t32, r32 = (torch.tensor(v, dtype=torch.float32, device=device) for v in (test, ref))
        a32, v = angles.to(device=device, dtype=torch.float32), valid.to(device)
        lb = rs._lb_cost_table(t32, r32, None, None, a32, v, rs._PRUNE_STRIDE, True)[0].cpu()
        exact = sweep.cost_table(t32, r32, None, None, a32, v, dense=True)[0].cpu()
        t64 = sweep.cost_table_plain(torch.tensor(test), torch.tensor(ref), None, None,
                                     angles, valid, dense=True)[0]
        w64 = int(t64.argmin())
        floor = rs._TIE_FLOOR_F32 * EPS * EPS * float(rs._point_scale2(t32, r32)[0])
        sel = torch.sort(lb, stable=True).indices[:rs._PRUNE_TOP]
        if (int((lb <= floor).sum()) >= 13 and float(lb[w64]) <= floor
                and w64 not in sel.tolist() and float(exact[sel].min()) == 0.0):
            return test, ref, angles, valid, w64
    return None


def test_zero_cost_certificate_of_the_pruned_stage():
    """C.4 (a): the f32 pruned stage evaluates a cost of exactly 0 while the
    f64 winner, a lower-index exact zero in f64, is left unevaluated with
    its lower bound inside the band's floor.  The zero-cost clause of
    earlier checkouts certified the f32 answer unflagged; now the stage
    falls back to the full sweep, whose band flags the near-zero winner,
    and the repair lands on the f64 grid angle.  In f64 the clause is the
    JAX package's: the stage certifies its zero-cost winner."""
    case = zero_cost_prune_case()
    assert case is not None, "no seed of ZERO_COST_SEEDS builds the case"
    test, ref, angles, valid, w64 = case
    centers = torch.zeros(1, dtype=torch.float64)
    want = float(angles[0, w64])
    assert math.isclose(math.degrees(want), -90.0)
    before = dict(rs.prune_stats)
    best, tie = rs.search_range_batched_pruned(
        torch.tensor(test, dtype=torch.float32), torch.tensor(ref, dtype=torch.float32),
        None, None, 1.0, 180.0, centers, 180.0, dense=True)
    assert float(best[0]) == want or bool(tie[0])
    assert bool(tie[0]) and rs.prune_stats["fallbacks"] == before["fallbacks"] + 1
    from multimodars_torch.ops import argmin_repair

    fixed = argmin_repair.repair_sets(best.numpy(), tie.numpy(),
                                      lambda i: (test[0], ref[0]), 1.0, 180.0, True)
    assert fixed[0] == want
    before = dict(rs.prune_stats)
    best64, _ = rs.search_range_batched_pruned(
        torch.tensor(test), torch.tensor(ref), None, None, 1.0, 180.0, centers, 180.0,
        dense=True)
    assert float(best64[0]) == want and rs.prune_stats == dict(
        before, stages=before["stages"] + 1)


def test_band_constants_cover_the_derivation():
    """The constants of each band against the figures of its derivation;
    the float64 bands stay the JAX package's."""
    a = 1 + 2 + (1 + math.sqrt(2)) / 2 + 1
    A, B, E = rs._F32_ERR_A, rs._F32_ERR_B, rs._F32_ERR_E
    assert A >= 2 * a * (1 + 1e-5) and B >= 2 * (1 + 1e-5) and E >= a * a + A * A / 4
    assert rs._TIE_C[torch.float32] >= 2 * A + 1 and rs._TIE_C[torch.float32] >= 2 * B
    assert rs._TIE_FLOOR_F32 >= 2 * A * (A + math.sqrt(E)) + 2 * E
    assert rs._TIE_C[torch.float64] == 8.0 and rs._eps_eff(torch.float64) == 1e-14
    m = torch.tensor([0.0, 0.25, 4.0], dtype=torch.float64)
    s2 = torch.tensor([1.0, 9.0, 100.0], dtype=torch.float64)
    torch.testing.assert_close(rs._band(m, s2), 8.0 * 1e-14 * (torch.sqrt(s2 * m) + m),
                               rtol=0.0, atol=0.0)
    # the refine: A = B = 2.01, E = 1 + 1.01
    assert ca._REFINE_C >= 2 * 2.01 and ca._REFINE_FLOOR_F32 >= 2 * 2.01 * (2.01 + math.sqrt(2.1)) + 4.2
    # the pick: A = 2 sqrt(3), B = 2.5, E = 3 + A^2 / 4
    Ap, Ep = 3.47, 3.0 + 3.47 ** 2 / 4
    assert 24.0 >= 2 * Ap and 10.0 >= 2 * 2.51
    assert ck._PICK_FLOOR_F32 >= 2 * Ap * (Ap + math.sqrt(Ep)) + 2 * Ep
    # the morph sweep: 6.84 delta, delta = (sqrt(3) / 2)(3c + 8)
    for c in (0.5, 5.0, 50.0, 500.0):
        assert ck._SWEEP_C_F32 * c + ck._SWEEP_X_F32 >= 6.84 * math.sqrt(3) / 2 * (3 * c + 8)


# ---------------------------------------------------------------------------
# the refine table (csrc/hausdorff_batch.cu: unfused d2, host f64 inputs)
# ---------------------------------------------------------------------------

def refine_sets(seed):
    """A refine-like grid: K candidate rings of 40 points turned by 0.1
    degree steps around (60, -40) mm against one 300-point noisy cloud."""
    rng = np.random.default_rng(seed)
    K = 31
    th = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    ring = np.stack([1.8 * np.cos(th), 1.5 * np.sin(th)], -1)
    centre = np.array([60.0, -40.0])
    p = np.stack([_turn(ring, math.radians(0.1 * (k - 15))) for k in range(K)]) + centre
    a = rng.uniform(0, 2 * np.pi, 300)
    q = (np.stack([1.8 * np.cos(a), 1.5 * np.sin(a)], -1) + centre
         + rng.normal(0, 10 ** rng.uniform(-6, -2), (300, 2)))
    return p, q[None]


@pytest.mark.parametrize("seed", range(3))
def test_refine_entries_within_band(seed):
    """(d) The refine table's plain version (bit for bit the kernel's) in
    f32 against f64: every entry within eps·(2.01 R d + 2.01 d^2) + 2.1
    eps^2 R^2, and every f32 / f64 argmin swap inside the band."""
    p, q = refine_sets(seed)
    K = p.shape[0]
    pm = np.ones(p.shape[:2], bool)
    qm = np.ones(q.shape[:2], bool)

    def table(dtype):
        return hb.hausdorff_sq_shared_ref_plain(
            torch.tensor(p, dtype=dtype), torch.tensor(pm), torch.tensor(q, dtype=dtype),
            torch.tensor(qm), K).double().numpy()

    t32, t64 = table(torch.float32), table(torch.float64)
    R2 = max(float((p * p).sum(-1).max()), float((q * q).sum(-1).max()))
    bound = EPS * (2.01 * np.sqrt(R2 * t64) + 2.01 * t64) + 2.1 * EPS * EPS * R2
    assert (np.abs(t32 - t64) <= bound).all()
    band = ca._refine_band(t32, torch.float32, R2)
    if t32.argmin() != t64.argmin():
        assert t32[t64.argmin()] <= band
    # every candidate the f64 order puts at or before the f32 winner's cost
    assert (t32[t64 <= t64[t32.argmin()]] <= band).all()


# ---------------------------------------------------------------------------
# the CCTA pick and sweep
# ---------------------------------------------------------------------------

def test_pick_of_near_duplicate_points_is_redecided():
    """Two reference points under an f32 ulp apart at x ~ 100 mm: the row
    casts onto the first one exactly (f32 m1 = 0), while in f64 the second
    one is nearer.  The old band (0 at m1 = 0) leaves the f32 pick; the
    float32 floor flags the row and the exact host pick takes the f64
    answer."""
    ulp = float(np.spacing(F32(100.0)))
    b = np.array([[-200.0, -1.0, -1.0], [100.0 - 0.49 * ulp, 0.0, 0.0],
                  [100.0 + ulp, 0.0, 0.0], [200.0, 1.0, 1.0]])
    a = np.array([[100.0 + 0.49 * ulp, 0.0, 0.0]])
    (ac, bc), maxc = ck._centred(a, b)
    m1, idx, m2 = nn_op.nearest_plain(torch.tensor(ac, dtype=torch.float32),
                                      torch.tensor(bc, dtype=torch.float32))
    m1, m2 = float(m1[0]), float(m2[0])
    assert int(idx[0]) == 1 and m1 == 0.0
    old = (24.0 * math.sqrt(m1) * maxc + 10.0 * m1) * EPS
    assert m2 - m1 > old
    with mt.config.use(dtype=torch.float32):
        ck.reset_stats()
        (_, got32), = ck.min_sqdist_pairs([(a, b)])
        assert ck.stats["nearest"]["flagged"] == 1
    (_, got64), = ck.min_sqdist_pairs([(a, b)])
    assert int(got32[0]) == int(got64[0]) == 2


def morph_case(seed, gap):
    """A morph sweep whose reference is the points moved by ``gap`` past
    an offset: the costs of that offset and the next tie near ``gap`` (a
    small minimum over a 60 mm extent)."""
    rng = np.random.default_rng(seed)
    n = 200
    t = np.linspace(-30.0, 30.0, n)
    pts = np.stack([t, rng.normal(0, 0.5, n) + 0.1 * t, rng.normal(0, 0.5, n)], -1)
    unit = rng.normal(size=(n, 3))
    unit /= np.linalg.norm(unit, axis=1)[:, None]
    ref = pts + unit * (0.3 + gap) + rng.normal(0, 1e-7, (n, 3))
    return pts, unit, ref


@pytest.mark.parametrize("gap", [0.05, 1e-3])
def test_morph_sweep_costs_within_band(gap):
    """The morph sweep's f32 costs (the kernel's summation order) against
    f64: each within half the f32 band's absolute term plus the relative
    one, and the f32 finish takes the f64 finish's offset."""
    pts, unit, ref = morph_case(3, gap)
    xs = ck._sweep_offsets()
    (pc, rc), maxc = ck._centred(pts, ref)

    def costs(dtype):
        f, b = ms.morph_sweep_ordered(*(torch.tensor(v, dtype=dtype) for v in (pc, unit, rc, xs)))
        return np.sqrt((f.double().numpy() / len(pc) + b.double().numpy() / len(rc)) / 2)

    c32, c64 = costs(torch.float32), costs(torch.float64)
    delta = math.sqrt(3) / 2 * (3 * maxc + 8)
    L = -(-len(pc) // 128) + 7
    one_sided = EPS * (2 + math.sqrt(2)) * delta + (2.51 + L / 2) * EPS * c64
    assert (np.abs(c32 - c64) <= one_sided).all()
    assert 2 * one_sided.min() <= EPS * (ck._SWEEP_C_F32 * maxc + ck._SWEEP_X_F32) \
        + 2.0 * c32.min() * 1e-4
    state = ("device", xs, pts, unit, ref, pc, rc)
    with mt.config.use(dtype=torch.float32):
        x32 = ck._sweep_finish(state, c32)
    assert x32 == ck._sweep_finish(state, c64)
