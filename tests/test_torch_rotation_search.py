"""The port's rotation search (multimodars_torch.ops.rotation_search) and
argmin repair against the JAX package, on the same float64 numpy inputs.

Angles must agree to 1e-12 rad and tie flags exactly: both packages build
the same grids, evaluate the same cost tables (to the last ulps) and decide
the same first-wins argmins; ulp-level near-ties are flagged by both and
re-decided in exact host f64.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import multimodars_torch as mt
from multimodars_torch.ops import argmin_repair as t_repair
from multimodars_torch.ops import rotation_search as t_rs
from multimodars_torch.ops import sweep
from multimodars_tpu.ops import argmin_repair as j_repair
from multimodars_tpu.ops import rotation_search as j_rs


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


_N_SYM = 72  # 5-degree symmetry


def _sym_circle(r=2.0):
    th = np.linspace(0.0, 2 * math.pi, _N_SYM, endpoint=False)
    return np.stack([r * np.cos(th), r * np.sin(th)], -1)


def _rot(pts, deg):
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.stack(
        [pts[:, 0] * c - pts[:, 1] * s, pts[:, 0] * s + pts[:, 1] * c], -1
    )


def _wobbly(n=64, seed=0):
    rng = np.random.default_rng(seed)
    th = np.linspace(0.0, 2 * math.pi, n, endpoint=False)
    r = 2.0 + 0.4 * np.abs(rng.standard_normal(n))
    return np.stack([r * np.cos(th), r * np.sin(th)], -1)


def _contour_chain(F=5, n=150, seed=0, turn=0.04):
    """[F, n, 2] centered lumen-like contours, each rotated by up to
    ``turn`` rad from the last (an OCT-like chain: asymmetric, smooth,
    slowly turning).  The default turns stay well inside the +/-6 deg
    window, away from its limes (see test_limes_boundary_follows_host_grid)."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0.0, 2 * math.pi, n, endpoint=False)
    frames, rot = [], 0.0
    for f in range(F):
        rot += rng.uniform(-turn, turn)
        a, b = 2.0 + 0.2 * math.sin(f / 3.0), 1.4 + 0.2 * math.cos(f / 4.0)
        w = 0.08 * np.sin(5 * th + f / 5.0)
        x, y = (a + w) * np.cos(th), (b + w) * np.sin(th)
        pts = np.stack([x * math.cos(rot) - y * math.sin(rot),
                        x * math.sin(rot) + y * math.cos(rot)], -1)
        frames.append(pts - pts.mean(axis=0))
    return np.stack(frames)


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize(
    "centers, step, rng_deg, limes",
    [
        ([0.0, 0.0], 1.0, 90.0, 90.0),
        ([0.01, -0.03], 0.1, 5.0, 6.0),
        ([0.1, -0.1, 0.0], 0.01, 0.1, 6.0),
        ([0.1, -0.1], 0.5, 5.0, 6.0),  # clamped at the limes
        ([0.2, -0.2], 0.5, 5.0, 6.0),  # window beyond the limes: collapsed
        ([0.0], 0.0, 5.0, 6.0),  # step 0: one slot
    ],
)
def test_candidate_angles_match_jax(centers, step, rng_deg, limes):
    c = np.asarray(centers, dtype=np.float64)
    a_t, v_t = t_rs.candidate_angles(torch.tensor(c), step, rng_deg, limes)
    a_j, v_j = j_rs.candidate_angles(jnp.asarray(c), step, rng_deg, limes)
    np.testing.assert_array_equal(_np(v_t), _np(v_j))
    np.testing.assert_allclose(_np(a_t), _np(a_j), rtol=0.0, atol=1e-12)


def test_normalize_angle_is_a_floor_mod():
    a = torch.tensor([-7.0, -math.pi, 0.0, math.pi, 7.0], dtype=torch.float64)
    got = _np(t_rs._normalize_angle(a))
    want = _np(j_rs._normalize_angle(jnp.asarray(_np(a))))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-15)
    assert (got >= -math.pi).all() and (got < math.pi).all()


def _stage_inputs(kind, seed=0):
    if kind == "contours":
        chain = _contour_chain(4, 150, seed)
        return chain[1:], chain[:-1]
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3, 150, 2)), rng.standard_normal((3, 150, 2))


def _count_tables(monkeypatch):
    calls = []
    orig = sweep.cost_table

    def counted(*a, **k):
        calls.append(k.get("outer_stride_test", 1))
        return orig(*a, **k)

    monkeypatch.setattr(sweep, "cost_table", counted)
    return calls


@pytest.mark.parametrize(
    "kind, n_tables", [("contours", 2), ("noise", 3)]
)  # certified (lb + top-T) / certificate fails (+ full fallback)
@pytest.mark.parametrize("dense", [True, False])
def test_stages_match_jax(kind, n_tables, dense, monkeypatch):
    test, ref = _stage_inputs(kind)
    F = test.shape[0]
    mask = np.ones(test.shape[:2], bool)
    mask[:, -3:] = not dense  # masked: hide nothing in dense, keep all else
    centers = np.array([0.01, -0.02, 0.0])[:F]
    tt, tr = torch.tensor(test), torch.tensor(ref)
    tm = None if dense else torch.tensor(mask)
    jt, jr, jm = jnp.asarray(test), jnp.asarray(ref), jnp.asarray(mask)
    args = (0.1, 5.0)
    for pruned in (False, True):
        calls = _count_tables(monkeypatch)
        fn_t = t_rs.search_range_batched_pruned if pruned else t_rs.search_range_batched
        fn_j = j_rs.search_range_batched_pruned if pruned else j_rs.search_range_batched
        b_t, tie_t = fn_t(tt, tr, tm, tm, *args, torch.tensor(centers), 6.0, dense=dense)
        if pruned:
            b_j, tie_j = fn_j(jt, jr, jm, jm, *args, jnp.asarray(centers), 6.0, dense)
            assert len(calls) == n_tables and calls[0] == 6
        else:
            b_j, tie_j = fn_j(jt, jr, jm, jm, *args, jnp.asarray(centers), 6.0,
                              False, dense)
            assert calls == [1]
        np.testing.assert_allclose(_np(b_t), _np(b_j), rtol=0.0, atol=1e-12)
        np.testing.assert_array_equal(_np(tie_t), _np(tie_j))
        monkeypatch.undo()


@pytest.mark.parametrize(
    "step, rng_deg, bruteforce",
    [(0.5, 10.0, False), (0.01, 6.0, False), (1.0, 30.0, True), (0.1, 10.0, True)],
)
@pytest.mark.parametrize("dense", [True, False])
def test_chain_pack_matches_jax(step, rng_deg, bruteforce, dense):
    """``chain_rotation_search``'s [3(F-1)] layout: angles | tie codes |
    final-stage centers, equal to the JAX package's."""
    pts = _contour_chain(5, 150, seed=3)
    mask = None
    if not dense:
        mask = np.ones(pts.shape[:2], bool)
        mask[1, -4:] = False
    got = _np(t_rs.chain_rotation_search(
        torch.tensor(pts), None if dense else torch.tensor(mask), step,
        rng_deg, bruteforce,
    ))
    want = _np(j_rs.chain_rotation_search(
        jnp.asarray(pts), None if dense else jnp.asarray(mask), step,
        rng_deg, bruteforce,
    ))
    assert got.shape == want.shape == (3 * 4,)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-12)


def test_limes_boundary_follows_host_grid():
    """A pair whose coarse winner sits exactly on the +6 deg limes: whether
    the next stage's last slot (at the limes itself) is on the grid depends
    on the last ulp of that winner.  The port builds its grids op by op like
    the exact host tier (and the reference's f64 loop), so it lands on the
    host-exact ladder's answer.  (The JAX package's jitted chain evaluates
    the winner one ulp lower and admits the slot; its eager stages agree
    with the port.)"""
    pts = _contour_chain(5, 150, seed=3, turn=0.08)  # pair 3 hits +6 deg
    flat = _np(t_rs.chain_rotation_search(torch.tensor(pts), None, 0.01, 6.0, False))
    delta, codes, centers = t_repair.split_chain_packed(flat)
    assert centers[3] < math.radians(6.0)  # the limes slot stayed off-grid
    for i in range(len(delta)):
        want = j_repair.exact_ladder(pts[i + 1], pts[i], 0.01, 6.0, False)
        assert abs(delta[i] - want) < 1e-12


def test_multires_packed_matches_jax():
    chain = _contour_chain(4, 150, seed=5)
    test, ref = chain[1:], chain[:-1]
    mask = np.ones(test.shape[:2], bool)
    mask[2, :10] = False
    got = _np(t_rs.multires_rotation_search_packed(
        torch.tensor(test), torch.tensor(ref), torch.tensor(mask),
        torch.tensor(mask), 0.01, 6.0,
    ))
    want = _np(j_rs.multires_rotation_search_packed(
        jnp.asarray(test), jnp.asarray(ref), jnp.asarray(mask),
        jnp.asarray(mask), 0.01, 6.0,
    ))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-12)


@pytest.mark.parametrize(
    "step, rng_deg", [(0.5, 90.0), (0.01, 6.0), (0.005, 3.0), (1.0, 45.0)]
)
def test_plans_match_jax(step, rng_deg, monkeypatch):
    for strict in ("0", "1"):
        monkeypatch.setenv("MMTPU_STRICT_LADDER", strict)
        assert t_rs.ladder_stages(step, rng_deg) == j_rs.ladder_stages(step, rng_deg)
        assert t_rs.plan_is_bruteforce(step, rng_deg) == j_rs.plan_is_bruteforce(
            step, rng_deg
        )


@pytest.mark.parametrize("env", ["MMTPU_NO_PRUNE", "MMTPU_FAST_LADDER"])
def test_env_switches_match_jax(env, monkeypatch):
    monkeypatch.setenv(env, "1")
    pts = _contour_chain(4, 150, seed=9)
    got = _np(t_rs.chain_rotation_search(torch.tensor(pts), None, 0.01, 6.0, False))
    want = _np(j_rs.chain_rotation_search(jnp.asarray(pts), None, 0.01, 6.0, False))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-12)


# ---------------------------------------------------------------------------
# tie fixtures (the JAX package's tests/test_argmin_certify.py:27-99)
# ---------------------------------------------------------------------------


def test_half_period_rotation_flags_tie():
    ref = _sym_circle()
    test = _rot(ref, 2.5)
    mask = torch.ones((1, _N_SYM), dtype=torch.bool)
    _, tie = t_rs.multires_rotation_search(
        torch.tensor(test[None]), torch.tensor(ref[None]), mask, mask, 0.5, 10.0
    )
    assert bool(tie[0])


def test_exact_self_match_does_not_flag():
    c = torch.tensor(_wobbly(seed=4)[None])
    mask = torch.ones(c.shape[:2], dtype=torch.bool)
    _, tie = t_rs.multires_rotation_search(c, c, mask, mask, 0.5, 10.0)
    assert not bool(tie[0])


def test_asymmetric_contour_does_not_flag():
    test = torch.tensor(np.stack([_wobbly(seed=1), _wobbly(seed=2)]))
    mask = torch.ones(test.shape[:2], dtype=torch.bool)
    _, tie = t_rs.multires_rotation_search(test, test, mask, mask, 0.5, 10.0)
    assert not bool(tie.any())


def test_chain_packed_tie_codes():
    ref = _sym_circle()
    pts = np.stack([ref, _rot(ref, 2.5), _rot(ref, 5.0)])
    flat = _np(t_rs.chain_rotation_search(torch.tensor(pts), None, 0.5, 10.0, False))
    assert flat.shape == (6,)
    delta, codes, centers = t_repair.split_chain_packed(flat)
    assert delta.shape == codes.shape == centers.shape == (2,)
    assert (codes > 0).all()  # both half-period pairs tied
    want = _np(j_rs.chain_rotation_search(jnp.asarray(pts), None, 0.5, 10.0, False))
    np.testing.assert_allclose(flat, want, rtol=0.0, atol=1e-12)


def test_repair_resolves_tie_first_wins():
    """Half-period tie: the repair returns the exact f64 first-wins winner —
    the EARLIER grid angle (-2.5 deg) — like the JAX package's repair."""
    ref = _sym_circle()
    pts = np.stack([ref, _rot(ref, 2.5)])
    delta = np.array([0.999])  # junk device answer
    got = t_repair.repair_chain_deltas(
        delta, np.array([True]), pts, None, 0.5, 10.0, False
    )
    want = j_repair.repair_chain_deltas(
        delta, np.array([True]), pts, None, 0.5, 10.0, False
    )
    np.testing.assert_array_equal(got, want)
    assert got[0] < 0
    assert got[0] == t_repair.exact_ladder(_rot(ref, 2.5), ref, 0.5, 10.0, False)


def test_repair_disabled_by_env(monkeypatch):
    monkeypatch.setenv("MMTPU_CERTIFY_ARGMIN", "0")
    ref = _sym_circle()
    pts = np.stack([ref, _rot(ref, 2.5)])
    before = t_repair.stats["flagged"]
    out = t_repair.repair_chain_deltas(
        np.array([0.123]), np.array([True]), pts, None, 0.5, 10.0, False
    )
    np.testing.assert_array_equal(out, [0.123])
    assert t_repair.stats["flagged"] == before + 1


def test_f64_retier_in_f32_config():
    """Compute dtype f32: flagged pairs re-run in f64 through the same
    search (the plain table on the CPU) and equal the JAX f64 search;
    residual f64 ties fall through to the host tier."""
    from multimodars_torch.config import config

    chain = _contour_chain(4, 150, seed=11)
    tests = [chain[1], chain[2][:140]]
    refs = [chain[0], chain[1]]
    with config.use(dtype=torch.float32):
        best, tie = t_repair._device_f64_retier(tests, refs, 0.01, 6.0, False)
    assert t_repair._device_f64_retier(tests, refs, 0.01, 6.0, False) is None
    S = 150
    test = np.zeros((2, S, 2))
    ref = np.zeros((2, S, 2))
    mask_t = np.zeros((2, S), bool)
    mask_r = np.zeros((2, S), bool)
    for k in range(2):
        test[k, : len(tests[k])] = tests[k]
        ref[k, : len(refs[k])] = refs[k]
        mask_t[k, : len(tests[k])] = True
        mask_r[k, : len(refs[k])] = True
    want = _np(j_rs.multires_rotation_search_packed(
        jnp.asarray(test), jnp.asarray(ref), jnp.asarray(mask_t),
        jnp.asarray(mask_r), 0.01, 6.0,
    ))
    np.testing.assert_allclose(best, want[:2], rtol=0.0, atol=1e-12)
    np.testing.assert_array_equal(tie, want[2:] > 0.5)


@pytest.mark.parametrize(
    "step, rng_deg, bruteforce", [(0.01, 6.0, False), (0.5, 90.0, True)]
)
def test_float32_search_returns_the_float64_grid_values(step, rng_deg, bruteforce):
    """The grids and the answers stay float64 in a float32 search (only the
    cost tables take the points' dtype), so where both searches land on the
    same grid indices the float32 angles equal the float64 ones bit for bit:
    the float32 run's outputs then carry no rounding of its own."""
    pts = torch.tensor(_contour_chain(6, 150, seed=5))
    flat64 = _np(t_rs.chain_rotation_search(pts, None, step, rng_deg, bruteforce))
    flat32 = _np(t_rs.chain_rotation_search(pts.float(), None, step, rng_deg, bruteforce))
    assert flat32.dtype == np.float64
    # the tie codes may differ: a float32 search's band is wider
    a32, _, c32 = t_repair.split_chain_packed(flat32)
    a64, _, c64 = t_repair.split_chain_packed(flat64)
    np.testing.assert_array_equal(a32, a64)
    np.testing.assert_array_equal(c32, c64)
