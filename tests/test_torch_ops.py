"""The port's ``ops`` surface against the JAX package's: the five names and
their parameters, the TPU switches changing no bit, the public masked Hausdorff on seeded inputs (broadcast
leading dims, 3-D points, empty sets, zero-size leading dims), the three
search and Hausdorff cases of tests/test_core.py::TestEdgeCases on torch
inputs, the dispatcher's device rule, and that the kernels' plain versions
never reach the dispatcher.

Everything runs on the CPU: the public Hausdorff takes its plain version
there, and the kernel's packing (``hausdorff._masked_on_kernel``) is held
against it through the refine kernel's plain version.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodars_torch as mt
import multimodars_tpu.ops as jops
from multimodars_torch import ops as tops
from multimodars_torch.ops import hausdorff as th
from multimodars_torch.ops import hausdorff_batch as hb
from multimodars_torch.ops import rotation_search as trs
from multimodars_torch.ops import sweep
from multimodars_tpu.ops import hausdorff as jh
from multimodars_tpu.ops import rotation_search as jrs

_OPS_NAMES = (
    "hausdorff_sq_masked", "hausdorff_distance_masked", "search_range_batched",
    "multires_rotation_search", "rotation_cost_table",
)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


def _parameters(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", _OPS_NAMES)
def test_ops_exports_jax_names(name):
    """``multimodars_torch.ops`` exports the JAX package's five names, each
    with the JAX function's parameters, its TPU switches (``use_pallas``,
    ``angle_chunk``) included; the port's ``dense`` (every slot valid) may
    stand where the JAX function has none."""
    assert list(tops.__all__) == list(jops.__all__)
    assert sorted(tops.__all__) == sorted(_OPS_NAMES)
    want = _parameters(getattr(jops, name))
    got = _parameters(getattr(tops, name))
    assert [p for p in got if p[0] != "dense" or ("dense", False) in want] == want
    assert dict(got).get("dense", False) is False


def _case(p_shape, q_shape, pm_shape, qm_shape, seed, empty=()):
    """Seeded point sets and masks; ``empty`` names the sides ("p", "q")
    whose first set is emptied."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0.0, 3.0, p_shape)
    q = rng.normal(0.0, 3.0, q_shape)
    pm = rng.random(pm_shape) < 0.8
    qm = rng.random(qm_shape) < 0.8
    if "p" in empty and pm.size:
        pm.reshape(-1, pm_shape[-1])[0] = False
    if "q" in empty and qm.size:
        qm.reshape(-1, qm_shape[-1])[0] = False
    return p, q, pm, qm


# (p, q, pmask, qmask shapes, sides emptied)
_CASES = {
    "one pair": ((11, 2), (9, 2), (11,), (9,), ()),
    "batch": ((4, 11, 2), (4, 9, 2), (4, 11), (4, 9), ()),
    "3-D points": ((4, 11, 3), (4, 9, 3), (4, 11), (4, 9), ()),
    "refine layout": ((3, 5, 11, 2), (3, 1, 9, 2), (3, 5, 11), (3, 1, 9), ()),
    "outer broadcast": ((2, 1, 11, 3), (1, 3, 9, 2), (2, 1, 11), (1, 3, 9), ()),
    "shared q": ((2, 3, 11, 2), (9, 2), (2, 3, 11), (9,), ()),
    "mask broadcast": ((2, 3, 11, 2), (2, 3, 9, 2), (3, 11), (2, 1, 9), ()),
    "empty p": ((4, 11, 2), (4, 9, 2), (4, 11), (4, 9), ("p",)),
    "empty q": ((4, 11, 2), (4, 9, 2), (4, 11), (4, 9), ("q",)),
    "empty both": ((4, 11, 2), (4, 9, 2), (4, 11), (4, 9), ("p", "q")),
    "zero leading": ((0, 11, 2), (0, 9, 2), (0, 11), (0, 9), ()),
    "zero inner leading": ((3, 0, 11, 2), (3, 1, 9, 2), (3, 0, 11), (3, 1, 9), ()),
}


@pytest.mark.parametrize("fn", ["hausdorff_sq_masked", "hausdorff_distance_masked"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_public_hausdorff_matches_jax_f64(case, fn):
    """The same seeded numpy inputs through both packages, f64: equal."""
    *shapes, empty = _CASES[case]
    p, q, pm, qm = _case(*shapes, seed=len(case), empty=empty)
    # eager: a jitted program may contract dx*dx + dy*dy into an FMA
    want = np.asarray(getattr(jh, fn)(jnp.asarray(p), jnp.asarray(q), jnp.asarray(pm),
                                      jnp.asarray(qm)))
    got = getattr(tops, fn)(torch.as_tensor(p), torch.as_tensor(q), torch.as_tensor(pm),
                            torch.as_tensor(qm))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if "empty" in case:
        assert got.reshape(-1)[0] == 0.0 and (got.reshape(-1)[1:] > 0).all()


@pytest.mark.parametrize("case", ["batch", "3-D points", "refine layout", "empty q"])
def test_public_hausdorff_matches_jax_f32(case):
    """float32 inputs: within 1e-6 relative of the JAX package's float32
    result (both round each operation in float32; the order of the
    reductions' operations may differ)."""
    *shapes, empty = _CASES[case]
    p, q, pm, qm = _case(*shapes, seed=len(case), empty=empty)
    p, q = p.astype(np.float32), q.astype(np.float32)
    want = np.asarray(jh.hausdorff_sq_masked(jnp.asarray(p), jnp.asarray(q),
                                             jnp.asarray(pm), jnp.asarray(qm)))
    got = tops.hausdorff_sq_masked(torch.as_tensor(p), torch.as_tensor(q),
                                   torch.as_tensor(pm), torch.as_tensor(qm))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_kernel_packing_equals_plain(case, monkeypatch):
    """The CUDA route's packing (broadcast, x and y only, flattened to
    candidates against reference sets) run through the refine kernel's
    plain version: bit for bit the plain function.  Where ``q`` is constant
    along the last leading axis, that axis is the kernel's K and ``q`` is
    not copied."""
    *shapes, empty = _CASES[case]
    p, q, pm, qm = (torch.as_tensor(a) for a in _case(*shapes, seed=len(case), empty=empty))
    calls = []
    table = hb.hausdorff_sq_shared_ref

    def spy(pp, pmask, qq, qmask, K):
        calls.append((tuple(pp.shape), tuple(qq.shape), K))
        assert pp.is_contiguous() and qq.is_contiguous() and pp.shape[-1] == 2
        return table(pp, pmask, qq, qmask, K)

    monkeypatch.setattr(hb, "hausdorff_sq_shared_ref", spy)
    got = th._masked_on_kernel(p, q, pm, qm)
    want = th.hausdorff_sq_masked_plain(p[..., :2], q[..., :2], pm, qm)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    (p_shape, q_shape, K), = calls
    if case == "refine layout":
        assert (p_shape, q_shape, K) == ((15, 11, 2), (3, 9, 2), 5)
    if case == "shared q":
        assert (q_shape, K) == ((2, 9, 2), 3)
    if case == "batch":
        assert (p_shape, q_shape, K) == ((4, 11, 2), (4, 9, 2), 1)


def test_empty_point_axis_gives_zero():
    """N = 0 or M = 0: an empty set, so 0 as in the reference
    (process_utils.rs:78-121) and as the kernel route returns without a
    launch.  A deliberate divergence from the JAX package, whose reduction
    of a zero-size axis raises."""
    with pytest.raises(ValueError):
        jh.hausdorff_sq_masked(jnp.zeros((3, 0, 2)), jnp.zeros((3, 5, 2)),
                               jnp.zeros((3, 0), bool), jnp.ones((3, 5), bool))
    for n, m in ((0, 5), (4, 0)):
        args = (torch.zeros((3, n, 2)), torch.ones((3, m, 2)),
                torch.ones((3, n), dtype=torch.bool), torch.ones((3, m), dtype=torch.bool))
        for fn in (tops.hausdorff_sq_masked, th._masked_on_kernel):
            out = fn(*args)
            assert out.dtype == torch.float32 and torch.equal(out, torch.zeros(3))


def test_dispatcher_refuses_other_devices():
    """A tensor neither on the CPU nor on a CUDA card raises; the plain
    version does not stand in for the kernel."""
    p = torch.zeros((2, 4, 2), device="meta")
    mask = torch.ones((2, 4), dtype=torch.bool, device="meta")
    for fn in (tops.hausdorff_sq_masked, tops.hausdorff_distance_masked):
        with pytest.raises(ValueError, match="no hausdorff_batch kernel for device meta"):
            fn(p, p, mask, mask)


def test_dispatcher_refuses_integer_points_for_the_kernel():
    """The kernel route takes float32 or float64 points, nothing else."""
    p = torch.zeros((2, 4, 2), dtype=torch.int64)
    mask = torch.ones((2, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="expected float32 or float64"):
        th._masked_on_kernel(p, p, mask, mask)


def test_plain_paths_never_reach_the_dispatcher(monkeypatch):
    """The sweep's and the refine's plain versions compute their tables
    without the public function: with it made to raise they still equal
    the JAX package's tables."""

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version reached the public dispatcher")

    monkeypatch.setattr(th, "hausdorff_sq_masked", refuse)
    monkeypatch.setattr(tops, "hausdorff_sq_masked", refuse)
    rng = np.random.default_rng(5)
    test = rng.normal(0.0, 2.0, (3, 13, 2))
    ref = rng.normal(0.0, 2.0, (3, 10, 2))
    tm = rng.random((3, 13)) < 0.8
    rm = rng.random((3, 10)) < 0.8
    rm[2] = False
    angles, valid = trs.candidate_angles(torch.tensor([0.0, 0.1, -0.2], dtype=torch.float64),
                                         1.0, 5.0, 6.0)
    got = sweep.cost_table_plain(torch.as_tensor(test), torch.as_tensor(ref),
                                 torch.as_tensor(tm), torch.as_tensor(rm), angles, valid)
    want = jrs.rotation_cost_table(jnp.asarray(test), jnp.asarray(ref), jnp.asarray(tm),
                                   jnp.asarray(rm), jnp.asarray(angles.numpy()),
                                   jnp.asarray(valid.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0.0)

    S, K = 2, 3
    p = rng.normal(0.0, 2.0, (S * K, 13, 2))
    pm = rng.random((S * K, 13)) < 0.8
    pm[1] = False
    qs = rng.normal(0.0, 2.0, (S, 10, 2))
    qsm = rng.random((S, 10)) < 0.8
    got = hb.hausdorff_sq_shared_ref_plain(torch.as_tensor(p), torch.as_tensor(pm),
                                           torch.as_tensor(qs), torch.as_tensor(qsm), K)
    s = np.arange(S * K) // K
    want = jh.hausdorff_sq_masked(jnp.asarray(qs[s]), jnp.asarray(p), jnp.asarray(qsm[s]),
                                  jnp.asarray(pm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1] == 0.0


# --- tests/test_core.py::TestEdgeCases on torch inputs ---------------------

def test_hausdorff_empty_sets_zero():
    """The directed Hausdorff of an empty set is 0.0 (the reference's)."""
    a = torch.zeros((1, 4, 2))
    b = torch.zeros((1, 4, 2))
    empty = torch.zeros((1, 4), dtype=torch.bool)
    full = torch.ones((1, 4), dtype=torch.bool)
    assert float(tops.hausdorff_distance_masked(a, b, empty, empty)[0]) == 0.0
    assert float(tops.hausdorff_distance_masked(a, b, empty, full)[0]) == 0.0


def test_search_zero_step_returns_center():
    test = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 8, 2)))
    mask = torch.ones((2, 8), dtype=torch.bool)
    centers = torch.tensor([0.3, -0.2], dtype=torch.float64)
    out, _tie = tops.search_range_batched(test, test, mask, mask, 0.0, 5.0, centers, 10.0)
    np.testing.assert_allclose(out.numpy(), centers.numpy())


def test_degenerate_angle_grid_clamped():
    """A center far outside a tiny limes inverts the clamped window; the
    search falls back to the clamped start angle, as the reference's clamp
    (process_utils.rs:33-75)."""
    test = torch.zeros((1, 4, 2), dtype=torch.float64)
    mask = torch.ones((1, 4), dtype=torch.bool)
    out, _tie = tops.search_range_batched(
        test, test, mask, mask, 1.0, 5.0, torch.tensor([np.pi], dtype=torch.float64), 0.001
    )
    clamped_start = max(np.pi - np.radians(5.0), -np.radians(0.001))
    np.testing.assert_allclose(out.numpy(), [clamped_start])


def test_public_searches_match_jax():
    """The three public search names against the JAX package's on one
    seeded batch, f64: the same costs, angles and tie flags."""
    rng = np.random.default_rng(9)
    base = rng.normal(0.0, 2.0, (4, 24, 2))
    th_ = np.radians([3.0, -7.5, 12.25, 0.5])[:, None]
    c, s = np.cos(th_), np.sin(th_)
    test = np.stack([base[..., 0] * c - base[..., 1] * s,
                     base[..., 0] * s + base[..., 1] * c], -1) + rng.normal(0, 1e-3, base.shape)
    mask = np.ones((4, 24), bool)
    mask[1, -5:] = False
    t = [torch.as_tensor(a) for a in (test, base, mask, mask)]
    j = [jnp.asarray(a) for a in (test, base, mask, mask)]

    got = tops.multires_rotation_search(*t, 0.1, 20.0)
    want = jops.multires_rotation_search(*j, 0.1, 20.0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    centers = np.array([0.05, -0.1, 0.2, 0.0])
    got = tops.search_range_batched(*t, 0.5, 10.0, torch.as_tensor(centers), 20.0)
    want = jops.search_range_batched(*j, 0.5, 10.0, jnp.asarray(centers), 20.0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    angles, valid = trs.candidate_angles(torch.as_tensor(centers), 0.5, 10.0, 20.0)
    got = tops.rotation_cost_table(*t, angles, valid)
    want = jops.rotation_cost_table(*j, jnp.asarray(angles.numpy()), jnp.asarray(valid.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0.0)


def _switch_case():
    """The seeded batch of test_public_searches_match_jax as torch inputs,
    its centers and its grid."""
    rng = np.random.default_rng(9)
    base = rng.normal(0.0, 2.0, (4, 24, 2))
    test = base + rng.normal(0, 1e-2, base.shape)
    mask = np.ones((4, 24), bool)
    mask[1, -5:] = False
    centers = torch.tensor([0.05, -0.1, 0.2, 0.0], dtype=torch.float64)
    angles, valid = trs.candidate_angles(centers, 0.5, 10.0, 20.0)
    return [torch.as_tensor(a) for a in (test, base, mask, mask)], centers, angles, valid


@pytest.mark.parametrize("use_pallas", [True, False])
def test_use_pallas_changes_no_bit(use_pallas):
    """``use_pallas`` chooses an implementation in the JAX package; the
    port has one route, and every value gives the default's bits."""
    t, centers, _, _ = _switch_case()
    for fn, args in ((tops.multires_rotation_search, (0.1, 20.0)),
                     (tops.search_range_batched, (0.5, 10.0, centers, 20.0))):
        want = fn(*t, *args)
        for value in (None, use_pallas):
            got = fn(*t, *args, use_pallas=value)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("chunk", [None, 1, 7, "K+3"])
def test_angle_chunk_changes_no_bit(chunk):
    """``angle_chunk`` (angles a distance tile takes in the JAX package) gives
    the default's table bit for bit, K + 3 included; a value that is no
    integer is refused."""
    t, _, angles, valid = _switch_case()
    want = tops.rotation_cost_table(*t, angles, valid)
    value = angles.shape[1] + 3 if chunk == "K+3" else chunk
    assert torch.equal(tops.rotation_cost_table(*t, angles, valid, angle_chunk=value), want)
    with pytest.raises(TypeError):
        tops.rotation_cost_table(*t, angles, valid, angle_chunk=2.5)
