"""The port's sweep cost table (multimodars_torch.ops.sweep) against the JAX
package's XLA tables and its Pallas kernel in interpret mode.

Both packages get the same float64 numpy inputs, made from a seed.  The
plain version (what a CPU tensor takes) must match ``rotation_cost_table``
and ``_lb_cost_table`` to rtol 1e-12 with equal argmins: both evaluate the
same difference-form d2 per element and reduce with exact min/max, so only
last-ulp differences of the rotation remain.  The Pallas kernel evaluates
the Gram form, so it is held to the rtol 1e-10 of the JAX package's own
interpret-mode test.  The CUDA kernel itself is tested on the card, by
tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodars_torch.ops import sweep
from multimodars_tpu.ops.pallas_kernels import rotation_cost_table_pallas
from multimodars_tpu.ops.rotation_search import (
    _lb_cost_table,
    candidate_angles,
    rotation_cost_table,
)


def _case(F, N, M, invalid_t=0, invalid_r=0, empty=False, centers=None,
          step=1.0, rng_deg=10.0, limes=10.0, seed=0):
    rng = np.random.default_rng(seed)
    test = rng.standard_normal((F, N, 2))
    ref = rng.standard_normal((F, M, 2))
    tmask = np.ones((F, N), bool)
    rmask = np.ones((F, M), bool)
    if invalid_t:
        tmask[:, -invalid_t:] = False
        tmask[0, 1] = False  # an interior hole too
    if invalid_r:
        rmask[:, -invalid_r:] = False
    if empty:
        tmask[0] = False  # pair 0: empty test set
        rmask[-1] = False  # last pair: empty ref set
    c = np.zeros(F) if centers is None else np.asarray(centers, float)
    angles, valid = candidate_angles(jnp.asarray(c), step, rng_deg, limes)
    return dict(
        test=test, ref=ref, tmask=tmask, rmask=rmask,
        angles=np.asarray(angles), valid=np.asarray(valid),
    )


CASES = {
    "plain": dict(F=3, N=50, M=60),
    "invalid_rows_cols": dict(F=3, N=50, M=60, invalid_t=5, invalid_r=7),
    "clamped_grid": dict(F=2, N=30, M=30, centers=[0.15, -0.15], step=0.5,
                         rng_deg=5.0),
    "collapsed_window": dict(F=2, N=20, M=25, centers=[0.3, -0.3], step=0.5,
                             rng_deg=5.0),
    "empty_set": dict(F=3, N=40, M=40, empty=True),
}


def _torch_args(c, dense):
    def t(a):
        return torch.tensor(a)

    return (
        t(c["test"]), t(c["ref"]),
        None if dense else t(c["tmask"]), None if dense else t(c["rmask"]),
        t(c["angles"]), t(c["valid"]),
    )


def _jax_args(c):
    return (
        jnp.asarray(c["test"]), jnp.asarray(c["ref"]),
        jnp.asarray(c["tmask"]), jnp.asarray(c["rmask"]),
        jnp.asarray(c["angles"]), jnp.asarray(c["valid"]),
    )


def _assert_tables_match(got, want, rtol):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert (np.isinf(got) == np.isinf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0.0)
    assert (got.argmin(axis=1) == want.argmin(axis=1)).all()


# (case, dense): the masked cases run masked only
TABLE_CASES = [(n, False) for n in sorted(CASES)] + [
    (n, True) for n in sorted(CASES) if n not in ("invalid_rows_cols", "empty_set")
]


@pytest.mark.parametrize("name, dense", TABLE_CASES)
def test_exact_table_matches_jax(name, dense):
    c = _case(**CASES[name])
    launches = sweep.launches
    got = sweep.cost_table(*_torch_args(c, dense), dense=dense)
    want = rotation_cost_table(*_jax_args(c), dense=dense)
    _assert_tables_match(got, want, rtol=1e-12)
    assert sweep.launches == launches  # a CPU tensor never launches
    if name == "empty_set":
        assert (np.asarray(got)[[0, -1]][c["valid"][[0, -1]]] == 0.0).all()


@pytest.mark.parametrize("name, dense", TABLE_CASES)
def test_lower_bound_table_matches_jax(name, dense):
    c = _case(**CASES[name])
    got = sweep.cost_table(
        *_torch_args(c, dense), dense=dense,
        outer_stride_test=6, outer_stride_ref=6,
    )
    want = _lb_cost_table(*_jax_args(c), 6, dense)
    _assert_tables_match(got, want, rtol=1e-12)
    exact = sweep.cost_table(*_torch_args(c, dense), dense=dense).numpy()
    fin = np.isfinite(exact)
    assert (np.asarray(got)[fin] <= exact[fin]).all()  # a true lower bound


def test_unequal_outer_strides():
    """Each stride subsamples only its own outer side."""
    c = _case(**CASES["invalid_rows_cols"])
    args = _torch_args(c, False)
    got = sweep.cost_table(*args, outer_stride_test=3, outer_stride_ref=1)
    t, r, tm, rm, a, v = args
    from multimodars_torch.ops.hausdorff import directed_sq

    th = a.T[:, :, None]
    rot = torch.stack(
        [t[None, ..., 0] * torch.cos(th) - t[None, ..., 1] * torch.sin(th),
         t[None, ..., 0] * torch.sin(th) + t[None, ..., 1] * torch.cos(th)], -1
    )
    fwd = directed_sq(rot[:, :, ::3], r[None], tm[None, :, ::3], rm[None], False)
    bwd = directed_sq(r[None], rot, rm[None], tm[None], False)
    want = torch.where(v, torch.maximum(fwd, bwd).T, torch.inf)
    _assert_tables_match(got, want, rtol=1e-12)


@pytest.mark.parametrize(
    "name", ["plain", "invalid_rows_cols", "clamped_grid", "collapsed_window"]
)
def test_plain_matches_pallas_interpret(name):
    c = _case(**CASES[name])
    got = sweep.cost_table(*_torch_args(c, False))
    want = rotation_cost_table_pallas(*_jax_args(c), interpret=True)
    got = np.asarray(got)
    want = np.asarray(want)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10, atol=1e-12)
    assert (got.argmin(axis=1) == want.argmin(axis=1)).all()


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda a: a.update(test=a["test"].float()), "dtype"),
        (lambda a: a.update(test=a["test"].transpose(0, 1).contiguous()
                            .transpose(0, 1)), "contiguous"),
        (lambda a: a.update(tmask=a["tmask"].to(torch.uint8)), "dtype"),
        (lambda a: a.update(valid=a["valid"][:, :-1]), "shape"),
        (lambda a: a.update(ref=a["ref"][:-1]), "shape"),
    ],
)
def test_kernel_input_checks_raise(mutate, match):
    c = _case(**CASES["plain"])
    keys = ("test", "ref", "tmask", "rmask", "angles", "valid")
    args = dict(zip(keys, _torch_args(c, False)))
    mutate(args)
    with pytest.raises(ValueError, match=match):
        sweep.check_inputs(*(args[k] for k in keys), False, 1, 1)


def test_unsupported_device_raises():
    c = _case(**CASES["plain"])
    args = [None if a is None else a.to("meta") for a in _torch_args(c, True)]
    with pytest.raises(ValueError, match="no sweep kernel"):
        sweep.cost_table(*args, dense=True)


# ---------------------------------------------------------------------------
# the launch planner and the kernel's decomposition, emulated on the CPU
# ---------------------------------------------------------------------------

# (F, N, M, K, st, sr): the main path's shapes, then ragged edges
PLAN_SHAPES = [
    (279, 520, 520, 102, 1, 1),    # single path, exact K 102
    (279, 520, 520, 14, 1, 1),     # single path ladder stages
    (279, 520, 520, 22, 1, 1),
    (1116, 520, 520, 362, 6, 6),   # full path, dense lower bound
    (4464, 520, 520, 362, 6, 6),   # cohort lower bound
    (4464, 520, 520, 12, 1, 1),    # cohort exact top 12
    (2, 560, 560, 362, 6, 6),      # masked between lower bound
    (2, 560, 560, 12, 1, 1),       # masked between exact top 12
    (1, 50, 60, 1, 1, 1),
    (2, 61, 47, 13, 1, 6),
    (1, 5, 700, 362, 6, 6),
    (3, 640, 520, 12, 6, 1),
    (65535, 40, 40, 2, 1, 1),
]
# (shape, element size): every shape in both dtypes, and the largest square
# sets each dtype takes
PLANS = [(s, e) for s in PLAN_SHAPES for e in (4, 8)] + [
    ((1, 14464, 14464, 362, 1, 1), 4),
    ((1, 7232, 7232, 362, 6, 6), 8),
]


def _coverage(plan, K):
    """(angle, direction, outer row) -> the number of (block, item) that
    cover it, decoded as the kernel decodes its items."""
    A = plan.angle_tile
    groups = -(-plan.m_out // A)
    seen = {}
    for tile in range(plan.grid[0]):
        for z in range(plan.grid[2]):
            q0 = z * plan.items_per_block
            for q in range(q0, min(plan.items, q0 + plan.items_per_block)):
                if q < plan.n_out:
                    cells = [(tile * A + a, 0, q) for a in range(A)]
                else:
                    a, g = divmod(q - plan.n_out, groups)
                    cells = [(tile * A + a, 1, g * A + r) for r in range(A)
                             if g * A + r < plan.m_out]
                for k, d, row in cells:
                    if k < K:
                        seen[(k, d, row)] = seen.get((k, d, row), 0) + 1
    return seen


@pytest.mark.parametrize(
    "shape, elem_size", PLANS,
    ids=["x".join(map(str, s)) + f"-f{8 * e}" for s, e in PLANS],
)
def test_plan_launch_fits_and_covers(shape, elem_size):
    F, N, M, K, st, sr = shape
    plan = sweep.plan_launch(F, N, M, K, st, sr, elem_size, 132)
    per_load = 16 // (2 * elem_size)
    S = plan.inner_split
    assert plan.smem <= sweep.SMEM_LIMIT < 227 * 1024
    assert plan.smem == (plan.m_pad + plan.angle_tile * plan.n_pad) * 2 * elem_size
    assert plan.grid[0] <= 2 ** 31 - 1 and plan.grid[1] <= 65535
    assert plan.grid[2] <= 65535 and plan.grid[1] == F
    assert sweep.THREADS % 32 == 0 and sweep.THREADS <= 1024
    assert S & (S - 1) == 0 and 32 % S == 0 and sweep.THREADS % S == 0
    assert plan.angle_tile in sweep.ANGLE_TILES[elem_size]
    assert plan.rows_per_thread == plan.angle_tile
    assert plan.n_pad % (per_load * S) == 0 and plan.n_pad - N < per_load * S
    assert plan.m_pad % (per_load * S) == 0 and plan.m_pad - M < per_load * S
    # every block has items, and the last one ends at the last item
    assert (plan.grid[2] - 1) * plan.items_per_block < plan.items
    assert plan.grid[2] * plan.items_per_block >= plan.items
    if K * max(plan.n_out, plan.m_out) * plan.grid[2] <= 2_000_000:
        seen = _coverage(plan, K)
        want = {(k, 0, i) for k in range(K) for i in range(plan.n_out)}
        want |= {(k, 1, j) for k in range(K) for j in range(plan.m_out)}
        assert set(seen) == want
        assert set(seen.values()) == {1}


def test_plan_launch_fills_small_grids():
    """Few pairs x angle tiles: the items are split over more blocks, and
    the lanes of a block share items; many pairs: neither."""
    small = sweep.plan_launch(2, 560, 560, 362, 6, 6, 4, 132)
    assert small.block_split > 1 and small.inner_split > 1
    assert small.angle_tile * small.grid[0] >= 362
    big = sweep.plan_launch(1116, 520, 520, 362, 6, 6, 4, 132)
    assert big.block_split == 1 and big.inner_split > 1
    exact = sweep.plan_launch(279, 520, 520, 102, 1, 1, 4, 132)
    assert exact.block_split == 1 and exact.inner_split == 1
    assert exact.angle_tile == 8
    # the top-12 tables take a tile that divides 12
    assert sweep.plan_launch(4464, 520, 520, 12, 1, 1, 4, 132).angle_tile == 4
    assert sweep.plan_launch(279, 520, 520, 102, 1, 1, 8, 132).angle_tile == 2


@pytest.mark.parametrize("elem_size, largest", [(4, 14464), (8, 7232)])
def test_plan_launch_size_limit(elem_size, largest):
    """The largest square sets that fit one angle at a time are taken (the
    tile narrows); one point more raises.  The first kernel's limit, both
    sets in shared memory and 4 rotated copies of the test set, lies well
    inside."""
    plan = sweep.plan_launch(1, largest, largest, 362, 1, 1, elem_size, 132)
    assert plan.angle_tile == 1
    with pytest.raises(ValueError, match="shared memory"):
        sweep.plan_launch(1, largest + 1, largest + 1, 362, 1, 1, elem_size, 132)
    old_largest = (sweep.SMEM_LIMIT // (5 * 2 * elem_size + 2))
    wide = sweep.plan_launch(1, old_largest, old_largest, 362, 1, 1, elem_size, 132)
    assert wide.angle_tile >= 2


def _bits_max(out, v):
    """Max in the order of the bit patterns as signed integers, as the
    kernel's atomicMax merges a block's value into the output."""
    ints = torch.int32 if out.dtype == torch.float32 else torch.int64
    return torch.maximum(out.view(ints), v.view(ints)).view(out.dtype)


def _emulate(test, ref, tmask, rmask, angles, valid, st, sr, n_sms):
    """The kernel's decomposition in PyTorch: per-block partial maxima over
    the planned items, inner segments merged by min, sentinels for invalid
    slots, and the bit-order max merge into an output of -inf of each
    block's values: its maxima, 0 for an empty pair, +inf at an invalid
    angle.  d2 is the plain version's dx*dx + dy*dy."""
    F, N, _ = test.shape
    M, K = ref.shape[1], angles.shape[1]
    dt = test.dtype
    inf = torch.tensor(math.inf, dtype=dt)
    plan = sweep.plan_launch(F, N, M, K, st, sr, test.element_size(), n_sms)
    A, S, Z = plan.angle_tile, plan.inner_split, plan.block_split
    n_out, m_out, n_pad, m_pad = plan.n_out, plan.m_out, plan.n_pad, plan.m_pad
    groups = -(-m_out // A)
    tm = torch.ones((F, N), dtype=torch.bool) if tmask is None else tmask
    rm = torch.ones((F, M), dtype=torch.bool) if rmask is None else rmask
    out = torch.full((F, K), -math.inf, dtype=dt)

    def d2(p, q):  # p [..., P, 2], q [..., Q, 2] -> [..., P, Q]
        dx = p[..., :, None, 0] - q[..., None, :, 0]
        dy = p[..., :, None, 1] - q[..., None, :, 1]
        return dx * dx + dy * dy

    def seg_min(d, pad):  # [..., P, pad] -> per-segment minima merged by min
        return d.reshape(*d.shape[:-1], S, pad // S).amin(-1).amin(-1)

    for f in range(F):
        ref_s = torch.full((m_pad, 2), math.inf, dtype=dt)
        ref_s[:M] = torch.where(rm[f, :, None], ref[f], inf)
        for tile in range(plan.grid[0]):
            ks = [min(tile * A + a, K - 1) for a in range(A)]
            th = angles[f, ks]
            c, s = torch.cos(th)[:, None], torch.sin(th)[:, None]
            x, y = test[f, None, :, 0], test[f, None, :, 1]
            rot = torch.stack([x * c - y * s, x * s + y * c], -1)  # [A, N, 2]
            rot_s = torch.full((A, n_pad, 2), math.inf, dtype=dt)
            rot_s[:, :N] = torch.where(tm[f, None, :, None], rot, inf)
            live = torch.tensor([tile * A + a < K and bool(valid[f, tile * A + a])
                                 for a in range(A)])
            exists = [tile * A + a < K for a in range(A)]
            if not (tm[f].any() and rm[f].any()):
                for a in range(A):
                    if exists[a]:
                        k = tile * A + a
                        v = torch.zeros((), dtype=dt) if live[a] else inf
                        out[f, k] = _bits_max(out[f, k], v)
                continue
            rows_t = torch.arange(n_out) * st
            fwd = seg_min(d2(rot_s[:, rows_t], ref_s), m_pad)  # [A, n_out]
            row_ok_t = rot_s[0, rows_t, 0] != math.inf
            rows_r = torch.arange(m_out) * sr
            bwd = seg_min(d2(ref_s[None, rows_r], rot_s), n_pad)  # [A, m_out]
            row_ok_r = ref_s[rows_r, 0] != math.inf
            for z in range(Z):
                q0 = z * plan.items_per_block
                acc = torch.full((A,), -math.inf, dtype=dt)
                for q in range(q0, min(plan.items, q0 + plan.items_per_block)):
                    if q < n_out:
                        if row_ok_t[q]:
                            acc = torch.where(live, torch.maximum(acc, fwd[:, q]), acc)
                    else:
                        a, g = divmod(q - n_out, groups)
                        rows = torch.arange(g * A, min(g * A + A, m_out))
                        v = torch.where(row_ok_r[rows], bwd[a, rows], -inf)
                        if live[a] and len(rows):
                            acc[a] = torch.maximum(acc[a], v.amax())
                for a in range(A):
                    v = acc[a] if live[a] else inf
                    if exists[a] and v != -math.inf:
                        k = tile * A + a
                        out[f, k] = _bits_max(out[f, k], v)
    return out


def _emulation_case(name, seed=0):
    """(test, ref, tmask, rmask, angles, valid, st, sr) from numpy, seeded."""
    from multimodars_torch.ops.rotation_search import candidate_angles

    spec = dict(
        dense_exact=dict(F=3, N=50, M=60, step=1.0, rng=6.0, st=1, sr=1),
        dense_lb=dict(F=2, N=61, M=47, step=0.1, rng=5.0, st=6, sr=6),
        masked_exact=dict(F=3, N=40, M=44, step=1.0, rng=5.5, st=1, sr=1,
                          holes=True),
        masked_lb_full_grid=dict(F=3, N=40, M=36, step=0.5, rng=90.0, st=6,
                                 sr=6, holes=True, empty=True, dead_row=True),
        one_pair_one_angle=dict(F=1, N=9, M=11, step=0.0, rng=0.0, st=1, sr=1),
        unequal_strides=dict(F=2, N=33, M=52, step=1.0, rng=6.0, st=1, sr=6,
                             holes=True),
        stride_past_set=dict(F=2, N=5, M=7, step=1.0, rng=6.0, st=6, sr=6),
        no_strided_row_valid=dict(F=2, N=30, M=24, step=1.0, rng=6.0, st=6,
                                  sr=6, strided_holes=True),
    )[name]
    rng = np.random.default_rng(seed)
    F, N, M = spec["F"], spec["N"], spec["M"]
    test = rng.standard_normal((F, N, 2))
    ref = rng.standard_normal((F, M, 2))
    dense = not any(spec.get(k) for k in ("holes", "empty", "strided_holes"))
    tmask = np.ones((F, N), bool)
    rmask = np.ones((F, M), bool)
    if spec.get("holes"):
        tmask &= rng.random((F, N)) > 0.15
        rmask &= rng.random((F, M)) > 0.15
        tmask[:, -3:] = False
    if spec.get("empty"):
        tmask[0] = False
        rmask[-1] = False
    if spec.get("strided_holes"):
        tmask[:, :: spec["st"]] = False
        rmask[:, :: spec["sr"]] = False
    centers = torch.tensor(rng.uniform(-0.05, 0.05, F))
    if spec["step"] > 0:
        angles, valid = candidate_angles(centers, spec["step"], spec["rng"], 90.0)
    else:
        angles, valid = centers[:, None].clone(), torch.ones((F, 1), dtype=torch.bool)
    if spec.get("dead_row"):
        valid[1] = False
    return (torch.tensor(test), torch.tensor(ref),
            None if dense else torch.tensor(tmask),
            None if dense else torch.tensor(rmask),
            angles, valid, spec["st"], spec["sr"])


EMULATION_CASES = [
    "dense_exact", "dense_lb", "masked_exact", "masked_lb_full_grid",
    "one_pair_one_angle", "unequal_strides", "stride_past_set",
    "no_strided_row_valid",
]


@pytest.mark.parametrize("n_sms", [1, 132])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", EMULATION_CASES)
def test_kernel_decomposition_equals_plain(name, dtype, n_sms):
    """The kernel's cut of the work (as planned for a card of ``n_sms`` SMs:
    1 keeps one block per tile, 132 splits small grids over blocks and
    items over lanes) gives the plain table bit for bit."""
    test, ref, tm, rm, angles, valid, st, sr = _emulation_case(name)
    test, ref, angles = test.to(dtype), ref.to(dtype), angles.to(dtype)
    dense = tm is None
    got = _emulate(test, ref, tm, rm, angles, valid, st, sr, n_sms)
    want = sweep.cost_table_plain(
        test, ref, tm, rm, angles, valid, dense=dense,
        outer_stride_test=st, outer_stride_ref=sr,
    )
    assert got.dtype == want.dtype == dtype
    assert got.numpy().tobytes() == want.numpy().tobytes()
    if name == "masked_lb_full_grid":
        assert (want[1] == math.inf).all()  # the all-invalid angle row
        assert (want[0][valid[0]] == 0).all() and (want[-1][valid[-1]] == 0).all()
    if name == "no_strided_row_valid":
        assert (want[valid] == -math.inf).all()
