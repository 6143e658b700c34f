"""The morph sweep's batched launch path in the PyTorch port, on the CPU:
the launch planner (``morph_sweep.plan`` / ``items_of``), the kernel's
order of sums (``morph_sweep_batch_ordered``) under plans for 1, 4 and 132
SMs, the batched entry's plain version against per-sweep plain calls, and
the glue (``ccta.kernels._sweep_start`` / ``_sweep_launch`` /
``_sweep_finish``) and the scale stage against the JAX package.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
everything here is the work decomposition it follows, held in float64
against the single scan.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import ccta_case
import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch.ccta import kernels as tk
from multimodars_torch.ops import morph_sweep as msw
from multimodars_tpu.ccta import kernels as jk
from native_route import one_native_route  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def _on_cpu(one_native_route):  # noqa: F811
    with mt.config.use(device="cpu"):
        yield


def _t(x, dtype=torch.float64):
    return torch.tensor(np.ascontiguousarray(x), dtype=dtype)


def _sweep_inputs(n, m, seed, K=41, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3)) * 3.0
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = rng.standard_normal((m, 3)) * 3.0
    xs = -2.0 + 0.1 * np.arange(K)
    return _t(p, dtype), _t(u, dtype), _t(r, dtype), _t(xs, dtype)


# the scale stage's three sweeps at 57,606 vertices, and ragged shapes
PLAN_CASES = [
    [(1009, 576, 41), (1009, 384, 41), (1709, 96, 41)],
    [(1009, 576, 41)],
    [(1, 1, 1)],
    [(1025, 17, 3), (513, 1, 41), (7, 2049, 2), (3000, 33, 5)],
    [(60000, 1500, 41)],
]


@pytest.mark.parametrize("sizes", PLAN_CASES, ids=lambda s: "-".join(f"{n}x{m}x{k}" for n, m, k in s))
@pytest.mark.parametrize("sms, bps", [(1, 1), (4, 2), (132, 4)])
@pytest.mark.parametrize("f64", [False, True])
def test_morph_sweep_plan_covers_every_triple_once(sizes, sms, bps, f64):
    """Every (sweep, offset, row, reference point) falls in exactly one
    item; splits are whole chunks no longer than the dtype's split limit;
    items hold at most ``OFFSETS`` offsets and one row tile."""
    plans = msw.plan(sizes, sms, bps, f64)
    assert len(plans) == len(sizes)
    rows = msw.rows_per_block(f64)
    for (n, m, K), (splits, per) in zip(sizes, plans):
        assert per % msw.CHUNK == 0 and per <= msw.MAX_SPLIT[f64]
        assert splits == -(-m // per)
    seen = {}
    for s, k0, k1, r0, r1, j0, j1 in msw.items_of(sizes, plans, f64):
        n, m, K = sizes[s]
        assert 0 <= k0 < k1 <= K and k1 - k0 <= msw.OFFSETS
        assert 0 <= r0 < r1 <= n and r1 - r0 <= rows
        assert 0 <= j0 < j1 <= m and j1 - j0 <= plans[s][1]
        for k in range(k0, k1):
            cell = seen.setdefault((s, k), np.zeros((n, m), dtype=np.int32)) if n * m < 5e6 else None
            if cell is not None:
                cell[r0:r1, j0:j1] += 1
            else:
                seen[(s, k)] = seen.get((s, k), 0) + (r1 - r0) * (j1 - j0)
    for s, (n, m, K) in enumerate(sizes):
        for k in range(K):
            got = seen[(s, k)]
            if isinstance(got, np.ndarray):
                assert (got == 1).all()
            else:
                assert got == n * m


def test_morph_sweep_plan_fills_the_card_at_the_stage_shapes():
    """The stage's three sweeps give every one of 132 SMs an item, and no
    SM more than two."""
    sizes = PLAN_CASES[0]
    items = msw.items_of(sizes, msw.plan(sizes), False)
    assert 132 <= len(items) <= 2 * 132


@pytest.mark.parametrize("n, m", [(1, 1), (37, 2000), (1025, 96), (1500, 17)])
@pytest.mark.parametrize("sms, bps", [(1, 1), (4, 2), (132, 4)])
def test_morph_sweep_ordered_equals_plain(n, m, sms, bps):
    """The kernel's order of sums, item by item of the plan, equals the
    plain version to rel 1e-12 in float64 whatever the plan, and is the
    same bit for bit under every plan (minima are exact; the sums' order
    does not depend on the items)."""
    args = _sweep_inputs(n, m, n + m)
    want = msw.morph_sweep_plain(*args)
    got = msw.morph_sweep_ordered(*args, plans=msw.plan([(n, m, 41)], sms, bps))
    base = msw.morph_sweep_ordered(*args, plans=[(1, msw.MAX_SPLIT[False])] if m <= 1024
                                   else None)
    for g, w, b in zip(got, want, base):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=0.0)
        assert torch.equal(g, b)


def _packed(sets, dtype):
    """Points, units and references at their offsets in three buffers."""
    pts = torch.cat([s[0] for s in sets]).to(dtype)
    unit = torch.cat([s[1] for s in sets]).to(dtype)
    ref = torch.cat([s[2] for s in sets]).to(dtype)
    sweeps, po, ro = [], 0, 0
    for p, _, r, K in sets:
        sweeps.append((po, len(p), ro, len(r), K))
        po += len(p)
        ro += len(r)
    return pts, unit, ref, sweeps


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_morph_sweep_batch_plain_equals_per_sweep(dtype):
    """Each sweep's row of the batch equals ``morph_sweep_plain`` on its own
    rows and offsets bit for bit; entries past a sweep's K are 0."""
    sets = []
    for k, (n, m, K) in enumerate([(300, 80, 41), (1, 1, 1), (45, 700, 7), (129, 33, 41)]):
        p, u, r, _ = _sweep_inputs(n, m, 10 + k)
        sets.append((p, u, r, K))
    pts, unit, ref, sweeps = _packed(sets, dtype)
    xs = _t(-2.0 + 0.1 * np.arange(41), dtype)
    out = msw.morph_sweep_batch(pts, unit, ref, xs, sweeps)
    assert out.shape == (2, 4, 41) and out.dtype == dtype
    for s, (p_off, n, r_off, m, K) in enumerate(sweeps):
        fwd, bwd = msw.morph_sweep_plain(pts[p_off:p_off + n], unit[p_off:p_off + n],
                                         ref[r_off:r_off + m], xs[:K])
        assert torch.equal(out[0, s, :K], fwd) and torch.equal(out[1, s, :K], bwd)
        assert not out[:, s, K:].any()
    ordered = msw.morph_sweep_batch_ordered(pts, unit, ref, xs, sweeps)
    if dtype == torch.float64:
        np.testing.assert_allclose(ordered.numpy(), out.numpy(), rtol=1e-12, atol=0.0)


def test_morph_sweep_batch_refuses_bad_sweeps():
    p, u, r, xs = _sweep_inputs(20, 10, 1)
    with pytest.raises(ValueError, match="outside"):
        msw.morph_sweep_batch(p, u, r, xs, [(15, 10, 0, 10, 41)])
    with pytest.raises(ValueError, match="at least one"):
        msw.morph_sweep_batch(p, u, r, xs, [(0, 0, 0, 10, 41)])
    with pytest.raises(ValueError, match="offsets"):
        msw.morph_sweep_batch(p, u, r, xs, [(0, 20, 0, 10, 42)])
    with pytest.raises(ValueError, match="more than"):
        msw.morph_sweep_batch(p, u, r, xs, [(0, 20, 0, 10, 41)] * 5)
    with pytest.raises(ValueError, match="dtype"):
        msw.morph_sweep_batch(p, u.float(), r, xs, [(0, 20, 0, 10, 41)])
    meta = torch.zeros((2, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no morph_sweep kernel"):
        msw.morph_sweep_batch(meta, meta, meta, meta[:, 0], [])


def _sweep_case(n, m, seed, non_finite=False):
    rng = np.random.default_rng(seed)
    cl = np.linspace([0.0, 0.0, 0.0], [0.0, 0.0, 20.0], 40) + 30.0
    t = rng.uniform(0.0, 20.0, n)
    ang = rng.uniform(0.0, 2 * np.pi, n)
    pts = np.stack([30.0 + 1.3 * np.cos(ang), 30.0 + 1.3 * np.sin(ang), 30.0 + t], 1)
    t2 = rng.uniform(2.0, 18.0, m)
    ang2 = rng.uniform(0.0, 2 * np.pi, m)
    ref = np.stack([30.0 + 1.9 * np.cos(ang2), 30.0 + 1.9 * np.sin(ang2), 30.0 + t2], 1)
    if non_finite and m:
        ref[m // 2, 1] = np.inf
    return pts, ref, cl


SWEEP_SIZES = [(0, 50), (50, 0), (1, 1), (90, 384), (700, 576)]


@pytest.mark.parametrize("n, m, non_finite",
                         [(n, m, False) for n, m in SWEEP_SIZES] + [(90, 384, True)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batched_sweeps_match_jax(n, m, non_finite, dtype):
    """Three sweeps in one launch (the case itself, its reverse roles, a
    shifted copy) pick the JAX package's winners one by one; an empty or
    non-finite sweep is answered on the host beside the live ones."""
    pts, ref, cl = _sweep_case(n, m, n + m, non_finite)
    cases = [(pts, ref, cl), (ref, pts, cl), (pts + 0.05, ref, cl)]
    want = [jk._grid_sweep_scaling(*c) for c in cases]
    with mt.config.use(dtype=dtype):
        states = [tk._sweep_start(*c) for c in cases]
        got = [tk._sweep_finish(s, c) for s, c in zip(states, tk._sweep_launch(states))]
    assert got == want


@pytest.mark.parametrize("n, m", SWEEP_SIZES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_proximal_distal_and_aortic_scaling_match_jax(n, m, dtype):
    """``find_proximal_distal_scaling`` (both sweeps in one launch) and
    ``find_aortic_scaling`` give the JAX package's scalings."""
    pts, ref, cl = _sweep_case(max(n, 4), m, 7 * n + m)
    anomalous = pts[:n]
    cline = mj.numpy_to_centerline(cl)
    tline = mt.numpy_to_centerline(cl)
    k = max(1, n // 4)
    want = (jk.find_proximal_distal_scaling(anomalous, k, k, cline, ref, ref[: m // 2]),
            jk.find_aortic_scaling(anomalous, ref, cline))
    with mt.config.use(dtype=dtype):
        got = (tk.find_proximal_distal_scaling(anomalous, k, k, tline, ref, ref[: m // 2]),
               tk.find_aortic_scaling(anomalous, ref, tline))
    assert got == want


def _labelled(pkg, wall=True):
    mesh, cl_ao, cl_rca, cl_lca, geom = ccta_case.build_case(pkg, 1)
    if not wall:
        geom.frames[0].lumen.aortic_thickness = None
    with contextlib.redirect_stdout(io.StringIO()):
        results, (rca_cl, _lca_cl, ao_cl) = pkg.label(
            mesh, cl_ao, cl_rca, cl_lca, aligned_frames=geom.frames, anomalous_rca=True,
            control_plot=False)
    if not results["rca_removed_points"]:
        ao = np.asarray(results["aorta_points"])
        near = np.linalg.norm(ao - np.asarray(ccta_case.RCA_P0), axis=1) < 5.0
        results["rca_removed_points"] = [tuple(p) for p in ao[near][:100]]
    return results, rca_cl, ao_cl, geom


def _scale(pkg, wall=True):
    """(printed lines, scaled results or the exception raised)."""
    results, rca_cl, ao_cl, geom = _labelled(pkg, wall)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            got = pkg.scale(results, rca_cl, ao_cl, geom.frames)
        except Exception as exc:  # compared with the JAX package's
            got = exc
    return out.getvalue(), got


def test_scale_makes_one_batched_sweep_call(monkeypatch):
    """``ccta.scale`` evaluates its three sweeps in one call of the batched
    entry; its printed lines, scalings and scaled mesh equal the JAX
    package's ``scale``."""
    calls = []
    batch = msw.morph_sweep_batch

    def spy(*args):
        calls.append(args[4])
        return batch(*args)

    monkeypatch.setattr(msw, "morph_sweep_batch", spy)
    printed, got = _scale(mt)
    assert len(calls) == 1 and len(calls[0]) == 3
    want_printed, want = _scale(mj)
    assert printed == want_printed
    assert "aortic 2.0 mm" in printed
    np.testing.assert_array_equal(got["mesh"].vertices, want["mesh"].vertices)


def test_scale_without_an_aortic_wall_raises_where_jax_does():
    """No frame carries an aortic thickness: both packages print the
    proximal/distal search and its result, then raise the same error."""
    printed, got = _scale(mt, wall=False)
    want_printed, want = _scale(mj, wall=False)
    assert isinstance(got, ValueError) and isinstance(want, ValueError)
    assert str(got) == str(want)
    assert printed == want_printed
    assert printed.splitlines() and "proximal" in printed.splitlines()[-1]
