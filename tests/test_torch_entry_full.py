"""The four-phase pipeline of the PyTorch port against the JAX package:
``from_array_full`` / ``from_file_full`` on the same inputs.

Both run in float64 on the CPU (tests/conftest.py pins the compute dtype).
The port runs the reference's sequential order: one batched within search,
then the two between stages, stage 2 on the geometries stage 1 moved.  It
is held against both orchestrations of the JAX package: its default (the
fused one-program chain) and its fallback (``MMTPU_NO_FUSED_CHAIN=1``).
Rotation logs must agree to 1e-12 degrees, translations and every output
coordinate, centroid and reference point to 1e-9 mm, with equal labels,
frame ids and frame counts.
"""

import contextlib
import functools
import io
import math
from pathlib import Path

import numpy as np
import pytest

import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch.ops import argmin_repair as t_rep
from multimodars_torch.pipelines import align_between as t_ab


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


FIXTURES = Path(__file__).resolve().parent / "data" / "fixtures"


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _make_datas(pkg, n=4, anomalous=False, seed=17):
    """The JAX package's fused-chain fixture (tests/test_fused_chain.py):
    ``n`` 12-frame x 40-point pullbacks; ``anomalous=True`` makes the
    elliptic ratio exceed 2 so the finish takes the farthest-pair axis."""
    rng = np.random.default_rng(seed)
    rx, ry = (3.0, 1.0) if anomalous else (2.0, 1.5)
    datas = []
    for g in range(n):
        rows = []
        for f in range(12):
            th = np.linspace(0, 2 * np.pi, 40, endpoint=False)
            x = 4.5 + (rx + 0.15 * rng.standard_normal()) * np.cos(th + 0.1 * f)
            y = 4.5 + (ry + 0.15 * rng.standard_normal()) * np.sin(th + 0.1 * f)
            z = np.full(40, f * 0.3)
            rows.append(np.stack([np.full(40, f), x, y, z], -1))
        ref = np.array([0, 6.8 + 0.1 * g, 4.5, 0.0])
        datas.append(pkg.numpy_to_inputdata(
            np.concatenate(rows), ref, g % 2 == 0, label=f"g{g}"
        ))
    return datas


def _assert_geometry_close(got, want):
    assert got.label == want.label
    assert len(got.frames) == len(want.frames)
    for gf, wf in zip(got.frames, want.frames):
        assert gf.id == wf.id
        np.testing.assert_allclose(gf.centroid, wf.centroid, rtol=0.0, atol=1e-9)
        np.testing.assert_allclose(
            gf.lumen.xyz_view(), wf.lumen.xyz_view(), rtol=0.0, atol=1e-9
        )
        assert gf.extras.keys() == wf.extras.keys()
        for kind in wf.extras:
            np.testing.assert_allclose(
                gf.extras[kind].xyz_view(), wf.extras[kind].xyz_view(),
                rtol=0.0, atol=1e-9, err_msg=kind,
            )
        assert (gf.reference_point is None) == (wf.reference_point is None)
        if wf.reference_point is not None:
            gp, wp = gf.reference_point, wf.reference_point
            np.testing.assert_allclose(
                [gp.x, gp.y, gp.z], [wp.x, wp.y, wp.z], rtol=0.0, atol=1e-9
            )


def _assert_logs_close(got, want):
    assert len(got) == len(want)
    for g_logs, w_logs in zip(got, want):
        g, w = np.array(g_logs, dtype=float), np.array(w_logs, dtype=float)
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_array_equal(g[:, :2], w[:, :2])  # ids
        np.testing.assert_allclose(g[:, 2], w[:, 2], rtol=0.0, atol=1e-12)  # deg
        np.testing.assert_allclose(g[:, 3:], w[:, 3:], rtol=0.0, atol=1e-9)  # mm


def _assert_result_close(got, want, n_pairs):
    assert len(got) == len(want) == n_pairs + 1
    for g_pair, w_pair in zip(got[:n_pairs], want[:n_pairs]):
        assert g_pair.label == w_pair.label
        _assert_geometry_close(g_pair.geom_a, w_pair.geom_a)
        _assert_geometry_close(g_pair.geom_b, w_pair.geom_b)
    _assert_logs_close(got[n_pairs], want[n_pairs])


def _jax(monkeypatch, orchestration, fn, *args, **kwargs):
    if orchestration == "fallback":
        monkeypatch.setenv("MMTPU_NO_FUSED_CHAIN", "1")
    else:
        monkeypatch.delenv("MMTPU_NO_FUSED_CHAIN", raising=False)
    return _quiet(fn, *args, **kwargs)


@functools.lru_cache(maxsize=None)
def _torch_full(anomalous, smooth, postprocessing):
    return _quiet(
        mt.from_array_full, *_make_datas(mt, anomalous=anomalous),
        write_obj=False, smooth=smooth, postprocessing=postprocessing,
    )


@pytest.mark.parametrize("orchestration", ["fused", "fallback"])
@pytest.mark.parametrize("postprocessing", [False, True])
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("anomalous", [False, True])
def test_from_array_full_matches_jax(
    monkeypatch, anomalous, smooth, postprocessing, orchestration
):
    """Canonical defaults (step 0.5, range 90: the brute-force plan)."""
    got = _torch_full(anomalous, smooth, postprocessing)
    want = _jax(
        monkeypatch, orchestration, mj.from_array_full,
        *_make_datas(mj, anomalous=anomalous), write_obj=False, smooth=smooth,
        postprocessing=postprocessing,
    )
    _assert_result_close(got, want, 4)
    assert [p.label for p in got[:4]] == [
        "g0 - g1", "g2 - g3", "g0 - g2", "g1 - g3"
    ]


@pytest.mark.parametrize("postprocessing", [False, True])
@pytest.mark.parametrize("smooth", [False, True])
def test_from_file_full_matches_jax(smooth, postprocessing):
    """The vendored clinical pullbacks (501-point contours, a synthesized
    catheter, real reference points), at a coarse plan to keep the CPU
    reference quick."""
    args = (str(FIXTURES / "ivus_rest"), str(FIXTURES / "ivus_stress"))
    kw = dict(
        labels=["rest_dia", "rest_sys", "stress_dia", "stress_sys"],
        step_rotation_deg=1.0, range_rotation_deg=10.0, write_obj=False,
        smooth=smooth, postprocessing=postprocessing,
    )
    got = _quiet(mt.from_file_full, *args, **kw)
    want = _quiet(mj.from_file_full, *args, **kw)
    _assert_result_close(got, want, 4)
    assert [p.label for p in got[:4]] == [
        "rest_dia - rest_sys", "stress_dia - stress_sys",
        "rest_dia - stress_dia", "rest_sys - stress_sys",
    ]


def test_from_file_full_defaults_matches_jax():
    """The vendored pullbacks at the canonical defaults (step 0.5, range
    90, smooth, postprocessing)."""
    args = (str(FIXTURES / "ivus_rest"), str(FIXTURES / "ivus_stress"))
    got = _quiet(mt.from_file_full, *args, write_obj=False)
    want = _quiet(mj.from_file_full, *args, write_obj=False)
    _assert_result_close(got, want, 4)


def _ring_datas(pkg):
    """Four pullbacks of 72-fold symmetric rings: the between cost repeats
    every 5 degrees, so every between search over +/-6 degrees is a near-tie
    whose slots are flagged and re-decided by the repair."""
    th = np.linspace(0.0, 2.0 * math.pi, 72, endpoint=False)
    datas = []
    for g in range(4):
        rows = []
        for f in range(2):
            a = math.radians(1.3 * f + 2.1 * g)
            rows.append(np.column_stack([
                np.full(72, f), 4.5 + 1.5 * np.cos(th + a),
                4.5 + 1.5 * np.sin(th + a), np.full(72, f * 0.4),
            ]))
        datas.append(pkg.numpy_to_inputdata(
            np.concatenate(rows), np.array([0, 7.0, 4.5 + 0.1 * g, 0.0]),
            g % 2 == 0, label=f"r{g}",
        ))
    return datas


def test_between_repair_bruteforce_follows_jax(monkeypatch):
    """How ``bruteforce`` reaches the between stages, as in the JAX package
    (a reference behaviour kept on purpose):

    - the between searches resolve their plan from (step, range) alone, so
      at step 0.01 / range 6 they run the ladder even with
      ``bruteforce=True``;
    - the full path repairs flagged between slots with the caller's
      ``bruteforce`` (the JAX package's exact re-decision,
      entry.py:575-580 there), so here with the single brute-force sweep;
    - the pair paths repair with ``bruteforce=False`` (its
      ``_between_stage_deferred``, entry.py:203-209 there).

    Every slot of this fixture is flagged, so the port's per-slot repair
    re-decides the same slots as the JAX package's whole-stage one."""
    calls = []
    repair = t_ab.repair_between

    def spy(rot, ties, clouds, step, rng, bruteforce):
        out = repair(rot, ties, clouds, step, rng, bruteforce)
        calls.append((ties.copy(), bruteforce, out, clouds))
        return out

    monkeypatch.setattr(t_ab, "repair_between", spy)
    kw = dict(step_rotation_deg=0.01, range_rotation_deg=6.0, sample_size=72,
              n_points=0, write_obj=False, smooth=False, postprocessing=False,
              bruteforce=True)
    got = _quiet(mt.from_array_full, *_ring_datas(mt), **kw)
    assert [c[1] for c in calls] == [True, True]
    assert all(c[0].all() for c in calls)
    # on this fixture the choice matters: stage 1's first slot lands on the
    # brute-force sweep's answer, which the ladder would not give
    ref, tgt = calls[0][3][0]
    pivot = ref.mean(axis=0)
    brute = t_rep.exact_ladder(tgt - pivot, ref - pivot, 0.01, 6.0, True)
    ladder = t_rep.exact_ladder(tgt - pivot, ref - pivot, 0.01, 6.0, False)
    assert calls[0][2][0] == brute
    assert abs(math.degrees(brute - ladder)) > 1.0
    for orchestration in ("fused", "fallback"):
        want = _jax(monkeypatch, orchestration, mj.from_array_full,
                    *_ring_datas(mj), **kw)
        _assert_result_close(got, want, 4)

    calls.clear()
    got = _quiet(mt.from_array_singlepair, *_ring_datas(mt)[:2], **kw)
    assert [c[1] for c in calls] == [False] and calls[0][0].all()
    want = _jax(monkeypatch, "fallback", mj.from_array_singlepair,
                *_ring_datas(mj)[:2], **kw)
    _assert_result_close(got, want, 1)


def _mixed_datas(pkg):
    """Two of the symmetric rings, then two ellipses: stage 1 flags the
    rings' slot and certifies the ellipses' slot."""
    th = np.linspace(0.0, 2.0 * math.pi, 72, endpoint=False)
    datas = _ring_datas(pkg)[:2]
    for g in (2, 3):
        rows = []
        for f in range(2):
            a = math.radians(1.3 * f + 2.1 * g)
            x, y = (2.0 + 0.05 * g) * np.cos(th), 1.2 * np.sin(th)
            rows.append(np.column_stack([
                np.full(72, f), 4.5 + x * math.cos(a) - y * math.sin(a),
                4.5 + x * math.sin(a) + y * math.cos(a), np.full(72, f * 0.4),
            ]))
        datas.append(pkg.numpy_to_inputdata(
            np.concatenate(rows), np.array([0, 7.0, 4.5 + 0.1 * g, 0.0]),
            g % 2 == 0, label=f"r{g}",
        ))
    return datas


def test_between_repair_mixed_flags_follows_jax(monkeypatch):
    """``bruteforce=True`` at step 0.01 / range 6 (the ladder plan) with one
    stage-1 slot flagged and the other certified.

    When any slot flags, the JAX full path re-decides all four slots with
    the exact brute-force sweep; the port re-decides only the flagged ones
    and keeps the ladder's answer for the rest (ROADMAP C.1).  The two agree
    here because the certified slot's ladder winner is the brute-force
    sweep's, which this test checks.  Not covered: a certified slot whose
    ladder winner differs from the brute-force sweep's, where the port and
    the JAX package differ by design."""
    calls = []
    repair = t_ab.repair_between

    def spy(rot, ties, clouds, step, rng, bruteforce):
        out = repair(rot, ties, clouds, step, rng, bruteforce)
        calls.append((ties.copy(), out, clouds))
        return out

    monkeypatch.setattr(t_ab, "repair_between", spy)
    kw = dict(step_rotation_deg=0.01, range_rotation_deg=6.0, sample_size=72,
              n_points=0, write_obj=False, smooth=False, postprocessing=False,
              bruteforce=True)
    got = _quiet(mt.from_array_full, *_mixed_datas(mt), **kw)
    ties, rot, clouds = calls[0]
    assert ties.tolist() == [True, False]
    ref, tgt = clouds[1]
    pivot = ref.mean(axis=0)
    brute = t_rep.exact_ladder(tgt - pivot, ref - pivot, 0.01, 6.0, True)
    ladder = t_rep.exact_ladder(tgt - pivot, ref - pivot, 0.01, 6.0, False)
    assert brute == ladder and abs(math.degrees(rot[1] - brute)) <= 1e-12
    for orchestration in ("fused", "fallback"):
        want = _jax(monkeypatch, orchestration, mj.from_array_full,
                    *_mixed_datas(mj), **kw)
        _assert_result_close(got, want, 4)


def test_full_stage2_reads_stage1_geometries(monkeypatch):
    """Stage 2 searches clouds built from the geometries stage 1 moved:
    slot (b, d) sees d after its move onto c, and the stage-1 pairs keep
    copies taken before stage 2 moves c and d again."""
    seen = []
    stage = t_ab.between_stage

    def spy(pairs_defs, *args, **kwargs):
        before = [
            (A.frames[0].lumen.xyz_view().copy(), B.frames[0].lumen.xyz_view().copy())
            for A, B in pairs_defs
        ]
        out = stage(pairs_defs, *args, **kwargs)
        seen.append((pairs_defs, before, out))
        return out

    monkeypatch.setattr(t_ab, "between_stage", spy)
    ab, cd, ac, bd, _logs = _quiet(
        mt.from_array_full, *_make_datas(mt), step_rotation_deg=1.0,
        range_rotation_deg=10.0, write_obj=False, postprocessing=False,
    )
    (s1_defs, _, s1_out), (s2_defs, s2_before, _) = seen
    (a, b), (c, d) = s1_defs
    assert s2_defs[0] == (a, c) and s2_defs[1] == (b, d)
    # d as stage 2 found it is d as stage 1 left it, i.e. the stage-1 pair
    np.testing.assert_array_equal(
        s2_before[1][1], s1_out[0][1].geom_b.frames[0].lumen.xyz_view()
    )
    np.testing.assert_array_equal(
        cd.geom_b.frames[0].lumen.xyz_view(), s2_before[1][1]
    )
    # ... and stage 2 moved it on: the returned pair holds the new copy
    assert not np.array_equal(
        bd.geom_b.frames[0].lumen.xyz_view(), cd.geom_b.frames[0].lumen.xyz_view()
    )
