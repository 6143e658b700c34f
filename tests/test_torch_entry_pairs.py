"""The pair and double-pair pipelines of the PyTorch port, and the OBJ
export of all three pair-producing pipelines, against the JAX package on the
same inputs.

Both run in float64 on the CPU (tests/conftest.py pins the compute dtype).
Rotation logs must agree to 1e-12 degrees, translations and every output
coordinate to 1e-9 mm, with equal labels, frame ids and frame counts.
"""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import multimodars_torch as mt
import multimodars_tpu as mj
from native_route import native_route  # noqa: F401  (fixture)


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
    """``n`` seeded 12-frame x 40-point pullbacks (the JAX package's
    tests/test_fused_chain.py recipe, at its seed); ``anomalous=True`` gives
    an elliptic ratio above 2."""
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


def _assert_result_close(got, want, n_pairs):
    assert len(got) == len(want) == n_pairs + 1
    for g_pair, w_pair in zip(got[:n_pairs], want[:n_pairs]):
        assert g_pair.label == w_pair.label
        _assert_geometry_close(g_pair.geom_a, w_pair.geom_a)
        _assert_geometry_close(g_pair.geom_b, w_pair.geom_b)
    assert len(got[n_pairs]) == len(want[n_pairs])
    for g_logs, w_logs in zip(got[n_pairs], want[n_pairs]):
        g, w = np.array(g_logs, dtype=float), np.array(w_logs, dtype=float)
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_array_equal(g[:, :2], w[:, :2])
        np.testing.assert_allclose(g[:, 2], w[:, 2], rtol=0.0, atol=1e-12)
        np.testing.assert_allclose(g[:, 3:], w[:, 3:], rtol=0.0, atol=1e-9)


def _jax(monkeypatch, orchestration, fn, *args, **kwargs):
    if orchestration == "fallback":
        monkeypatch.setenv("MMTPU_NO_FUSED_CHAIN", "1")
    else:
        monkeypatch.delenv("MMTPU_NO_FUSED_CHAIN", raising=False)
    return _quiet(fn, *args, **kwargs)


@pytest.mark.parametrize("orchestration", ["fused", "fallback"])
@pytest.mark.parametrize("postprocessing", [False, True])
@pytest.mark.parametrize("anomalous", [False, True])
def test_from_array_doublepair_matches_jax(
    monkeypatch, anomalous, postprocessing, orchestration
):
    kw = dict(write_obj=False, postprocessing=postprocessing)
    got = _quiet(mt.from_array_doublepair, *_make_datas(mt, anomalous=anomalous), **kw)
    want = _jax(monkeypatch, orchestration, mj.from_array_doublepair,
                *_make_datas(mj, anomalous=anomalous), **kw)
    _assert_result_close(got, want, 2)
    assert [p.label for p in got[:2]] == ["g0 - g1", "g2 - g3"]


@pytest.mark.parametrize("orchestration", ["fused", "fallback"])
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("anomalous", [False, True])
def test_from_array_singlepair_matches_jax(
    monkeypatch, anomalous, smooth, orchestration
):
    kw = dict(write_obj=False, smooth=smooth)
    got = _quiet(mt.from_array_singlepair,
                 *_make_datas(mt, n=2, anomalous=anomalous), **kw)
    want = _jax(monkeypatch, orchestration, mj.from_array_singlepair,
                *_make_datas(mj, n=2, anomalous=anomalous), **kw)
    _assert_result_close(got, want, 1)


def test_catheter_start_roll_follows_the_last_ulp(monkeypatch):
    """A fault of the reference's finish that the port meets (ROADMAP C).

    On this input the JAX package's within search returns some grid angles
    one ulp away from the port's: XLA contracts ``start + i * step`` into a
    fused multiply-add, while the port (like the exact host tier and the
    reference's f64 loop) rounds the product first.  In frame 2 of the
    second pullback the two highest points of the synthesized catheter ring
    then lie within an ulp of each other in y, and the CCW re-sort starts
    that contour at the other one: the same points, shifted by one place.
    Fed the JAX package's angles, the port reproduces its output."""
    from multimodars_tpu.pipelines import align_within as j_aw

    from multimodars_torch.pipelines import align_within as t_aw

    deltas = []
    finish = j_aw._finish_alignment_tensor_coords

    def spy(tg, delta, *args, **kwargs):
        deltas.append(np.array(delta, dtype=np.float64))
        return finish(tg, delta, *args, **kwargs)

    monkeypatch.setattr(j_aw, "_finish_alignment_tensor_coords", spy)
    want = _jax(monkeypatch, "fallback", mj.from_array_singlepair,
                *_make_datas(mj, n=2, seed=5), write_obj=False)
    got = _quiet(mt.from_array_singlepair, *_make_datas(mt, n=2, seed=5),
                 write_obj=False)
    g_logs, w_logs = np.array(got[1][1]), np.array(want[1][1])
    assert 0 < np.count_nonzero(g_logs[:, 2] != w_logs[:, 2])
    np.testing.assert_allclose(g_logs[:, 2], w_logs[:, 2], rtol=0.0, atol=1e-12)
    g_cat = got[0].geom_b.frames[2].extras["Catheter"].xyz_view()
    w_cat = want[0].geom_b.frames[2].extras["Catheter"].xyz_view()
    assert np.abs(g_cat - w_cat).max() > 0.1
    shifted = [np.abs(np.roll(g_cat, s, axis=0) - w_cat).max() for s in (-1, 1)]
    assert min(shifted) < 1e-9

    def search_with_jax_angles(*args, **kwargs):
        angles = np.concatenate(deltas)
        return torch.tensor(np.concatenate([angles, np.zeros_like(angles)]))

    monkeypatch.setattr(t_aw, "multires_rotation_search_packed",
                        search_with_jax_angles)
    got = _quiet(mt.from_array_singlepair, *_make_datas(mt, n=2, seed=5),
                 write_obj=False)
    _assert_result_close(got, want, 1)


def test_start_roll_pairs_follow_the_exact_ladder(monkeypatch):
    """The start-roll divergence above is one between the JAX package's own
    two tiers (ROADMAP C): wherever the port's within angle differs from
    the JAX fallback orchestration's, the JAX package's exact host f64
    ladder (``argmin_repair.exact_ladder``), run on the centred sets the
    port searched, returns the port's angle."""
    from multimodars_tpu.ops.argmin_repair import exact_ladder
    from multimodars_tpu.pipelines import align_within as j_aw

    from multimodars_torch.pipelines import align_within as t_aw

    j_deltas, t_deltas, t_sets = [], [], []
    j_finish = j_aw._finish_alignment_tensor_coords
    t_finish = t_aw._finish_alignment_tensor
    t_search = t_aw.multires_rotation_search_packed

    def j_spy(tg, delta, *args, **kwargs):
        j_deltas.append(np.array(delta, dtype=np.float64))
        return j_finish(tg, delta, *args, **kwargs)

    def t_spy(tg, delta, *args, **kwargs):
        t_deltas.append(np.array(delta, dtype=np.float64))
        return t_finish(tg, delta, *args, **kwargs)

    def search_spy(test, ref, tmask, rmask, *args, **kwargs):
        t_sets.append(tuple(None if x is None else x.cpu().numpy()
                            for x in (test, ref, tmask, rmask)))
        return t_search(test, ref, tmask, rmask, *args, **kwargs)

    monkeypatch.setattr(j_aw, "_finish_alignment_tensor_coords", j_spy)
    monkeypatch.setattr(t_aw, "_finish_alignment_tensor", t_spy)
    monkeypatch.setattr(t_aw, "multires_rotation_search_packed", search_spy)
    _jax(monkeypatch, "fallback", mj.from_array_singlepair,
         *_make_datas(mj, n=2, seed=5), write_obj=False)
    _quiet(mt.from_array_singlepair, *_make_datas(mt, n=2, seed=5),
           write_obj=False)

    assert len(t_sets) == 1  # one batched within search over both pullbacks
    test, ref, tmask, rmask = t_sets[0]
    port, jax_ = np.concatenate(t_deltas), np.concatenate(j_deltas)
    assert port.shape == jax_.shape == (test.shape[0],)
    differ = np.nonzero(port != jax_)[0]
    assert len(differ) > 0
    for i in differ:
        t = test[i] if tmask is None else test[i][tmask[i]]
        r = ref[i] if rmask is None else ref[i][rmask[i]]
        exact = exact_ladder(t.astype(np.float64), r.astype(np.float64),
                             0.5, 90.0, False)
        assert abs(exact - port[i]) <= 1e-15, (i, exact, port[i], jax_[i])


@pytest.mark.parametrize("postprocessing", [False, True])
def test_from_file_doublepair_matches_jax(postprocessing):
    args = (str(FIXTURES / "ivus_rest"), str(FIXTURES / "ivus_stress"))
    kw = dict(step_rotation_deg=1.0, range_rotation_deg=10.0, write_obj=False,
              postprocessing=postprocessing)
    got = _quiet(mt.from_file_doublepair, *args, **kw)
    want = _quiet(mj.from_file_doublepair, *args, **kw)
    _assert_result_close(got, want, 2)


@pytest.mark.parametrize("fixture", ["ivus_rest", "ivus_stress", "idealized_geometry"])
def test_from_file_singlepair_matches_jax(fixture):
    """``idealized_geometry`` carries EEM, calcium and side-branch contours
    as well."""
    kw = dict(labels=["dia", "sys"], step_rotation_deg=1.0,
              range_rotation_deg=10.0, write_obj=False)
    got = _quiet(mt.from_file_singlepair, str(FIXTURES / fixture), **kw)
    want = _quiet(mj.from_file_singlepair, str(FIXTURES / fixture), **kw)
    _assert_result_close(got, want, 1)
    assert got[0].label == "dia - sys"


def _written(root):
    return {
        p.relative_to(root).as_posix(): p.read_bytes()
        for p in sorted(root.rglob("*")) if p.is_file()
    }


_DIRS = {"full": ("ab", "cd", "ac", "bd"), "doublepair": ("ab", "cd"),
         "singlepair": ("pair",)}


def _write(pkg, mode, out, kw):
    """Run ``mode`` with OBJ export into ``out/<pair>``; returns the pairs."""
    if mode == "singlepair":
        return _quiet(pkg.from_array_singlepair, *_make_datas(pkg, n=2),
                      output_path=str(out / "pair"), **kw)[:1]
    paths = {f"output_path_{k}": str(out / k) for k in _DIRS[mode]}
    fn = pkg.from_array_full if mode == "full" else pkg.from_array_doublepair
    return _quiet(fn, *_make_datas(pkg), **paths, **kw)[: len(paths)]


def _split_obj(data):
    """(vertex and normal coordinates, every other line) of an OBJ file."""
    lines = data.decode().splitlines()
    numeric = [ln for ln in lines if ln.startswith(("v ", "vn "))]
    values = np.array([[float(v) for v in ln.split()[1:]] for ln in numeric])
    kinds = [ln.split()[0] for ln in numeric]
    return values, kinds, [ln for ln in lines if not ln.startswith(("v ", "vn "))]


@pytest.mark.parametrize("mode", ["full", "doublepair", "singlepair"])
def test_write_obj_matches_jax(tmp_path, mode, native_route):
    """``write_obj=True``, with both packages pinned to one writer route:
    the native library's (the port's build) or the Python writer's.

    The port's writer is the JAX package's: given the port's pairs, the JAX
    package's ``process_case`` writes byte-identical OBJ, MTL and PNG files.
    Against the JAX package's own run, the files have the same names, the
    MTL files the same bytes and the OBJ files the same lines, with vertex
    coordinates within 1e-9 mm and normals within 1e-9: the OBJ writer
    prints full precision, and
    the two searches may return grid angles an ulp apart (XLA contracts
    the grid's multiply-add), which moves the last printed digit."""
    from multimodars_tpu.pipelines import to_object as j_to_object

    kw = dict(step_rotation_deg=1.0, range_rotation_deg=10.0,
              interpolation_steps=2, write_obj=True)
    pairs = _write(mt, mode, tmp_path / "torch", kw)
    _write(mj, mode, tmp_path / "jax", kw)
    got, want = _written(tmp_path / "torch"), _written(tmp_path / "jax")
    assert got.keys() == want.keys()
    assert any(name.endswith(".obj") for name in want)
    for name in want:
        if name.endswith(".mtl"):
            assert got[name] == want[name], name
        elif name.endswith(".obj"):
            g_vals, g_kinds, g_rest = _split_obj(got[name])
            w_vals, w_kinds, w_rest = _split_obj(want[name])
            assert g_rest == w_rest and g_kinds == w_kinds, name
            np.testing.assert_allclose(g_vals, w_vals, rtol=0.0, atol=1e-9,
                                       err_msg=name)

    for pair, d in zip(pairs, _DIRS[mode]):
        _quiet(j_to_object.process_case, pair.label, pair,
               str(tmp_path / "jax_writer" / d), 2, True,
               ["Lumen", "Catheter", "Wall"])
        assert _written(tmp_path / "jax_writer" / d) == _written(tmp_path / "torch" / d)
