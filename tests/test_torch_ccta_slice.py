"""The CCTA fusion slice of the PyTorch port end to end, against the JAX
package: ``label`` -> ``scale`` -> ``stitch`` -> ``export_section_stl`` /
``create_wall_mesh`` on the 6,406-vertex anomalous-RCA case (the CCTA
fusion benchmark's ``build_case(scale=1)``, rebuilt in tests/ccta_case.py).

The JAX package runs on the CPU in float64 under both of its
orchestrations: its default, and ``MMTPU_CCTA_RESIDENT=1`` (vertex
residency and index-shipping count waves).  The port runs on the CPU in
float64.  Region index arrays and public point lists must be identical,
scalings identical, stitched faces identical with vertices within 1e-9 mm,
and STL files byte-identical.
"""

import contextlib
import io
import os

import numpy as np
import pytest

import ccta_case
import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch.ccta import regions as tregions
from multimodars_tpu.ccta import regions as jregions
from native_route import one_native_route  # noqa: F401  (fixture)

ORCHESTRATIONS = ["default", "resident"]
_RUNS = {}


@pytest.fixture(autouse=True)
def _on_cpu(one_native_route):  # noqa: F811
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU, with one native route for both packages."""
    with mt.config.use(device="cpu"):
        yield


def _slice(which):
    """(labelled, scaled, stitched, scalings) of one package's run, cached
    for the module: ``which`` is "torch" or a JAX orchestration."""
    if which in _RUNS:
        return _RUNS[which]
    pkg = mt if which == "torch" else mj
    saved = os.environ.get("MMTPU_CCTA_RESIDENT")
    if which == "resident":
        os.environ["MMTPU_CCTA_RESIDENT"] = "1"
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            labelled, scaled, stitched = ccta_case.run_slice(pkg, 1)
            _, cl_ao, cl_rca, _, geom = ccta_case.build_case(pkg, 1)
            rca_cl = pkg.numpy_to_centerline(cl_rca)
            ao_cl = pkg.numpy_to_centerline(cl_ao)
            fixed = dict(labelled)
            scalings = (
                *pkg.find_distal_and_proximal_scaling(geom.frames, rca_cl, dict(fixed)),
                pkg.find_aorta_scaling(geom.frames, ao_cl, dict(fixed)),
                pkg.find_aortic_wall_scaling(geom.frames, ao_cl, dict(fixed)),
            )
    finally:
        if saved is None:
            os.environ.pop("MMTPU_CCTA_RESIDENT", None)
        else:
            os.environ["MMTPU_CCTA_RESIDENT"] = saved
    _RUNS[which] = dict(labelled=labelled, scaled=scaled, stitched=stitched,
                        scalings=scalings, rca_cl=rca_cl, ao_cl=ao_cl, geom=geom)
    return _RUNS[which]


def _pair(orchestration):
    return _slice("torch"), _slice(orchestration)


LABEL_KEYS = ("aorta_points", "rca_points", "lca_points", "rca_removed_points",
              "lca_removed_points", "proximal_points", "distal_points", "anomalous_points")


@pytest.mark.parametrize("orchestration", ORCHESTRATIONS)
def test_label_regions_match_jax(orchestration):
    got, want = _pair(orchestration)
    for key in LABEL_KEYS:
        g = tregions.get_idx(got["labelled"], key)
        w = jregions.get_idx(want["labelled"], key)
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert len(jregions.get_idx(want["labelled"], "anomalous_points")) > 0


@pytest.mark.parametrize("orchestration", ORCHESTRATIONS)
def test_label_public_lists_match_jax(orchestration):
    got, want = _pair(orchestration)
    for key in LABEL_KEYS:
        assert got["labelled"][key] == want["labelled"][key], key


@pytest.mark.parametrize("orchestration", ORCHESTRATIONS)
def test_scalings_match_jax(orchestration):
    """Proximal, distal, aortic and aortic-wall scalings, equal."""
    got, want = _pair(orchestration)
    assert got["scalings"] == want["scalings"]
    assert all(np.isfinite(s) for s in want["scalings"])


@pytest.mark.parametrize("orchestration", ORCHESTRATIONS)
def test_scaled_mesh_and_regions_match_jax(orchestration):
    got, want = _pair(orchestration)
    g, w = got["scaled"], want["scaled"]
    np.testing.assert_array_equal(g["mesh"].vertices, w["mesh"].vertices)
    np.testing.assert_array_equal(g["mesh"].faces, w["mesh"].faces)
    for key in LABEL_KEYS:
        assert g[key] == w[key], key


@pytest.mark.parametrize("orchestration", ORCHESTRATIONS)
def test_stitched_mesh_matches_jax(orchestration):
    got, want = _pair(orchestration)
    g, w = got["stitched"], want["stitched"]
    np.testing.assert_array_equal(g["mesh"].faces, w["mesh"].faces)
    np.testing.assert_allclose(g["mesh"].vertices, w["mesh"].vertices, rtol=0.0, atol=1e-9)
    for key in ("prox_boundary_points", "dist_boundary_points", "anomalous_points",
                "rca_points"):
        np.testing.assert_allclose(np.asarray(g[key]), np.asarray(w[key]),
                                   rtol=0.0, atol=1e-9, err_msg=key)
    assert g["mesh"].is_watertight == w["mesh"].is_watertight


@pytest.mark.parametrize("stage, kind", [
    ("scaled", "all"), ("scaled", "aorta"), ("scaled", "rca"), ("scaled", "lca"),
    ("stitched", "all"),
])
def test_export_section_stl_bytes_match_jax(tmp_path, stage, kind):
    got, want = _pair("default")
    mt.export_section_stl(got[stage], kind, tmp_path / "torch")
    mj.export_section_stl(want[stage], kind, tmp_path / "jax")
    data = (tmp_path / "torch" / f"{kind}.stl").read_bytes()
    assert len(data) > 84
    assert data == (tmp_path / "jax" / f"{kind}.stl").read_bytes()


def test_create_wall_mesh_matches_jax():
    got, want = _pair("default")
    with contextlib.redirect_stdout(io.StringIO()):
        g = mt.create_wall_mesh(got["geom"].frames, got["ao_cl"], got["rca_cl"],
                                got["rca_cl"], dict(got["scaled"]), coronary_scaling=0.2)
        w = mj.create_wall_mesh(want["geom"].frames, want["ao_cl"], want["rca_cl"],
                                want["rca_cl"], dict(want["scaled"]), coronary_scaling=0.2)
    np.testing.assert_array_equal(g["mesh"].faces, w["mesh"].faces)
    np.testing.assert_allclose(g["mesh"].vertices, w["mesh"].vertices, rtol=0.0, atol=1e-9)


def test_label_branches_matches_jax():
    got, want = _pair("default")
    with contextlib.redirect_stdout(io.StringIO()):
        g = mt.label_branches(got["rca_cl"], dict(got["labelled"]), "rca_points", 0, 3.0)
        w = mj.label_branches(want["rca_cl"], dict(want["labelled"]), "rca_points", 0, 3.0)
    for key in ("rca_points_main", "rca_points_side"):
        assert g[key] == w[key], key
