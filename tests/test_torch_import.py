"""The PyTorch port stands alone: it imports without JAX and without the
JAX package, and its config follows the documented device/dtype policy."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises
import multimodars_torch
from multimodars_torch.pipelines import align_between, postprocess, to_object
from multimodars_torch.pipelines.entry import (
    cohort_processing, double_pair_processing, full_processing, pair_processing,
)
from multimodars_torch.pipelines import centerline_align
from multimodars_torch.ops import _cuda_build, hausdorff_batch
from multimodars_torch import ccta
from multimodars_torch.ops import morph_sweep, nearest, radius_count
from multimodars_torch.parallel import cohort
for m in pkgutil.walk_packages(multimodars_torch.__path__, "multimodars_torch."):
    __import__(m.name)
bad = sorted(
    n for n in sys.modules
    if (n == "jax" and sys.modules[n] is not None)
    or n.startswith("jax.") or n.startswith("multimodars_tpu")
)
assert not bad, bad
# the PNG textures of the OBJ export import Pillow only when written
assert "PIL" not in sys.modules
print("ok", len([n for n in sys.modules if n.startswith("multimodars_torch")]))
"""


def test_port_imports_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


_ENTRY_POINTS = (
    "from_array_single", "from_file_single",
    "from_array_singlepair", "from_file_singlepair",
    "from_array_doublepair", "from_file_doublepair",
    "from_array_full", "from_file_full",
    "from_array_cohort", "align_three_point", "align_manual", "align_combined",
    "to_obj", "read_centerline_vtp",
    "to_array", "numpy_to_geometry", "numpy_to_centerline", "numpy_to_inputdata",
    "array_to_pyinputdata", "geometry_to_frames_array",
    # the CCTA mesh-fusion toolkit
    "label", "scale", "stitch", "export_section_stl", "create_wall_mesh",
    "label_geometry", "label_anomalous_region", "label_branches",
    "scale_region_centerline_morphing", "find_distal_and_proximal_scaling",
    "find_aorta_scaling", "find_aortic_wall_scaling",
    "remove_labeled_points_from_mesh", "keep_labeled_points_from_mesh",
    "sync_results_to_mesh", "stitch_ccta_to_intravascular",
    "fix_and_remesh_stitched_mesh", "postprocess_stitched_mesh", "manual_hole_fill",
    "plot_results_key", "plot_centerline_edges", "plot_sharp_angles",
    "remove_occluded_points_ray_triangle", "adjust_diameter_centerline_morphing_simple",
    "find_points_by_cl_region", "clean_outlier_points", "find_aortic_points",
    "find_faces_near_points", "final_reclassification", "fix_mesh_winding",
    "smooth_mesh_labels", "find_centerline_bounded_points_simple",
    "find_proximal_distal_scaling", "build_adjacency_map",
    "read_geometrical", "write_geometries", "geometry_to_trimesh",
)


def _parameters(fn):
    import inspect

    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", _ENTRY_POINTS)
def test_entry_point_exported_with_jax_signature(name):
    """Each entry point is exported and takes the JAX package's parameters,
    in its order, with its defaults; an exported module (the I/O helpers)
    has the JAX module's public functions with their parameters."""
    import inspect

    import multimodars_torch as mt
    import multimodars_tpu as mj

    assert name in mt.__all__
    got, want = getattr(mt, name), getattr(mj, name)
    if inspect.ismodule(want):
        assert inspect.ismodule(got)
        public = [n for n, v in vars(want).items()
                  if inspect.isfunction(v) and v.__module__ == want.__name__
                  and not n.startswith("_")]
        assert public
        for fn in public:
            assert _parameters(getattr(got, fn)) == _parameters(getattr(want, fn)), fn
        return
    assert _parameters(got) == _parameters(want)


def test_every_jax_export_but_discretization_is_exported():
    """The port exports every public name of the JAX package except the
    discretization slice, which is not ported yet."""
    import multimodars_torch as mt
    import multimodars_tpu as mj

    missing = sorted(set(mj.__all__) - set(mt.__all__))
    assert missing == sorted([
        "PyDiscretizedVesselTree", "discretize_vessel", "prepare_centerlines",
        "discretize_vessel_tree", "find_sharp_angles",
    ])


_MODEL_CLASSES = (
    "PyContourPoint", "PyContour", "PyFrame", "PyGeometry", "PyGeometryPair",
    "PyCenterline", "PyCenterlinePoint", "PyInputData", "PyRecord",
    "PyContourType",
)


@pytest.mark.parametrize("name", _MODEL_CLASSES)
def test_model_class_exported(name):
    import multimodars_torch as mt
    from multimodars_torch import models

    assert name in mt.__all__
    assert getattr(mt, name) is getattr(models, name)


def test_port_sources_name_no_jax():
    offenders = []
    for path in sorted((REPO / "multimodars_torch").rglob("*")):
        if path.suffix not in (".py", ".cu") or "_build" in path.parts:
            continue
        text = path.read_text()
        if "import jax" in text or "from jax" in text or "multimodars_tpu" in text:
            offenders.append(str(path.relative_to(REPO)))
    assert offenders == []


def test_config_policy():
    from multimodars_torch.config import config, default_dtype_for, torch_dtype

    # tests/conftest.py pins MMTPU_COMPUTE_DTYPE=float64 for the process
    assert os.environ.get("MMTPU_COMPUTE_DTYPE") == "float64"
    assert default_dtype_for(torch.device("cuda")) == torch.float64
    # the card is the default whether or not one is present
    assert config.device == torch.device("cuda")
    assert torch_dtype("float32") is torch.float32
    assert torch_dtype(np.float64) is torch.float64
    with pytest.raises(ValueError):
        torch_dtype("float16")
    saved = (config.device, config.compute_dtype)
    with config.use(device="cpu", dtype="float32"):
        assert config.compute_dtype is torch.float32
        assert config.device == torch.device("cpu")
    assert (config.device, config.compute_dtype) == saved


def test_config_defaults_without_env(monkeypatch):
    from multimodars_torch.config import config, default_dtype_for

    monkeypatch.delenv("MMTPU_COMPUTE_DTYPE")
    assert default_dtype_for(torch.device("cuda")) == torch.float32
    assert default_dtype_for(torch.device("cpu")) == torch.float64
    # a dtype nobody set follows the device asked for
    assert config.compute_dtype == torch.float32
    with config.use(device="cpu"):
        assert config.compute_dtype == torch.float64
        with config.use(dtype="float32"):
            assert config.compute_dtype == torch.float32


def test_to_device_is_contiguous_in_dtype():
    from multimodars_torch.config import config
    from multimodars_torch.utils.device import to_device

    a = np.zeros((4, 6, 3))[:, ::2, :2]  # a strided view
    with config.use(device="cpu"):
        t = to_device(a, torch.float32)
        assert t.is_contiguous() and t.dtype == torch.float32
        assert t.device == config.device and tuple(t.shape) == (4, 3, 2)


def _tiny_pullback(n_frames=4, n_points=24):
    theta = np.linspace(0.0, 2.0 * np.pi, n_points, endpoint=False)
    rows = []
    for f in range(n_frames):
        x = 4.5 + (2.0 + 0.05 * f) * np.cos(theta + 0.02 * f)
        y = 4.5 + 1.4 * np.sin(theta + 0.02 * f)
        rows.append(np.stack(
            [np.full(n_points, f), x, y, np.full(n_points, 0.2 * f)], -1))
    return np.concatenate(rows), np.array([0, 7.5, 4.5, 0.0])


def test_no_card_and_no_ask_raises(monkeypatch):
    """Without a card and without an explicit ask for the CPU, an entry
    point raises at its first transfer instead of running on the CPU."""
    import multimodars_torch as mt
    from multimodars_torch.utils.device import to_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mt.config.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match=r'set_device\("cpu"\)'):
        to_device(np.zeros(3))
    lumen, ref = _tiny_pullback()
    data = mt.numpy_to_inputdata(lumen, ref, True)
    with pytest.raises(RuntimeError, match="found none"):
        mt.from_array_single(data, step_rotation_deg=1.0,
                             range_rotation_deg=5.0, write_obj=False)


@pytest.mark.parametrize("ask", ["set_device", "use"])
def test_cpu_runs_when_asked(monkeypatch, ask):
    """Asked for the CPU (either way the policy names), the same call runs
    there, and the default comes back afterwards."""
    import multimodars_torch as mt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lumen, ref = _tiny_pullback()
    kw = dict(step_rotation_deg=1.0, range_rotation_deg=5.0, write_obj=False)
    data = mt.numpy_to_inputdata(lumen, ref, True)
    if ask == "set_device":
        mt.config.set_device("cpu")
        try:
            geom, logs = mt.from_array_single(data, **kw)
        finally:
            mt.config.set_device("cuda")
    else:
        with mt.config.use(device="cpu"):
            geom, logs = mt.from_array_single(data, **kw)
    assert len(logs) == 3 and len(geom.frames) == 4
    assert mt.config.device == torch.device("cuda")
