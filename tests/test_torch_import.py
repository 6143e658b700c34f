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
)


@pytest.mark.parametrize("name", _ENTRY_POINTS)
def test_entry_point_exported_with_jax_signature(name):
    """Each entry point is exported and takes the JAX package's parameters,
    in its order, with its defaults."""
    import inspect

    import multimodars_torch as mt
    import multimodars_tpu as mj

    assert name in mt.__all__
    got = inspect.signature(getattr(mt, name)).parameters
    want = inspect.signature(getattr(mj, name)).parameters
    assert [(p.name, p.default) for p in got.values()] == [
        (p.name, p.default) for p in want.values()
    ]


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
    assert config.device.type == ("cuda" if torch.cuda.is_available() else "cpu")
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
    from multimodars_torch.config import default_dtype_for

    monkeypatch.delenv("MMTPU_COMPUTE_DTYPE")
    assert default_dtype_for(torch.device("cuda")) == torch.float32
    assert default_dtype_for(torch.device("cpu")) == torch.float64


def test_to_device_is_contiguous_in_dtype():
    from multimodars_torch.config import config
    from multimodars_torch.utils.device import to_device

    a = np.zeros((4, 6, 3))[:, ::2, :2]  # a strided view
    t = to_device(a, torch.float32)
    assert t.is_contiguous() and t.dtype == torch.float32
    assert t.device == config.device and tuple(t.shape) == (4, 3, 2)
