"""The port's geometry preparation against the JAX package's: the cases of
tests/test_preprocessing_entry.py (the reference's processing/
preprocessing.rs:243-520) through ``multimodars_torch.pipelines.entry.
prepare_n_geometries``: input selection for single / pair / full, InputData
preferred over paths, the fallback to paths when InputData is insufficient,
and the failure cases.

Each package reads the vendored fixtures with its own ``process_directory``.
Every case checks the JAX test's expectations on the port's geometries and
holds them against the JAX package's on the same inputs: labels, frame
counts, centroids and contour coordinates equal.  The JAX package's
``prefetch`` argument has no counterpart in the port (no build-time sweep
prefetch), so it is not passed.
"""

import contextlib
import io
import re
from pathlib import Path

import numpy as np
import pytest

import multimodars_torch as mt
from multimodars_torch.io.csv_io import process_directory as t_process_directory
from multimodars_torch.pipelines.entry import prepare_n_geometries as t_prepare
from multimodars_tpu.io.csv_io import process_directory as j_process_directory
from multimodars_tpu.pipelines.entry import prepare_n_geometries as j_prepare

FIXTURES = Path(__file__).resolve().parent / "data" / "fixtures"
REST = FIXTURES / "ivus_rest"
STRESS = FIXTURES / "ivus_stress"

CENTER = (4.5, 4.5)
NAMES = {"Lumen": "lumen"}


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _inputs(specs):
    """(port InputData list, JAX InputData list) of (path, diastole, label)."""
    if specs is None:
        return None, None
    return ([_quiet(t_process_directory, p, NAMES, d, l) for p, d, l in specs],
            [_quiet(j_process_directory, p, NAMES, d, l) for p, d, l in specs])


def _summary(g):
    """Label, frame count, centroids and lumen coordinates of a geometry,
    whichever form the funnel returned (the tensor spine or PyGeometry)."""
    if hasattr(g, "n_frames"):
        return g.label, g.n_frames, np.asarray(g.centroids), g.coords["Lumen"].reshape(-1, 3)
    return (g.label, len(g.frames), np.array([f.centroid for f in g.frames]),
            np.concatenate([f.lumen.xyz_view() for f in g.frames]))


def _nframes(g):
    return g.n_frames if hasattr(g, "n_frames") else len(g.frames)


def _prepare(mode, input_data=None, path_a=None, path_b=None, labels=()):
    """The port's geometries, held against the JAX package's on the same
    inputs (or both raising the same ValueError)."""
    t_inp, j_inp = _inputs(input_data)
    args = (str(path_a) if path_a else None, str(path_b) if path_b else None, mode)
    try:
        want = _quiet(j_prepare, labels, CENTER, 0.5, 20, j_inp, True, *args, verbose=False)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            _quiet(t_prepare, labels, CENTER, 0.5, 20, t_inp, True, *args, verbose=False)
        raise
    got = _quiet(t_prepare, labels, CENTER, 0.5, 20, t_inp, True, *args, verbose=False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        (gl, gn, gc, gx), (wl, wn, wc, wx) = _summary(g), _summary(w)
        assert (gl, gn) == (wl, wn)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gx, wx)
    return got


def test_prepare_one_geometry_path():
    geoms = _prepare("single", path_a=REST)
    assert len(geoms) == 1
    assert _nframes(geoms[0]) > 0
    assert geoms[0].label == "ivus_rest"  # basename when no label given


def test_single_with_one_input_data():
    geoms = _prepare("single", input_data=[(REST, True, "mine")])
    assert len(geoms) == 1
    assert geoms[0].label == "mine"


def test_prepare_two_geometry_one_path():
    geoms = _prepare("pair", path_a=REST)
    assert len(geoms) == 2  # diastole + systole from the same directory
    assert _nframes(geoms[0]) > 0 and _nframes(geoms[1]) > 0
    z0 = list(_summary(geoms[0])[2][:, 2])
    assert z0 == sorted(z0)


def test_pair_with_two_input_data():
    geoms = _prepare("pair", input_data=[(REST, True, "dia"), (REST, False, "sys")])
    assert [g.label for g in geoms] == ["dia", "sys"]


def test_full_with_four_input_data():
    geoms = _prepare("full", input_data=[
        (REST, True, "a"), (REST, False, "b"), (STRESS, True, "c"), (STRESS, False, "d"),
    ])
    assert [g.label for g in geoms] == ["a", "b", "c", "d"]


def test_full_with_two_paths():
    geoms = _prepare("full", path_a=REST, path_b=STRESS)
    assert len(geoms) == 4
    assert all(_nframes(g) > 0 for g in geoms)


def test_prefers_input_data_over_paths():
    # both provided: the InputData label wins, proving the path was ignored
    geoms = _prepare("single", input_data=[(REST, True, "from_input")], path_a=STRESS)
    assert geoms[0].label == "from_input"


def test_insufficient_input_data_falls_back_to_paths():
    # pair needs 2 InputData; with only 1 the path is used for both phases
    geoms = _prepare("pair", input_data=[(REST, True, "only_one")], path_a=REST)
    assert len(geoms) == 2
    assert all(g.label != "only_one" for g in geoms)


def test_single_fails_with_no_inputs():
    with pytest.raises(ValueError, match="Single processing requires"):
        _prepare("single")


def test_pair_fails_with_insufficient_inputs():
    with pytest.raises(ValueError, match="Pair processing requires"):
        _prepare("pair", input_data=[(REST, True, "x")])


def test_full_fails_with_insufficient_inputs():
    # 3 InputData and only one path: neither source suffices
    with pytest.raises(ValueError, match="Full processing requires"):
        _prepare("full", input_data=[(REST, True, "a"), (REST, False, "b"),
                                     (STRESS, True, "c")], path_a=REST)
