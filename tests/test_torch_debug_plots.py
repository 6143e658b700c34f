"""The port's CCTA debug plots against the JAX package's: the cases of
tests/test_debug_plots.py through ``multimodars_torch.ccta.debug_plots``.
The plotly branch runs on a stub ``graph_objects`` module (plotly is
optional), the textual fallback without it, and the headless scene
builder as it is.

Each case runs both packages' builders on the same inputs (each built from
its own package's centerline classes), checks the JAX test's expected
values on the port's and holds the recorded traces, printed summaries and
scenes equal.  Left out: ``test_interactive_viewer_under_xvfb``, which
needs a display and pyglet and drives trimesh's viewer, not code of either
package.
"""

import types

import numpy as np
import pytest

import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch.ccta import debug_plots as t_dp
from multimodars_tpu.ccta import debug_plots as j_dp

PACKAGES = ((mt, t_dp), (mj, j_dp))


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


def _centerline(pkg, n=8, branch=0):
    pts = []
    for i in range(n):
        cp = pkg.PyContourPoint(0, i, float(i), 0.0, float(n - i), False)
        p = pkg.PyCenterlinePoint(cp, (0.0, 0.0, -1.0))
        p.branch_id = branch
        pts.append(p)
    return pkg.PyCenterline(pts)


class _StubFig:
    def __init__(self):
        self.traces = []
        self.layout = None
        self.written = None

    def add_trace(self, t):
        self.traces.append(t)

    def update_layout(self, **kw):
        self.layout = kw

    def write_html(self, name):
        self.written = name


def _stub_go(record):
    def Figure():
        fig = _StubFig()
        record.append(fig)
        return fig

    return types.SimpleNamespace(Figure=Figure, Scatter3d=lambda **kw: kw)


def _plain(value):
    """A trace's keywords as comparable Python values."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in sorted(value.items())}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, np.ndarray):
        return value.tolist()
    return value


def _plot_both(monkeypatch, tmp_path, capsys, draw):
    """``draw(pkg, dp)`` for both packages with plotly stubbed; returns the
    port's (figures, printed text) after holding them equal to the JAX
    package's."""
    monkeypatch.chdir(tmp_path)
    out = []
    for pkg, dp in PACKAGES:
        record = []
        monkeypatch.setattr(dp, "go", _stub_go(record))
        draw(pkg, dp)
        out.append((record, capsys.readouterr().out))
    (got, got_text), (want, want_text) = out
    assert got_text == want_text
    assert [(_plain(f.traces), f.layout, f.written) for f in got] == [
        (_plain(f.traces), f.layout, f.written) for f in want]
    return got, got_text


def test_plot_results_key_builds_traces(monkeypatch, tmp_path, capsys):
    results = {"aorta_points": [(0, 0, 0), (1, 1, 1)], "rca_points": [(2, 2, 2)]}
    figs, out = _plot_both(monkeypatch, tmp_path, capsys, lambda pkg, dp: dp.plot_results_key(
        results, rca_points=True, cl_rca=_centerline(pkg)))
    assert "aorta_points: 2 points" in out
    fig = figs[0]
    names = [t["name"] for t in fig.traces]
    assert "aorta_points" in names and "rca_points" in names and "cl_rca" in names
    # centerlines render as polylines, not loose markers
    assert "lines" in fig.traces[names.index("cl_rca")]["mode"]
    assert fig.written == "plot_results_key.html"


def test_compare_centerline_scaling(monkeypatch, tmp_path, capsys):
    figs, _ = _plot_both(monkeypatch, tmp_path, capsys, lambda pkg, dp: (
        dp.compare_centerline_scaling(_centerline(pkg), _centerline(pkg))))
    assert [t["name"] for t in figs[0].traces][:2] == ["before", "after"]


def test_plot_centerline_branches_colors_branch0(monkeypatch, tmp_path, capsys):
    figs, _ = _plot_both(monkeypatch, tmp_path, capsys, lambda pkg, dp: (
        dp.plot_centerline_branches(_centerline(pkg), _centerline(pkg))))
    rca0 = next(t for t in figs[0].traces if t["name"] == "rca_branch_0")
    assert rca0["marker"]["color"] == "steelblue"


def test_plot_sharp_angles_bounds_positions(monkeypatch, tmp_path, capsys):
    figs, _ = _plot_both(monkeypatch, tmp_path, capsys, lambda pkg, dp: (
        dp.plot_sharp_angles(_centerline(pkg, 6), 0, [1, 3, 99])))  # 99: dropped
    sharp = next(t for t in figs[0].traces if t["name"] == "sharp_angles")
    assert len(sharp["x"]) == 2


def test_text_fallback_without_plotly(monkeypatch, capsys):
    outs = []
    for pkg, dp in PACKAGES:
        monkeypatch.setattr(dp, "go", None)
        assert dp.plot_centerline_edges(_centerline(pkg)) is None
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "centerline: 8 points" in outs[0]


def _results():
    return {
        "aorta_points": [(0.0, 0.0, 0.0), (1.0, 0.0, 0.0)],
        "rca_points": [(0.0, 1.0, 0.0)],
        "anomalous_points": [(2.0, 2.0, 2.0)],
        "mesh": None,
    }


def _scene_rows(scene):
    return [(g.name, list(g.color), len(g), np.asarray(g.vertices).tolist())
            for g in scene.geometries]


class TestGuardedScene:
    """Headless scene construction: geometries and colours assembled
    without a display; show() degrades to HTML."""

    def test_build_scene_collects_enabled_regions(self):
        kw = dict(aorta_points=True, rca_points=True, anomalous_points=False)
        scene = t_dp.build_results_scene(_results(), **kw)
        assert _scene_rows(scene) == _scene_rows(j_dp.build_results_scene(_results(), **kw))
        assert [g.name for g in scene.geometries] == ["aorta_points", "rca_points"]
        aorta = scene.geometries[0]
        assert aorta.color == [255, 255, 0, 255]  # yellow, like the reference
        assert len(aorta) == 2

    def test_empty_scene(self):
        for dp in (t_dp, j_dp):
            assert dp.build_results_scene({}, aorta_points=True).is_empty

    def test_show_headless_writes_html(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        monkeypatch.delenv("DISPLAY", raising=False)
        outs = []
        for dp in (t_dp, j_dp):
            dp.build_results_scene(_results()).show()
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
        assert "scene.html" in outs[0]

    def test_centerline_polylines_included(self):
        scenes = [dp.build_results_scene(_results(), cl_rca=_centerline(pkg))
                  for pkg, dp in PACKAGES]
        assert _scene_rows(scenes[0]) == _scene_rows(scenes[1])
        assert scenes[0].geometries[-1].name == "cl_rca"
        assert len(scenes[0].geometries[-1]) == 8
