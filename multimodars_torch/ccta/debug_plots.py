"""Debug visualisations for CCTA labeling / discretization.

Parity of surface: ``multimodars/ccta/debug_plots.py`` of the reference
(pyglet/trimesh interactive scenes + plotly figures).  Interactive viewers
are not available in headless environments, so every plot function renders
a full plotly figure when plotly is importable — written as standalone HTML
next to the cwd (open in any browser for the same rotate/zoom/toggle
experience as the reference's pyglet windows) — and degrades to a compact
textual summary otherwise.  Signatures and colour coding match the
reference so calling code ports unchanged.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

try:  # optional
    import plotly.graph_objects as go  # type: ignore
except ImportError:
    go = None

# region colours, matching the reference's point-cloud colour coding
# (debug_plots.py:34-132)
_REGION_COLORS = {
    "aorta_points": "gold",
    "rca_points": "steelblue",
    "lca_points": "coral",
    "rca_removed_points": "red",
    "lca_removed_points": "red",
    "proximal_points": "cyan",
    "distal_points": "magenta",
    "anomalous_points": "orange",
    "rca_points_main": "royalblue",
    "lca_points_main": "orangered",
}

# vessel-tree colour ramps (debug_plots.py:229-239)
_RCA_BRANCH_COLORS = ["#4fa3e0", "#7ec8e3", "#a8d8ea", "#b8dfed"]
_LCA_BRANCH_COLORS = ["#e07f4f", "#e3a87e", "#eac0a8", "#edd0b8"]


class _Trace:
    """One figure trace: points + plotly style."""

    def __init__(self, pts, color=None, mode="markers", size=2, name=""):
        self.pts = np.asarray(pts, dtype=float).reshape(-1, 3)
        self.color = color
        self.mode = mode
        self.size = size
        self.name = name


def _cl_array(cl) -> np.ndarray:
    return np.array(
        [(p.contour_point.x, p.contour_point.y, p.contour_point.z) for p in cl.points]
    ).reshape(-1, 3)


def _summarize(trace: _Trace) -> str:
    arr = trace.pts
    if len(arr) == 0:
        return f"  {trace.name}: 0 points"
    lo = arr.min(axis=0)
    hi = arr.max(axis=0)
    return (
        f"  {trace.name}: {len(arr)} points, bbox "
        f"[{lo[0]:.1f},{lo[1]:.1f},{lo[2]:.1f}] - [{hi[0]:.1f},{hi[1]:.1f},{hi[2]:.1f}]"
    )


def _emit(title: str, traces: List[_Trace], html_name: str):
    """Render traces: plotly HTML when available, textual summary always.
    Returns the figure (or None) so tests and notebooks can inspect it."""
    print(f"[{title}]")
    for t in traces:
        print(_summarize(t))
    if go is None:
        return None
    fig = go.Figure()
    for t in traces:
        if len(t.pts) == 0:
            continue
        fig.add_trace(
            go.Scatter3d(
                x=t.pts[:, 0], y=t.pts[:, 1], z=t.pts[:, 2],
                mode=t.mode,
                marker=dict(size=t.size, color=t.color),
                line=dict(color=t.color, width=3) if "lines" in t.mode else None,
                name=t.name,
            )
        )
    fig.update_layout(
        title=title,
        scene=dict(aspectmode="data"),
        legend=dict(itemsizing="constant"),
    )
    fig.write_html(html_name)
    print(f"  wrote {html_name}")
    return fig


def plot_results_key(
    results: dict,
    aorta_points: bool = True,
    rca_points: bool = False,
    lca_points: bool = False,
    rca_removed_points: bool = False,
    proximal_points: bool = False,
    distal_points: bool = False,
    anomalous_points: bool = False,
    cl_rca=None,
    cl_lca=None,
    cl_aorta=None,
):
    """Visualise selected labelled regions with the reference's colour
    coding; centerlines render as connected polylines.
    Parity: debug_plots.py:34-132."""
    flags = {
        "aorta_points": aorta_points,
        "rca_points": rca_points,
        "lca_points": lca_points,
        "rca_removed_points": rca_removed_points,
        "proximal_points": proximal_points,
        "distal_points": distal_points,
        "anomalous_points": anomalous_points,
    }
    traces = [
        _Trace(results.get(key, []), color=_REGION_COLORS.get(key), name=key)
        for key, enabled in flags.items()
        if enabled and results.get(key)
    ]
    for name, cl, color in (
        ("cl_rca", cl_rca, "blue"),
        ("cl_lca", cl_lca, "green"),
        ("cl_aorta", cl_aorta, "black"),
    ):
        if cl is not None:
            traces.append(
                _Trace(_cl_array(cl), color=color, mode="lines+markers", name=name)
            )
    return _emit("plot_results_key", traces, "plot_results_key.html")


def compare_centerline_scaling(cl_before, cl_after, results: Optional[dict] = None):
    """Before/after centerline polylines, optionally over the labelled
    regions they were scaled against.  Parity: debug_plots.py:135-199."""
    traces = [
        _Trace(_cl_array(cl_before), color="gray", mode="lines+markers", name="before"),
        _Trace(_cl_array(cl_after), color="crimson", mode="lines+markers", name="after"),
    ]
    if results:
        for key in ("aorta_points", "rca_points", "lca_points"):
            if results.get(key):
                traces.append(
                    _Trace(
                        results[key], color=_REGION_COLORS.get(key), size=1, name=key
                    )
                )
    return _emit(
        "compare_centerline_scaling", traces, "compare_centerline_scaling.html"
    )


def plot_vessel_tree(tree, pts_per_contour: int = 24):
    """Discretized vessel tree: aorta silver, RCA main steel-blue, LCA main
    coral, side branches in blue/orange ramps, contour centroids yellow,
    reference triplets red/orange/magenta.  Parity: debug_plots.py:202-304."""
    traces: List[_Trace] = []

    def add_contours(contours, color, name):
        rows, cents = [], []
        for c in contours:
            if c.n_points == 0:
                continue
            xyz = c.xyz_view()
            step = max(1, len(xyz) // pts_per_contour)
            rows.append(xyz[::step])
            if c.centroid is not None:
                cents.append(c.centroid)
        if rows:
            traces.append(_Trace(np.concatenate(rows), color=color, name=name))
        if cents:
            traces.append(
                _Trace(np.asarray(cents), color="yellow", name=f"{name}_centroids")
            )

    def add_refs(refs, name):
        mains, ccs, clocks = [], [], []
        for main_ref, cc_ref, clock_ref in refs:
            mains.append(main_ref)
            ccs.append(cc_ref)
            clocks.append(clock_ref)
        for pts, color, suffix in (
            (mains, "red", "main"),
            (ccs, "orange", "ccw"),
            (clocks, "magenta", "cw"),
        ):
            if pts:
                traces.append(
                    _Trace(np.asarray(pts), color=color, size=4, name=f"{name}_{suffix}")
                )

    add_contours(tree.discretized_aorta, "silver", "aorta")
    add_contours(tree.discretized_rca_main, "steelblue", "rca_main")
    for i, branch in enumerate(tree.rca_branches):
        add_contours(
            branch, _RCA_BRANCH_COLORS[i % len(_RCA_BRANCH_COLORS)], f"rca_side_{i + 1}"
        )
    add_contours(tree.discretized_lca_main, "coral", "lca_main")
    for i, branch in enumerate(tree.lca_branches):
        add_contours(
            branch, _LCA_BRANCH_COLORS[i % len(_LCA_BRANCH_COLORS)], f"lca_side_{i + 1}"
        )
    add_refs(tree.rca_references, "rca_ref")
    add_refs(tree.lca_references, "lca_ref")
    return _emit("plot_vessel_tree", traces, "plot_vessel_tree.html")


def plot_centerline_branches(rca_cl, lca_cl, results_dict: Optional[dict] = None):
    """Per-branch polylines (branch 0 saturated, side branches lighter),
    optionally over the labelled main-vessel point sets.
    Parity: debug_plots.py:307-380."""
    traces: List[_Trace] = []
    for label, cl, ramp in (
        ("rca", rca_cl, _RCA_BRANCH_COLORS),
        ("lca", lca_cl, _LCA_BRANCH_COLORS),
    ):
        by_branch: Dict[int, list] = defaultdict(list)
        for p in cl.points:
            by_branch[p.branch_id].append(
                (p.contour_point.x, p.contour_point.y, p.contour_point.z)
            )
        for bid in sorted(by_branch):
            color = (
                ("steelblue" if label == "rca" else "coral")
                if bid == 0
                else ramp[bid % len(ramp)]
            )
            traces.append(
                _Trace(
                    np.array(by_branch[bid]),
                    color=color,
                    mode="lines+markers",
                    name=f"{label}_branch_{bid}",
                )
            )
    if results_dict:
        for key in ("rca_points_main", "lca_points_main"):
            if results_dict.get(key):
                traces.append(
                    _Trace(
                        results_dict[key],
                        color=_REGION_COLORS.get(key),
                        size=1,
                        name=key,
                    )
                )
    return _emit(
        "plot_centerline_branches", traces, "plot_centerline_branches.html"
    )


def plot_centerline_edges(cl, results: Optional[dict] = None):
    """Centerline as a connected polyline with endpoints highlighted (the
    reference's edge view).  Parity: debug_plots.py:383-432."""
    pos = _cl_array(cl)
    traces = [_Trace(pos, color="black", mode="lines+markers", name="centerline")]
    if len(pos):
        traces.append(
            _Trace(pos[[0, -1]], color="red", size=5, name="endpoints")
        )
    if results:
        for key, pts in results.items():
            if pts and key in _REGION_COLORS:
                traces.append(
                    _Trace(pts, color=_REGION_COLORS[key], size=1, name=key)
                )
    return _emit("plot_centerline_edges", traces, "plot_centerline_edges.html")


def plot_sharp_angles(cl, branch_id: int, positions: List[int]):
    """A branch polyline with its sharp-angle vertices highlighted.
    Parity: debug_plots.py:435-495."""
    branch = cl.get_branch(branch_id)
    pos = _cl_array(branch)
    traces = [
        _Trace(pos, color="steelblue", mode="lines+markers", name="branch")
    ]
    if positions:
        idx = np.asarray(positions, dtype=int)
        idx = idx[(idx >= 0) & (idx < len(pos))]
        if len(idx):
            traces.append(
                _Trace(pos[idx], color="red", size=6, name="sharp_angles")
            )
    return _emit("plot_sharp_angles", traces, "plot_sharp_angles.html")


# ---------------------------------------------------------------------------
# interactive 3-D scenes (guarded)
# ---------------------------------------------------------------------------
#
# The reference opens pyglet windows via trimesh.Scene(...).show()
# (debug_plots.py:34-135).  Headless environments cannot open a window, so
# the scene is CONSTRUCTED unconditionally (testable: geometry list, colours,
# point counts) and .show() degrades gracefully: a real display uses the
# interactive viewer when pyglet/trimesh are importable, otherwise the scene
# falls back to the standalone-HTML rendering of the plotly path.


class ScenePointCloud:
    """Minimal trimesh.points.PointCloud analog: points + one RGBA colour."""

    def __init__(self, points, color, name: str = ""):
        self.vertices = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        self.color = list(color)
        self.name = name

    def __len__(self) -> int:
        return len(self.vertices)


class Scene:
    """Collected 3-D geometries with a guarded interactive viewer."""

    def __init__(self, geometries=None):
        self.geometries: list = list(geometries or [])

    def add_geometry(self, geom) -> None:
        self.geometries.append(geom)

    @property
    def is_empty(self) -> bool:
        return not self.geometries

    def _traces(self) -> List[_Trace]:
        traces = []
        for g in self.geometries:
            if isinstance(g, ScenePointCloud):
                rgba = g.color
                color = f"rgb({rgba[0]},{rgba[1]},{rgba[2]})"
                traces.append(_Trace(g.vertices, color=color, name=g.name))
            elif hasattr(g, "vertices"):  # mesh-like: show the vertex cloud
                traces.append(
                    _Trace(np.asarray(g.vertices), color="lightgray", size=1,
                           name="mesh")
                )
        return traces

    def save_html(self, path: str = "scene.html"):
        return _emit("scene", self._traces(), path)

    def show(self):
        """Open an interactive viewer when a display + pyglet are available
        (the reference's trimesh.Scene.show), else write standalone HTML."""
        import os

        if os.environ.get("DISPLAY") or os.name == "nt":
            try:  # pragma: no cover - needs a real display
                import trimesh as _tm  # real trimesh, not the compat facade

                if hasattr(_tm, "Scene") and not hasattr(_tm, "_MMTPU_FACADE"):
                    geoms = []
                    for g in self.geometries:
                        if isinstance(g, ScenePointCloud):
                            geoms.append(
                                _tm.points.PointCloud(g.vertices, colors=g.color)
                            )
                        else:
                            geoms.append(g)
                    return _tm.Scene(geoms).show()
            except Exception:
                pass
        print("no interactive display available — writing scene.html instead")
        return self.save_html()


def build_results_scene(
    results: dict,
    aorta_points: bool = True,
    rca_points: bool = False,
    lca_points: bool = False,
    rca_removed_points: bool = False,
    proximal_points: bool = False,
    distal_points: bool = False,
    anomalous_points: bool = False,
    cl_rca=None,
    cl_lca=None,
    cl_aorta=None,
) -> Scene:
    """Headlessly construct the reference's results-key scene
    (debug_plots.py:34-132 colour coding: yellow aorta, blue RCA, green LCA,
    red removed, cyan proximal, magenta distal, orange anomalous)."""
    rgba = {
        "aorta_points": [255, 255, 0, 255],
        "rca_points": [0, 0, 255, 255],
        "lca_points": [0, 255, 0, 255],
        "rca_removed_points": [255, 0, 0, 255],
        "proximal_points": [0, 255, 255, 255],
        "distal_points": [255, 0, 255, 255],
        "anomalous_points": [255, 165, 0, 255],
    }
    flags = {
        "aorta_points": aorta_points,
        "rca_points": rca_points,
        "lca_points": lca_points,
        "rca_removed_points": rca_removed_points,
        "proximal_points": proximal_points,
        "distal_points": distal_points,
        "anomalous_points": anomalous_points,
    }
    scene = Scene()
    for key, enabled in flags.items():
        # regions may be tuple lists or numpy index-model arrays; len()
        # avoids the ambiguous-truth-value error arrays raise under `or`
        pts = results.get(key)
        if enabled and pts is not None and len(pts):
            scene.add_geometry(ScenePointCloud(pts, rgba[key], name=key))
    mesh = results.get("mesh")
    if mesh is not None and not scene.is_empty:
        scene.add_geometry(mesh)
    for name, cl, color in (
        ("cl_rca", cl_rca, [0, 100, 200, 255]),
        ("cl_lca", cl_lca, [0, 150, 0, 255]),
        ("cl_aorta", cl_aorta, [200, 200, 0, 255]),
    ):
        if cl is not None:
            scene.add_geometry(ScenePointCloud(_cl_array(cl), color, name=name))
    return scene
