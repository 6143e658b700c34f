"""Traffic kind ``tube``: a pullback to register onto a CCTA centerline and
the surface points of the CCTA's vessel around it.

The centerline is a vendored VTP file (``centerline``, under ``data/``);
its longest line is branch 0, as the port's reader and the reference
project's number them.  A case holds:

- one pullback of ``frames`` frames, made as the ``ellipse`` mix makes one
  (``generators/ellipse.py``, the same keys of the mix), then turned as a
  whole about the mix's ``center`` by an angle drawn in +-``turn_deg``;
- three landmarks (``chip_smoke.py``'s construction): the branch-0 point
  ``landmark_arc_mm`` along the line, and the points one local radius to
  either side of it, across the vessel;
- the vessel cloud: rings every ``ring_spacing_mm`` along branch 0 (or the
  piece ``cloud_arc_mm`` of it), each of ``max(3, round(2 pi r /
  spacing))`` points at the local radius r, that radius scaled by a smooth
  factor (a sine in ``radius_factor`` of a wavelength drawn in
  ``radius_wavelength_mm``), every point then moved by normal noise of
  ``noise_mm`` a coordinate.  Ring sizes follow the unscaled radius, so
  every case of a mix has the same number of points.

Each case has seeds of its own drawn from (``--seed``, case): the
pullback's from stream 0 (as the ``ellipse`` mix's first phase), the turn
and the cloud's from stream 1.  A case is a dict: ``lumen`` rows [frame, x,
y, z], ``ref`` [frame, x, y, z], ``landmarks`` (three (x, y, z)),
``cloud`` [N, 3], ``centerline`` (the file's path) and ``branch0``
(positions [L, 3] and radii [L] as the file gives them, for the
reference)."""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from portbench.harness import traffic
from portbench.harness.traffic import rng_for


def _array(node, path: str) -> np.ndarray:
    found = node.find(path)
    if found is None or found.text is None:
        raise ValueError(f"VTP: no {path}")
    return np.array(found.text.split(), dtype=np.float64)


def read_branches(path) -> list:
    """Every line of an ASCII VTP centerline as (positions [L, 3], radii
    [L]), longest first (ties in file order)."""
    piece = ET.parse(path).getroot().find(".//Piece")
    coords = _array(piece, "Points/DataArray").reshape(-1, 3)
    radii = _array(piece, "PointData/DataArray[@Name='MaximumInscribedSphereRadius']")
    conn = _array(piece, "Lines/DataArray[@Name='connectivity']").astype(np.int64)
    offsets = _array(piece, "Lines/DataArray[@Name='offsets']").astype(np.int64)
    lines = np.split(conn, offsets[:-1])

    def arc(line):
        seg = coords[line[1:]] - coords[line[:-1]]
        return float(np.sqrt((seg * seg).sum(-1)).sum())

    order = sorted(range(len(lines)), key=lambda i: -arc(lines[i]))
    return [(coords[lines[i]], radii[lines[i]]) for i in order]


def arc_lengths(pos: np.ndarray) -> np.ndarray:
    return np.concatenate([[0.0], np.cumsum(np.sqrt(((pos[1:] - pos[:-1]) ** 2).sum(-1)))])


def landmarks(pos: np.ndarray, rad: np.ndarray, arc_mm: float) -> tuple:
    """The point ``arc_mm`` along the line and the two one radius to either
    side of it, across the line and level in z."""
    i = int(np.searchsorted(arc_lengths(pos), arc_mm))
    side = np.cross(pos[i + 1] - pos[i - 1], [0.0, 0.0, 1.0])
    side *= rad[i] / np.linalg.norm(side)
    return tuple(pos[i]), tuple(pos[i] + side), tuple(pos[i] - side)


def rings(pos: np.ndarray, rad: np.ndarray, spacing: float, arc_range=None):
    """The unscaled tube: ring arc positions [R], centres [R, 3], radii [R],
    in-plane axes a, b [R, 3] and sizes [R]."""
    cum = arc_lengths(pos)
    lo, hi = arc_range if arc_range is not None else (0.0, cum[-1])
    s = np.arange(max(lo, 0.0), min(hi, cum[-1]), spacing)
    centre = np.stack([np.interp(s, cum, pos[:, k]) for k in range(3)], -1)
    radius = np.interp(s, cum, rad)
    t = np.gradient(centre, axis=0)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    a = np.cross(t, [0.0, 0.0, 1.0])
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = np.cross(t, a)
    sizes = np.maximum(3, np.round(2.0 * math.pi * radius / spacing)).astype(np.int64)
    return s, centre, radius, a, b, sizes


def cloud(tube, rng: np.random.Generator, mix: dict) -> np.ndarray:
    """The tube's points with a smooth radius factor and noise from ``rng``."""
    s, centre, radius, a, b, sizes = tube
    lo, hi = mix["radius_factor"]
    wavelength = rng.uniform(*mix["radius_wavelength_mm"])
    phase = rng.uniform(0.0, 2.0 * math.pi)
    factor = 0.5 * (lo + hi) + 0.5 * (hi - lo) * np.sin(2.0 * math.pi * s / wavelength + phase)
    ring = np.repeat(np.arange(len(s)), sizes)
    k = np.arange(len(ring)) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    ph = 2.0 * math.pi * k / sizes[ring]
    r = (radius * factor)[ring][:, None]
    pts = centre[ring] + r * (np.cos(ph)[:, None] * a[ring] + np.sin(ph)[:, None] * b[ring])
    return pts + rng.normal(0.0, mix["noise_mm"], pts.shape)


def turned(rows: np.ndarray, center, angle: float) -> np.ndarray:
    """Rows [..., (frame, x, y, z)] turned about ``center`` in xy."""
    c, s = math.cos(angle), math.sin(angle)
    out = rows.copy()
    x, y = rows[..., 1] - center[0], rows[..., 2] - center[1]
    out[..., 1] = center[0] + x * c - y * s
    out[..., 2] = center[1] + x * s + y * c
    return out


def make_pool(mix: dict, config: dict, seed: int, data_dir):
    """``pool_cases`` cases of one pullback, landmarks and cloud."""
    path = Path(data_dir) / mix["centerline"]
    pos, rad = read_branches(path)[0]
    marks = landmarks(pos, rad, mix["landmark_arc_mm"])
    tube = rings(pos, rad, mix["ring_spacing_mm"], mix.get("cloud_arc_mm"))
    ellipse = traffic.generator("ellipse", Path(data_dir).parent)
    pool = []
    for case in range(config["pool_cases"]):
        lumen, ref = ellipse.pullback(rng_for(seed, case, 0), config["frames"], mix)
        rng = rng_for(seed, case, 1)
        turn = math.radians(rng.uniform(-mix["turn_deg"], mix["turn_deg"]))
        pool.append({"lumen": turned(lumen, mix["center"], turn),
                     "ref": turned(ref, mix["center"], turn), "landmarks": marks,
                     "cloud": cloud(tube, rng, mix), "centerline": str(path),
                     "branch0": (pos, rad)})
    return pool
