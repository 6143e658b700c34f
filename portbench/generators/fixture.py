"""Traffic kind ``fixture``: copies of a vendored contour file's real
frames (``files``, one a phase, under ``data/``), stacked in z, copy c
turned by c * theta about each frame's centroid, theta drawn for each case
from ``twist_rad`` (the same construction in the JAX package's
``bench.py``).

A case is a list of pullbacks, one per phase of the configuration
(``phases``: label and diastole), each ``(label, lumen rows [frame, x, y,
z], reference point [frame, x, y, z], diastole)`` of ``frames`` frames."""

from __future__ import annotations

import math

import numpy as np

from portbench.harness.traffic import rng_for


def pullback(raw: np.ndarray, n_frames: int, twist: float, ref_frame: int):
    """(lumen rows, reference point): ``n_frames`` frames copied from the
    contour rows ``raw`` [frame, x, y, z], copy c turned by ``c * twist``
    about each frame's centroid and shifted past the copy before it; the
    reference point 1 mm right of frame ``ref_frame``'s rightmost point."""
    frames = np.unique(raw[:, 0])
    n_src = len(frames)
    z_span = raw[:, 3].max() - raw[:, 3].min()
    spacing = z_span / max(n_src - 1, 1)
    rows = []
    fid = 0
    for c in range(int(np.ceil(n_frames / n_src))):
        cr, sr = math.cos(twist * c), math.sin(twist * c)
        for f in frames:
            if fid >= n_frames:
                break
            sel = raw[raw[:, 0] == f]
            x, y = sel[:, 1], sel[:, 2]
            mx, my = x.mean(), y.mean()
            xr = mx + (x - mx) * cr - (y - my) * sr
            yr = my + (x - mx) * sr + (y - my) * cr
            z = sel[:, 3] + c * (z_span + spacing)
            rows.append(np.column_stack([np.full(len(sel), fid), xr, yr, z]))
            fid += 1
    first = rows[ref_frame]
    ref = np.array([ref_frame, first[:, 1].max() + 1.0, first[:, 2].mean(), first[0, 3]])
    return np.concatenate(rows), ref


def ref_frame(mix: dict, n_phases: int, n_frames: int, raw: np.ndarray) -> int:
    """The reference frame of a pullback: ``ref_frame`` of the mix for the
    case's number of phases, a frame number or ``"last_copy"`` (the last
    frame that copies the source's last frame)."""
    rule = mix["ref_frame"][str(n_phases)]
    if rule == "last_copy":
        n_src = len(np.unique(raw[:, 0]))
        return n_src * (n_frames // n_src) - 1
    return int(rule)


def make_pool(mix: dict, config: dict, seed: int, data_dir):
    """``pool_cases`` cases of the configuration's phases, phase p copying
    ``files[p]``; one twist a case."""
    phases, n_frames = config["phases"], config["frames"]
    raws = [np.loadtxt(data_dir / src, delimiter="\t") for src in mix["files"]]
    lo, hi = mix["twist_rad"]
    pool = []
    for case in range(config["pool_cases"]):
        twist = rng_for(seed, case).uniform(lo, hi)
        pullbacks = []
        for p, (label, diastole) in enumerate(phases):
            raw = raws[p % len(raws)]
            lumen, ref = pullback(raw, n_frames, twist, ref_frame(mix, len(phases), n_frames, raw))
            pullbacks.append((f"{label}_{case}", lumen, ref, bool(diastole)))
        pool.append(pullbacks)
    return pool
