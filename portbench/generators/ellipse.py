"""Traffic kind ``ellipse``: smooth elliptic lumens with a per-frame twist
and drift, the frame-0 reference point right of the last centre (the JAX
package's ``bench.py`` builder, copied).  Each pullback has a seed of its
own drawn from (``--seed``, case, phase).

A case is a list of pullbacks, one per phase of the configuration
(``phases``: label and diastole), each ``(label, lumen rows [frame, x, y,
z], reference point [frame, x, y, z], diastole)`` of ``frames`` frames."""

from __future__ import annotations

import math

import numpy as np

from portbench.harness.traffic import rng_for


def pullback(rng: np.random.Generator, n_frames: int, mix: dict):
    """(lumen rows, reference point) of one synthetic pullback."""
    n_points = mix["points"]
    cx, cy = mix["center"]
    a0, b0 = mix["axes"]
    swing = mix["axes_swing"]
    theta = np.linspace(0.0, 2.0 * math.pi, n_points, endpoint=False)
    rows = []
    rot = 0.0
    for f in range(n_frames):
        rot += rng.uniform(-mix["twist"], mix["twist"])
        cx += rng.uniform(-mix["drift"], mix["drift"])
        cy += rng.uniform(-mix["drift"], mix["drift"])
        a = a0 + swing * math.sin(f / 17.0)
        b = b0 + swing * math.cos(f / 23.0)
        wobble = mix["wobble"] * np.sin(5 * theta + f / 5.0)
        r_x = (a + wobble) * np.cos(theta)
        r_y = (b + wobble) * np.sin(theta)
        x = cx + r_x * math.cos(rot) - r_y * math.sin(rot)
        y = cy + r_x * math.sin(rot) + r_y * math.cos(rot)
        z = np.full(n_points, f * mix["z_step"])
        rows.append(np.stack([np.full(n_points, f), x, y, z], axis=-1))
    ref = np.array([0, cx + mix["ref_offset"], mix["center"][1], 0.0])
    return np.concatenate(rows), ref


def make_pool(mix: dict, config: dict, seed: int, data_dir):
    """``pool_cases`` cases of the configuration's phases."""
    pool = []
    for case in range(config["pool_cases"]):
        pullbacks = []
        for p, (label, diastole) in enumerate(config["phases"]):
            lumen, ref = pullback(rng_for(seed, case, p), config["frames"], mix)
            pullbacks.append((f"{label}_{case}", lumen, ref, bool(diastole)))
        pool.append(pullbacks)
    return pool
