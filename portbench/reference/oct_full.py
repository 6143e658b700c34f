"""Plain reference of the four-phase registration (rest and stress,
diastole and systole), written from the semantics of the reference project
(multimodars: ``binding/entry.rs`` full processing, ``align_between.rs``,
``postprocessing.rs``) for the benchmark's traffic: four pullbacks of
lumen rows with one reference point each, no records.  numpy and torch
only, as :mod:`oct_single`, whose build, search and finish it uses.

- each pullback is registered frame to frame and smoothed (``oct_single``);
- stage 1 moves B onto A and D onto C, stage 2 C onto A and the moved D
  onto the moved B: each target's cloud, moved by the translation between
  the two reference frames, is searched for the rotation about the
  reference cloud's mean (one sweep of the whole grid, first-wins argmin),
  the target turned by it about A's reference centroid and moved so that
  the two reference frames' centroids coincide;
- each of the pairs AB, CD (as stage 1 left them), AC and BD is resampled
  to one z spacing, aligned in z at the reference frames and trimmed to the
  frames both hold around them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import oct_single as single

# z positions closer than this are one frame (postprocessing.rs)
Z_EPS = 1e-9
# consecutive-z tolerance under which two pullbacks share a spacing (entry.rs)
SAME_RATE_TOL = 0.03
# a frame off by more than this (mm) sends the judge looking for the
# program's choice of tied starts; a start one point off moves a frame by
# 1e-3 mm or more, rounding by 1e-13 or less
START_SEARCH_MM = 1e-6


def _copy(g: dict) -> dict:
    return {"coords": {k: v.copy() for k, v in g["coords"].items()},
            "centroid": g["centroid"].copy(), "ref": g["ref"],
            "ref_point": g["ref_point"].copy()}


def cloud(g: dict, sample_size: int) -> np.ndarray:
    """The geometry's lumen, each frame downsampled in proportion to
    ``sample_size`` points over the whole pullback (at least one a frame),
    as [n, 2]."""
    lum = g["coords"]["Lumen"]
    F, P, _ = lum.shape
    n = max(int(math.ceil(P * (sample_size / (F * P)))), 1)
    return lum[:, single._downsample(P, n), :2].reshape(-1, 2)


def search(test: np.ndarray, ref: np.ndarray, step_deg: float, range_deg: float,
           device, dtype) -> float:
    """The best rotation of ``test`` onto ``ref`` (both centred on the
    pivot) by the ladder of :func:`oct_single.ladder_stages`."""
    t = torch.as_tensor(test, dtype=torch.float64, device=device)[None]
    r = torch.as_tensor(ref, dtype=torch.float64, device=device)[None]
    best = torch.zeros(1, dtype=torch.float64, device=device)
    for stage_step, stage_range, centred in single.ladder_stages(step_deg, range_deg):
        angles, valid = single.grid(best if centred else torch.zeros_like(best),
                                    stage_step, stage_range, range_deg)
        costs = single.cost_table(t, r, angles, dtype)
        costs = torch.where(valid, costs, torch.full_like(costs, math.inf))
        best = angles[0, int(torch.argmin(costs[0]))][None]
    return float(best[0])


def between(a: dict, b: dict, args: dict, device, dtype, host_dtype) -> dict:
    """``b`` moved onto ``a`` (a new geometry)."""
    ca = a["centroid"][a["ref"]]
    t0 = ca - b["centroid"][b["ref"]]
    sample = max(args["sample_size"], 500)
    ref_xy = cloud(a, sample)
    tgt_xy = cloud(b, sample) + t0[:2]
    pivot = ref_xy.mean(axis=0)
    rot = search(tgt_xy - pivot, ref_xy - pivot, args["step_rotation_deg"],
                 args["range_rotation_deg"], device, dtype)
    h = host_dtype
    c, s = np.asarray(math.cos(rot), h), np.asarray(math.sin(rot), h)

    def move(xyz):
        """+ t0, then turned about A's reference centroid."""
        x = xyz[..., 0].astype(h) + t0[0].astype(h) - ca[0].astype(h)
        y = xyz[..., 1].astype(h) + t0[1].astype(h) - ca[1].astype(h)
        out = np.array(xyz, dtype=np.float64, copy=True)
        out[..., 0] = x * c - y * s + ca[0].astype(h)
        out[..., 1] = x * s + y * c + ca[1].astype(h)
        out[..., 2] = xyz[..., 2] + t0[2]
        return out

    moved_ref = move(b["centroid"][b["ref"]])
    ft = ca - moved_ref
    out = {"coords": {k: move(v) + ft for k, v in b["coords"].items()},
           "centroid": move(b["centroid"]) + ft, "ref": b["ref"],
           "ref_point": move(b["ref_point"]) + ft}
    return out


def _avg_z_diff(g: dict) -> float:
    z = g["centroid"][:, 2]
    return float(np.mean(z[1:] - z[:-1])) if len(z) >= 2 else 0.0


def _set_z(g: dict, i: int, z: float) -> None:
    for v in g["coords"].values():
        v[i, :, 2] = z
    g["centroid"][i, 2] = z
    if g["ref"] == i:
        g["ref_point"][2] = z


def resample_by_diff(g: dict, diff: float) -> dict:
    """Frames kept, their z rewritten on a grid of ``diff`` from the first
    frame's (the frame of least z comes first in every geometry built
    here)."""
    g = _copy(g)
    z = g["centroid"][:, 2]
    if int(np.argmin(z)) != 0:
        raise ValueError("the frame of least z is not the first")
    start = z[0]
    for i in range(1, len(z)):
        _set_z(g, i, start + i * diff)
    return g


def predict_z(ref_z: float, start: float, stop: float, dz: float):
    """A grid of spacing ``dz`` through ``ref_z`` over [start, stop]."""
    out = []
    if not np.isfinite(dz) or dz == 0.0:
        return out
    if abs(ref_z - start) > Z_EPS and abs(ref_z - stop) > Z_EPS:
        cur = ref_z
        while cur >= start - Z_EPS:
            out.append(cur)
            cur -= dz
        out.sort()
        cur = ref_z + dz
        while cur <= stop + Z_EPS:
            out.append(cur)
            cur += dz
    elif stop >= start and dz > 0.0:
        cur = start
        while cur <= stop + Z_EPS:
            out.append(cur)
            cur += dz
    elif stop <= start and dz < 0.0:
        cur = start
        while cur >= stop - Z_EPS:
            out.append(cur)
            cur += dz
    return out


def resample_at(g: dict, zs) -> dict:
    """Frames at the z positions ``zs``: a frame at that z where there is
    one, else the blend of the two frames around it (the lower frame's z
    kept by the points, then every point set to the new z); a blended frame
    holds no reference point."""
    zf = g["centroid"][:, 2]
    coords = {k: [] for k in g["coords"]}
    cents, ref = [], None
    for z in sorted(zs):
        if z > zf[-1]:
            break
        hit = np.nonzero(np.abs(zf - z) < Z_EPS)[0]
        if hit.size:
            i = int(hit[0])
            for k in coords:
                coords[k].append(g["coords"][k][i].copy())
            cents.append(g["centroid"][i].copy())
            if g["ref"] == i and ref is None:
                ref = len(cents) - 1
            continue
        lo = next((i for i in range(len(zf) - 1) if zf[i] <= z <= zf[i + 1]), None)
        if lo is None:
            raise ValueError("no frames around a z position")
        t = (z - zf[lo]) / (zf[lo + 1] - zf[lo])
        for k in coords:
            a, b = g["coords"][k][lo], g["coords"][k][lo + 1]
            coords[k].append(a + t * (b - a))
        c1, c2 = g["centroid"][lo], g["centroid"][lo + 1]
        cents.append(np.array([c1[0] + t * (c2[0] - c1[0]), c1[1] + t * (c2[1] - c1[1]), z]))
    order = np.argsort([c[2] for c in cents], kind="stable")
    out = {"coords": {k: np.stack([v[i] for i in order]) for k, v in coords.items()},
           "centroid": np.stack([cents[i] for i in order]),
           "ref": None if ref is None else int(np.nonzero(order == ref)[0][0]),
           "ref_point": g["ref_point"].copy()}
    for i in range(len(order)):
        _set_z(out, i, out["centroid"][i, 2])
    return out


def wall_of(lumen: np.ndarray) -> np.ndarray:
    """Each lumen point moved 1 mm away from its frame's mean point."""
    rel = lumen - lumen.mean(axis=1, keepdims=True)
    return lumen + rel / np.linalg.norm(rel, axis=-1, keepdims=True)


def postprocess(a: dict, b: dict, anomalous: bool):
    """The pair resampled to one z spacing, aligned in z at the reference
    frames and trimmed to the frames both hold around them; where a vessel
    is anomalous, the walls built anew from the lumens (no frame carries an
    aortic thickness here)."""
    da, db = _avg_z_diff(a), _avg_z_diff(b)
    if a["ref"] is None or b["ref"] is None:
        raise ValueError("no reference frame")
    if da - db < SAME_RATE_TOL:  # signed, as the reference compares
        mean = (da + db) / 2.0
        ra, rb = resample_by_diff(a, mean), resample_by_diff(b, mean)
    elif da < db:
        zb = b["centroid"][:, 2]
        lo, hi = sorted((zb[0], zb[-1]))
        ra = resample_by_diff(a, da)
        rb = resample_at(b, predict_z(zb[b["ref"]], lo, hi, da))
    else:
        za = a["centroid"][:, 2]
        lo, hi = sorted((za[0], za[-1]))
        ra = resample_at(a, predict_z(za[a["ref"]], lo, hi, db))
        rb = resample_by_diff(b, db)
    if ra["ref"] is None or rb["ref"] is None:
        raise ValueError("no reference frame after resampling")
    # the reference frames' positions after resampling, read in the pair
    # before it (postprocessing.rs indexes the original pair)
    dz = a["centroid"][ra["ref"], 2] - b["centroid"][rb["ref"], 2]
    for v in ra["coords"].values():
        v[:, :, 2] += dz
    ra["centroid"][:, 2] += dz
    before = min(ra["ref"], rb["ref"])
    after = min(len(ra["centroid"]) - ra["ref"], len(rb["centroid"]) - rb["ref"])

    def trim(g):
        s, e = g["ref"] - before, g["ref"] + after
        if not (s < e <= len(g["centroid"])):
            s, e = 0, len(g["centroid"])
        out = {k: v[s:e] for k, v in g["coords"].items()}
        if anomalous:
            out["Wall"] = wall_of(out["Lumen"])
        return out

    return trim(ra), trim(rb)


def register(case, args: dict, device, dtype=torch.float64, host_dtype=np.float64,
             deltas=None, starts=None):
    """The four pullbacks' registration: ``logs`` (one [F - 1, 7] array a
    pullback, as :func:`oct_single.register`), ``coords``, a list of the
    pairs AB, CD, AC, BD, each two geometries' coordinates by kind, and
    ``ties``, each pullback's tied starts (:func:`oct_single.finish_geometry`).
    ``deltas`` (one array a pullback, radians) replaces the frame-to-frame
    search's answers and ``starts`` (one dict a pullback) the finish's
    starts of tied frames; ``dtype`` / ``host_dtype`` as in
    :func:`oct_single.register`."""
    geoms, logs, ties, anomalous = [], [], [], False
    for k, (_, lumen, ref, _) in enumerate(case):
        b = single.build(lumen, ref, args["image_center"], args["radius"], args["n_points"],
                         host_dtype)
        if deltas is None:
            pts = single.sample_sets(b, args["sample_size"])
            delta = single.chain_ladder(pts, args["step_rotation_deg"],
                                        args["range_rotation_deg"], device, dtype)
        else:
            delta = deltas[k]
        g = single.finish_geometry(b, delta, args["smooth"], host_dtype,
                                   None if starts is None else starts[k])
        anomalous |= g.pop("anomalous")
        ties.append(g.pop("ties"))
        geoms.append(g)
        c = b["centroid"]
        t = c[0, :2] - c[1:, :2]
        F = len(c)
        logs.append(np.column_stack([np.arange(1, F), np.arange(F - 1), np.degrees(delta),
                                     t, c[1:, :2] + t]))
    ga, gb, gc, gd = geoms
    gb = between(ga, gb, args, device, dtype, host_dtype)
    gd = between(gc, gd, args, device, dtype, host_dtype)
    pairs = [(ga, gb), (gc, gd)]
    gc2 = between(ga, gc, args, device, dtype, host_dtype)
    gd2 = between(gb, gd, args, device, dtype, host_dtype)
    pairs += [(ga, gc2), (gb, gd2)]
    if args["postprocessing"]:
        coords = [postprocess(p, q, anomalous) for p, q in pairs]
    else:
        coords = [(p["coords"], q["coords"]) for p, q in pairs]
    return {"logs": logs, "coords": coords, "ties": ties}


# the pullback (A, B, C, D) of each compared geometry: AB, CD, AC, BD
PAIR_PULLBACKS = (0, 1, 2, 3, 0, 2, 1, 3)


def frame_gaps(got_coords, want_coords, device) -> list:
    """Each compared geometry's frame gaps (mm, the largest set distance
    over the kinds the reference has), in the order of
    :data:`PAIR_PULLBACKS`."""
    out = []
    for got_pair, want_pair in zip(got_coords, want_coords):
        for g, w in zip(got_pair, want_pair):
            per_kind = [single.frame_distances(np.asarray(g[k]), w[k], device)
                        if k in g else np.array([math.inf]) for k in w]
            if len({len(d) for d in per_kind}) != 1:
                out.append(np.array([math.inf]))
            else:
                out.append(np.max(per_kind, axis=0))
    return out


def judge(case, args: dict, out: dict, device) -> dict:
    """The program's answer ``out`` (as :func:`register` returns it) against
    the reference: ``centroid_gap_mm`` and ``angle_gap_rel`` over the four
    pullbacks' frame pairs (as :func:`oct_single.judge`), and
    ``coord_gap_mm``, the final coordinates of the eight geometries against
    the reference's between stages and postprocessing run on the program's
    frame-to-frame rotations (the search is judged by the number before)
    and, where the program took the other start of a tied frame, on that
    start (:func:`_follow_tied_starts`)."""
    if len(out["logs"]) != len(case) or len(out["coords"]) != 4:
        return {"centroid_gap_mm": math.inf, "angle_gap_rel": math.inf,
                "coord_gap_mm": math.inf}
    within = {"centroid_gap_mm": 0.0, "angle_gap_rel": 0.0}
    deltas = []
    for (_, lumen, ref, _), logs in zip(case, out["logs"]):
        got = single.judge_chain(lumen, ref, args, logs, device)
        for k in within:
            within[k] = max(within[k], got[k])
        deltas.append(single.logged_radians(np.asarray(logs, dtype=np.float64)[:, 2], args))
    if not np.isfinite(within["angle_gap_rel"]):
        return {**within, "coord_gap_mm": math.inf}
    want = register(case, args, device, deltas=deltas)
    gaps = frame_gaps(out["coords"], want["coords"], device)
    if all(np.isfinite(g).all() for g in gaps):
        gaps = _follow_tied_starts(case, args, device, deltas, out, want["ties"], gaps)
    return {**within, "coord_gap_mm": float(max(g.max() for g in gaps))}


def _follow_tied_starts(case, args, device, deltas, out, ties, gaps):
    """The frame gaps after the reference takes the program's choice at tied
    starts (:data:`oct_single.START_TIE_MM`): while a geometry has a frame
    off by more than :data:`START_SEARCH_MM`, of all single changes of a
    tied start of the pullbacks behind such geometries, the one that brings
    the reference's whole answer nearest the program's, if it comes nearer.
    A start one point off moves the smoothed frames by a third of a point
    spacing (about 3e-3 mm here), so a tie the program decided the other way
    shows as that; a start that is no tie is never offered."""
    starts = [{} for _ in ties]

    def total(g):
        return sum(float(x.sum()) for x in g)

    while True:
        suspects = {PAIR_PULLBACKS[i] for i, g in enumerate(gaps) if g.max() > START_SEARCH_MM}
        best, best_total = None, total(gaps)
        for k in sorted(suspects):
            for f, offsets in ties[k].items():
                for off in [0, *offsets]:
                    if starts[k].get(f, 0) == off:
                        continue
                    trial = [dict(s) for s in starts]
                    trial[k][f] = off
                    coords = register(case, args, device, deltas=deltas, starts=trial)["coords"]
                    g = frame_gaps(out["coords"], coords, device)
                    if total(g) < best_total:
                        best, best_total = (trial, g), total(g)
        if best is None:
            return gaps
        starts, gaps = best
