"""Plain reference of one pullback's frame-to-frame registration.

Written from the semantics of the reference project (multimodars:
``io/build.rs``, ``processing/align_within.rs``, ``process_utils.rs``,
``wall.rs``, ``geometry.rs``) for the inputs the benchmark's traffic makes:
lumen rows ``[frame, x, y, z]`` with one reference point, no EEM, no
records.  It imports numpy and torch only, never the program under test,
and takes nothing the program made.

- :func:`build` orders the frames (proximal end first), assigns the sorted
  z, sorts each contour counter-clockwise and synthesises the catheter ring;
- :func:`sample_sets` makes each frame's centred search set;
- :func:`chain_ladder` runs the multi-resolution rotation search of every
  consecutive frame pair as whole cost tables, first-wins argmin, in one
  dtype (float64 for the reference, bfloat16 for the control);
- :func:`finish` applies a chain of relative rotations: the cumulative
  rotation about each frame's centroid, the translation onto frame 0, the
  rotation that puts the reference point to the right, the wall and, when
  asked, the three-frame smoothing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TWO_PI = 2.0 * math.pi
# points of a turned contour level in y to within this (mm) tie for its
# start, "the last point of greatest y": the finish's arithmetic decides
# them in the last bits (the traffic's real contours: 0 to 3.6e-15 mm
# apart, the next closest 1e-7 mm), so either start is the semantics'
# answer
START_TIE_MM = 1e-11
# elements of one [angles, pairs, N, M] distance tile of cost_table
TILE_ELEMENTS = 1 << 27


def _ccw_sorted(xyz: np.ndarray) -> np.ndarray:
    """Each frame's points [F, P, 3] in counter-clockwise order about their
    mean, stable on equal angles, started at the last point of greatest y."""
    x, y = xyz[:, :, 0], xyz[:, :, 1]
    ang = np.arctan2(y - y.mean(axis=1)[:, None], x - x.mean(axis=1)[:, None])
    order = np.argsort(ang, axis=1, kind="stable")
    ys = np.take_along_axis(y, order, axis=1)
    n = xyz.shape[1]
    start = n - 1 - np.argmax(ys[:, ::-1], axis=1)
    order = np.take_along_axis(order, (np.arange(n)[None, :] + start[:, None]) % n, axis=1)
    return np.take_along_axis(xyz, order[:, :, None], axis=1)


def build(lumen: np.ndarray, ref_point: np.ndarray, image_center, radius: float,
          n_catheter: int, host_dtype=np.float64) -> dict:
    """The pullback as the registration sees it before any search.

    Frames are taken in ascending frame number and reversed, so that the
    proximal end (the last frame of a pullback numbered from its distal end)
    comes first; the z of the frames, sorted ascending, is assigned in that
    order.  Returns ``lumen`` / ``catheter`` [F, P, 3] (sorted), the lumen
    ``centroid`` [F, 3] (mean of the frame's points, summed in
    ``host_dtype``), ``ref_pos`` (the reference point's frame) and
    ``ref_xy``."""
    frames = lumen[:, 0].astype(np.int64)
    uniq = np.unique(frames)
    per = [lumen[frames == f][:, 1:4] for f in uniq]
    if len({len(p) for p in per}) != 1:
        raise ValueError("every frame must carry the same number of lumen points")
    xyz = np.stack(per)
    F = len(uniq)
    centroid = xyz.astype(host_dtype).mean(axis=1).astype(np.float64)
    ang = TWO_PI * np.arange(n_catheter) / n_catheter
    ring = np.stack([image_center[0] + radius * np.cos(ang),
                     image_center[1] + radius * np.sin(ang)], axis=-1)
    cath = np.empty((F, n_catheter, 3))
    cath[:, :, :2] = ring[None]
    cath[:, :, 2] = xyz[:, 0, 2][:, None]
    ref_pos = int(np.nonzero(uniq == int(ref_point[0]))[0][0])
    if F > 1:
        xyz, cath, centroid = xyz[::-1].copy(), cath[::-1].copy(), centroid[::-1].copy()
        ref_pos = F - 1 - ref_pos
    zs = np.sort(centroid[:, 2])
    xyz[:, :, 2] = zs[:, None]
    cath[:, :, 2] = zs[:, None]
    centroid[:, 2] = zs
    xyz, cath = _ccw_sorted(xyz), _ccw_sorted(cath)
    return dict(lumen=xyz, catheter=cath, centroid=centroid, ref_pos=ref_pos,
                ref_xy=np.array(ref_point[1:3], dtype=np.float64), ref_z=float(zs[ref_pos]))


def _downsample(m: int, n: int) -> np.ndarray:
    if m <= n:
        return np.arange(m)
    return (np.arange(n) * (m / n)).astype(np.int64)


def sample_sets(b: dict, sample_size: int) -> np.ndarray:
    """[F, S, 2]: each frame's lumen, downsampled to ``sample_size`` points,
    and its catheter, downsampled in proportion, centred on the frame's
    lumen centroid."""
    P = b["lumen"].shape[1]
    C = b["catheter"].shape[1]
    lum = b["lumen"][:, _downsample(P, sample_size), :2]
    parts = [lum]
    if C:
        parts.append(b["catheter"][:, _downsample(C, math.ceil(C * sample_size / P)), :2])
    return np.concatenate(parts, axis=1) - b["centroid"][:, None, :2]


def ladder_stages(step_deg: float, range_deg: float):
    """The search's stages (step, range, centred on the previous answer):
    the reference's coarse-to-fine ladder, or one sweep of the user's grid
    where the ladder saves less than half the candidates."""
    if step_deg >= 1.0:
        stages = [(step_deg, range_deg, False)]
    elif step_deg >= 0.1:
        stages = [(1.0, range_deg, False), (step_deg, min(range_deg, 5.0), True)]
    elif step_deg >= 0.01:
        stages = [(1.0, range_deg, False), (0.1, min(range_deg, 5.0), True),
                  (step_deg, min(range_deg, 10.0 * step_deg), True)]
    else:
        stages = [(1.0, range_deg, False), (0.1, min(range_deg, 5.0), True),
                  (0.01, min(range_deg, 0.1), True),
                  (step_deg, min(range_deg, 10.0 * step_deg), True)]

    def count(s, r):
        return int(math.ceil(2.0 * r / s)) + 2

    if len(stages) > 1 and count(step_deg, range_deg) <= 2 * sum(count(s, r) for s, r, _ in stages):
        return [(step_deg, range_deg, False)]
    return stages


def grid(centers: torch.Tensor, step_deg: float, range_deg: float, limes_deg: float):
    """Candidate angles [F, K] (float64) and their validity: ``center -
    range`` to ``center + range`` in steps, clamped to +-limes, each
    normalised to [-pi, pi)."""
    step, rng, limes = (math.radians(v) for v in (step_deg, range_deg, limes_deg))
    K = int(math.ceil(2.0 * rng / step)) + 2
    start = torch.clamp(centers - rng, min=-limes)
    stop = torch.clamp(centers + rng, max=limes)
    steps = torch.clamp(torch.ceil((stop - start) / step), min=1.0)
    i = torch.arange(K, dtype=torch.float64, device=centers.device)
    raw = start[:, None] + i[None, :] * step
    valid = (i[None, :] <= steps[:, None]) & (raw <= stop[:, None]) & (stop >= start)[:, None]
    return torch.remainder(raw + math.pi, TWO_PI) - math.pi, valid


def cost_table(test: torch.Tensor, ref: torch.Tensor, angles: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """[F, K]: the squared symmetric Hausdorff distance between each test
    set turned by each angle and its reference set, every step in
    ``dtype``."""
    test, ref, angles = test.to(dtype), ref.to(dtype), angles.to(dtype)
    F, N, _ = test.shape
    M = ref.shape[1]
    K = angles.shape[1]
    out = torch.empty((F, K), dtype=dtype, device=test.device)
    rows = max(1, min(F, TILE_ELEMENTS // (N * M)))
    for f0 in range(0, F, rows):
        t, r = test[f0:f0 + rows], ref[f0:f0 + rows]
        g = max(1, TILE_ELEMENTS // (t.shape[0] * N * M))
        for k0 in range(0, K, g):
            th = angles[f0:f0 + rows, k0:k0 + g].T[:, :, None]  # [G, f, 1]
            c, s = torch.cos(th), torch.sin(th)
            rx = t[None, :, :, 0] * c - t[None, :, :, 1] * s  # [G, f, N]
            ry = t[None, :, :, 0] * s + t[None, :, :, 1] * c
            dx = rx[..., :, None] - r[None, :, None, :, 0]
            dy = ry[..., :, None] - r[None, :, None, :, 1]
            d2 = dx * dx + dy * dy  # [G, f, N, M]
            cost = torch.maximum(d2.amin(-1).amax(-1), d2.amin(-2).amax(-1))
            out[f0:f0 + rows, k0:k0 + g] = cost.T
    return out


def chain_ladder(pts: np.ndarray, step_deg: float, range_deg: float,
                 device, dtype: torch.dtype = torch.float64):
    """Best relative rotation (radians, float64) of every consecutive pair:
    frame i + 1's set turned onto frame i's, stage by stage."""
    p = torch.as_tensor(pts, dtype=torch.float64, device=device)
    test, ref = p[1:], p[:-1]
    best = torch.zeros(test.shape[0], dtype=torch.float64, device=device)
    for stage_step, stage_range, centred in ladder_stages(step_deg, range_deg):
        centers = best if centred else torch.zeros_like(best)
        angles, valid = grid(centers, stage_step, stage_range, range_deg)
        costs = cost_table(test, ref, angles, dtype)
        costs = torch.where(valid, costs, torch.full_like(costs, math.inf))
        k = torch.argmin(costs, dim=1)
        best = torch.gather(angles, 1, k[:, None])[:, 0]
    return best.cpu().numpy()


def pair_costs(pts: np.ndarray, theta: np.ndarray, device) -> np.ndarray:
    """float64 cost of turning frame i + 1's set by ``theta[i]`` onto frame
    i's."""
    p = torch.as_tensor(pts, dtype=torch.float64, device=device)
    th = torch.as_tensor(theta, dtype=torch.float64, device=device)[:, None]
    return cost_table(p[1:], p[:-1], th, torch.float64)[:, 0].cpu().numpy()


def _farthest_pair(xyz: np.ndarray):
    d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    d2[np.tril_indices(len(xyz))] = -1.0
    k = int(np.argmax(d2))
    i, j = divmod(k, len(xyz))
    return i, j, math.sqrt(d2[i, j])


def elliptic_ratio(xyz: np.ndarray) -> float:
    """Longest chord over the shortest chord between points half a contour
    apart."""
    major = _farthest_pair(xyz)[2]
    n = len(xyz)
    minor = float(np.sqrt(((xyz - xyz[(np.arange(n) + n // 2) % n]) ** 2).sum(-1)).min())
    return minor / major if major < minor else major / minor


def _axis_rotation(p1, p2, ref_xy, anomalous: bool) -> float:
    """The rotation about ``p1`` that lays the axis p1 -> p2 along +x (an
    anomalous vessel: +y), turned half a circle more where the reference
    point would not lie right of both axis points."""
    rotation = ((math.pi / 2.0 if anomalous else 0.0)
                - math.atan2(p2[1] - p1[1], p2[0] - p1[0])) % TWO_PI

    def turned_x(pt):
        dx, dy = pt[0] - p1[0], pt[1] - p1[1]
        return dx * math.cos(rotation) - dy * math.sin(rotation) + p1[0]

    eps = np.finfo(np.float64).eps
    ref_x = turned_x(ref_xy)
    for op in (p1, p2):
        if abs(op[0] - ref_xy[0]) <= eps and abs(op[1] - ref_xy[1]) <= eps:
            continue
        if ref_x <= turned_x(op):
            return (rotation + math.pi) % TWO_PI
    return rotation


def finish(b: dict, delta: np.ndarray, smooth: bool, host_dtype=np.float64) -> dict:
    """Final coordinates [F, P, 3] by kind after applying the relative
    rotations ``delta`` [F - 1] (radians), the coordinate arithmetic in
    ``host_dtype``."""
    return finish_geometry(b, delta, smooth, host_dtype)["coords"]


def finish_geometry(b: dict, delta: np.ndarray, smooth: bool,
                    host_dtype=np.float64, starts=None) -> dict:
    """:func:`finish` as a whole geometry: ``coords`` by kind, the frames'
    ``centroid`` [F, 3] (moved with their frames, not smoothed), ``ref`` (the
    reference point's frame), ``ref_point`` [3] and ``ties``: for each frame
    whose turned lumen has more than one point within :data:`START_TIE_MM`
    of its greatest y, the other starts it could take (offsets into the
    contour as started here).  ``starts`` (frame: offset) starts those
    frames' lumens there instead, before the wall and the smoothing."""
    F = b["lumen"].shape[0]
    cum = np.concatenate([[0.0], np.cumsum(delta)])
    c = b["centroid"]
    c0 = c[0, :2]
    r = b["ref_pos"]

    def place(p, i, angle):
        """Point ``p`` of frame ``i`` turned by ``angle`` about the frame's
        centroid and moved onto frame 0's."""
        dx, dy = p[0] - c[i, 0], p[1] - c[i, 1]
        return (dx * math.cos(angle) - dy * math.sin(angle) + c0[0],
                dx * math.sin(angle) + dy * math.cos(angle) + c0[1])

    ref_lumen = b["lumen"][r]
    anomalous = elliptic_ratio(ref_lumen) > 2.0
    ref_xy = place(b["ref_xy"], r, cum[r])
    if anomalous:
        i1, i2, _ = _farthest_pair(ref_lumen)
        p1, p2 = place(ref_lumen[i1], r, cum[r]), place(ref_lumen[i2], r, cum[r])
    else:
        p1, p2 = (c0[0], c0[1]), ref_xy
    extra = _axis_rotation(p1, p2, ref_xy, anomalous)
    total = cum + extra

    def transform(xyz):
        """Turned about the frame's centroid, then moved onto frame 0's, in
        that order of operations: where two points lie level at the top of
        a frame (a real contour's closing points), which comes first is
        decided in the last bit."""
        h = host_dtype
        ct, st = np.cos(total).astype(h)[:, None], np.sin(total).astype(h)[:, None]
        cx, cy = c[:, None, 0].astype(h), c[:, None, 1].astype(h)
        dx, dy = (c0[0] - c[:, None, 0]).astype(h), (c0[1] - c[:, None, 1]).astype(h)
        x = xyz[:, :, 0].astype(h) - cx
        y = xyz[:, :, 1].astype(h) - cy
        out = xyz.copy()
        out[:, :, 0] = x * ct - y * st + cx + dx
        out[:, :, 1] = x * st + y * ct + cy + dy
        return out

    def roll(xyz):
        """Each frame's points started again at its last point of greatest y
        (a rotation keeps their circular order)."""
        if extra == 0.0:
            return xyz
        n = xyz.shape[1]
        start = n - 1 - np.argmax(xyz[:, ::-1, 1], axis=1)
        idx = (np.arange(n)[None, :] + start[:, None]) % n
        return np.take_along_axis(xyz, idx[:, :, None], axis=1)

    out = {"Lumen": roll(transform(b["lumen"])), "Catheter": roll(transform(b["catheter"]))}
    lum = out["Lumen"]
    ties = {}
    if extra != 0.0:
        near = (lum[:, :1, 1] - lum[:, :, 1]) <= START_TIE_MM
        near[:, 0] = False
        ties = {int(f): np.nonzero(near[f])[0].tolist() for f in np.nonzero(near.any(axis=1))[0]}
    for f, k in (starts or {}).items():
        lum[f] = np.roll(lum[f], -k, axis=0)
    xy = lum[:, :, :2].astype(host_dtype)
    rel = xy - xy.mean(axis=1, keepdims=True)
    wall = lum.copy()
    wall[:, :, :2] = xy + rel / np.linalg.norm(rel, axis=-1, keepdims=True)
    out["Wall"] = wall
    if smooth:
        prev_i = np.maximum(np.arange(F) - 1, 0)
        next_i = np.minimum(np.arange(F) + 1, F - 1)
        for k in ("Lumen", "Wall"):
            xyz = out[k]
            xyz[:, :, :2] = (xyz[prev_i, :, :2] + xyz[:, :, :2] + xyz[next_i, :, :2]) / 3.0
    moved = np.column_stack([c[:, 0] + (c0[0] - c[:, 0]), c[:, 1] + (c0[1] - c[:, 1]), c[:, 2]])
    px, py = moved[r, 0], moved[r, 1]
    dx, dy = ref_xy[0] - px, ref_xy[1] - py
    ref_point = np.array([dx * math.cos(extra) - dy * math.sin(extra) + px,
                          dx * math.sin(extra) + dy * math.cos(extra) + py, b["ref_z"]])
    return {"coords": out, "centroid": moved, "ref": r, "ref_point": ref_point,
            "anomalous": anomalous, "ties": ties}


def frame_distances(a: np.ndarray, b: np.ndarray, device) -> np.ndarray:
    """[F]: the symmetric Hausdorff distance (mm) between the point sets
    ``a[f]`` and ``b[f]`` (each [F, P, 3]); +inf a frame where the shapes
    differ."""
    if a.shape != b.shape:
        return np.full(max(len(a), len(b), 1), math.inf)
    ta = torch.as_tensor(a, dtype=torch.float64, device=device)
    tb = torch.as_tensor(b, dtype=torch.float64, device=device)
    out = []
    for f0 in range(0, a.shape[0], 32):
        d = torch.cdist(ta[f0:f0 + 32], tb[f0:f0 + 32], compute_mode="donot_use_mm_for_euclid_dist")
        out.append(torch.maximum(d.amin(-1).amax(-1), d.amin(-2).amax(-1)).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def set_distance(a: np.ndarray, b: np.ndarray, device) -> float:
    """Largest, over frames, of :func:`frame_distances`."""
    d = frame_distances(a, b, device)
    return float(d.max()) if d.size else 0.0


# the least cost a relative gap is taken against (mm^2): two frames whose
# sets coincide cost 0 at their best angle
COST_FLOOR = 1e-9


def logged_radians(deg, args: dict) -> np.ndarray:
    """The program's angles from the degrees it logged.  Where the search is
    one sweep of one grid (the plan of the four-phase defaults), each angle
    is that grid's float64 value within 1e-12 rad of it: ``np.radians`` of
    a logged ``np.degrees`` can land an ulp off, and the finish turns by
    the sum of these angles, where a real contour's two level top points
    change order on the last bit.  Otherwise ``np.radians``."""
    theta = np.radians(np.asarray(deg, dtype=np.float64))
    stages = ladder_stages(args["step_rotation_deg"], args["range_rotation_deg"])
    if len(stages) != 1:
        return theta
    step, rng, _ = stages[0]
    angles, valid = grid(torch.zeros(1, dtype=torch.float64), step, rng, rng)
    g = angles[0][valid[0]].numpy()
    k = np.abs(g[None, :] - theta[:, None]).argmin(axis=1)
    return np.where(np.abs(g[k] - theta) <= 1e-12, g[k], theta)


def register(lumen: np.ndarray, ref_point: np.ndarray, args: dict, device,
             dtype: torch.dtype = torch.float64, host_dtype=np.float64) -> dict:
    """The reference's own registration in the program's output form:
    ``logs`` [F - 1, 7] (frame, matched frame, rotation in degrees, tx, ty,
    centroid x, y after the move) and ``coords`` by kind.  ``dtype`` is the
    cost tables' and ``host_dtype`` the centroids' and the final
    coordinates' arithmetic (float64 both; the lower-precision control
    takes the precision below the program's: bfloat16 tables for its
    float32 tables, float32 geometry for its float64 host geometry)."""
    b = build(lumen, ref_point, args["image_center"], args["radius"], args["n_points"],
              host_dtype)
    pts = sample_sets(b, args["sample_size"])
    delta = chain_ladder(pts, args["step_rotation_deg"], args["range_rotation_deg"],
                         device, dtype)
    c = b["centroid"]
    t = c[0, :2] - c[1:, :2]
    F = len(c)
    logs = np.column_stack([np.arange(1, F), np.arange(F - 1), np.degrees(delta),
                            t, c[1:, :2] + t])
    return {"logs": logs, "coords": finish(b, delta, args["smooth"], host_dtype)}


def judge_chain(lumen: np.ndarray, ref_point: np.ndarray, args: dict, logs, device) -> dict:
    """A pullback's logged frame pairs against the reference:
    ``centroid_gap_mm`` (the build's frame order and centroids, read from
    each pair's logged translation and moved centroid) and ``angle_gap_rel``
    (each pair's rotation, by the float64 cost of the program's angle
    against the cost of the reference ladder's own answer, relative to the
    latter: 0 where both chose one grid angle)."""
    b = build(lumen, ref_point, args["image_center"], args["radius"], args["n_points"])
    F = len(b["centroid"])
    logs = np.asarray(logs, dtype=np.float64)
    if logs.shape != (F - 1, 7) or not (
            np.array_equal(logs[:, 0], np.arange(1, F))
            and np.array_equal(logs[:, 1], np.arange(F - 1))):
        return {"centroid_gap_mm": math.inf, "angle_gap_rel": math.inf}
    c = b["centroid"]
    t = c[0, :2] - c[1:, :2]
    centroid_gap = float(max(np.abs(logs[:, 3:5] - t).max(),
                             np.abs(logs[:, 5:7] - (c[1:, :2] + t)).max()))
    pts = sample_sets(b, args["sample_size"])
    own = chain_ladder(pts, args["step_rotation_deg"], args["range_rotation_deg"], device)
    got = pair_costs(pts, logged_radians(logs[:, 2], args), device)
    best = pair_costs(pts, own, device)
    angle_gap = float((np.abs(got - best) / np.maximum(best, COST_FLOOR)).max())
    return {"centroid_gap_mm": centroid_gap,
            "angle_gap_rel": angle_gap if np.isfinite(angle_gap) else math.inf}


def judge(lumen: np.ndarray, ref_point: np.ndarray, args: dict, out: dict, device) -> dict:
    """The program's answer ``out`` (as :func:`register` returns it) held
    against the reference: :func:`judge_chain`'s two numbers and
    ``coord_gap_mm``, the final coordinates of every kind against the
    reference's finish applied to the program's rotations, frame by frame as
    point sets (the search is judged by the number before)."""
    got = judge_chain(lumen, ref_point, args, out["logs"], device)
    if not np.isfinite(got["angle_gap_rel"]):
        return {**got, "coord_gap_mm": math.inf}
    b = build(lumen, ref_point, args["image_center"], args["radius"], args["n_points"])
    theta = logged_radians(np.asarray(out["logs"], dtype=np.float64)[:, 2], args)
    want = finish(b, theta, args["smooth"])
    coord_gap = max(set_distance(np.asarray(out["coords"][k]), want[k], device)
                    if k in out["coords"] else math.inf for k in want)
    return {**got, "coord_gap_mm": float(coord_gap)}
