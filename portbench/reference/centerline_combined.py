"""Plain reference of ``align_combined``: one pullback registered onto a CCTA
centerline by a three-point start and a Hausdorff refinement over
(centerline shift x in-plane angle) against the vessel's surface points.

Written from the semantics of the reference project (multimoda-rs:
``centerline_align/preprocessing.rs:12-102``, ``align_algorithms.rs:65-451``,
``align.rs:168-284``, ``geometry.rs:241-250``) as the JAX package's
``pipelines/centerline_align.py`` states them, for the inputs the
benchmark's traffic makes: lumen rows ``[frame, x, y, z]`` of one contour a
frame, one reference point given as an array row, no other contour, no
wall.  It imports numpy and torch only, never the program under test, and
takes nothing the program made: the centerline is branch 0 as the traffic
read it from the file (positions and radii in the file's order).

- :func:`pullback`: each frame's points in the order given, its centroid the
  mean of its points;
- :func:`centerline`: forward-difference tangents, the points put in
  descending z (each keeps its tangent), resampled every mean spacing of the
  frame centroids;
- :func:`three_point`: the angle, on a grid of ``step`` from 0, that turns
  the first frame about its Newell normal so that its tracked points, once
  mapped onto the centerline point nearest the first landmark, lie nearest
  the three landmarks (first wins);
- :func:`search`: the pullback turned by that angle and mapped frame by
  frame onto the centerline from that point; then, one candidate at a time,
  for each centerline shift of the grid whose segment fits and whose
  bounding box (5 mm margin) holds cloud points, and each angle of the
  accumulated grid, the candidate's points (every frame turned in its
  plane's xy, started at its last point of greatest y, downsampled to the
  cloud's density, mapped onto the shifted segment) and the exact squared
  2-D Hausdorff distance against the box's cloud points;
- :func:`finish`: the first-wins minimum of the distances' square roots,
  the pullback turned by the start plus the winner's angle and mapped from
  the winner's centerline point.

Departures from the published description, each as the JAX package makes
it: a refine candidate's start after the turn is a cyclic roll of the
contour's order to its last point of greatest y (the re-sort by angle
before it), and each frame's map onto the shifted segment is taken from
the frame before the turn.  A turn by exactly 0 leaves a pullback as it is,
unsorted (``geometry.rs``'s early return).  The Hausdorff distances are
exact in float64 (``dx*dx + dy*dy``, each operation rounded, exact minima
and maxima) on the device the judge is given, in row blocks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# elements of one [rows, cloud points] block of a Hausdorff distance
BLOCK_ELEMENTS = 1 << 25
# margin (mm) of the refine's bounding box of a centerline segment
BOX_MARGIN_MM = 5.0


def pullback(lumen: np.ndarray, dt=np.float64):
    """(points [F, P, 3], centroids [F, 3]) of the lumen rows, frames in
    ascending frame number."""
    frames = lumen[:, 0].astype(np.int64)
    per = [lumen[frames == f][:, 1:4] for f in np.unique(frames)]
    if len({len(p) for p in per}) != 1:
        raise ValueError("every frame must carry the same number of lumen points")
    xyz = np.stack(per).astype(dt)
    return xyz, xyz.mean(axis=1)


def _tangents(pos: np.ndarray) -> np.ndarray:
    diff = pos[1:] - pos[:-1]
    norm = np.sqrt((diff * diff).sum(-1))
    ok = norm > 1e-12
    tan = np.zeros_like(pos)
    tan[:-1] = np.where(ok[:, None], diff / np.where(ok, norm, 1.0)[:, None], 0.0)
    tan[-1] = tan[-2]
    return tan


def centerline(pos: np.ndarray, centroids: np.ndarray):
    """(positions [L', 3], unit tangents [L', 3]) of branch 0 (``pos`` in
    the file's order) after preprocessing.rs: descending z, resampled every
    mean distance of consecutive frame centroids from arc 0 to its end."""
    pos = pos.astype(centroids.dtype)
    tan = _tangents(pos)
    if pos[0, 2] < pos[-1, 2]:
        pos, tan = pos[::-1], tan[::-1]
    steps = np.sqrt(((centroids[1:] - centroids[:-1]) ** 2).sum(-1))
    seg = np.sqrt(((pos[1:] - pos[:-1]) ** 2).sum(-1))
    cum = np.concatenate([np.zeros(1, pos.dtype), np.cumsum(seg)])
    total = cum[-1]
    spacing = steps.mean() if steps.size else np.nan
    if not (np.isfinite(spacing) and spacing > 1e-12):
        spacing = total / (len(pos) - 1)
    arcs = []
    s = 0.0
    while s <= total + 1e-9:
        arcs.append(s)
        s += spacing
    s = np.array(arcs, dtype=pos.dtype)
    i = np.maximum(np.searchsorted(cum, s, side="right") - 1, 0)
    tail = i >= len(pos) - 1
    j = np.minimum(i, len(pos) - 2)
    d = cum[j + 1] - cum[j]
    small = np.abs(d) < 1e-12
    t = np.where(small, 0.0, (s - cum[j]) / np.where(small, 1.0, d))[:, None]
    p = pos[j] + t * (pos[j + 1] - pos[j])
    tg = tan[j] * (1.0 - t) + tan[j + 1] * t
    n = np.array([np.linalg.norm(v) for v in tg])
    tg = np.where((n > 1e-12)[:, None], tg / np.where(n > 1e-12, n, 1.0)[:, None], 0.0)
    p[tail], tg[tail] = pos[-1], tan[-1]
    return p.astype(pos.dtype), tg.astype(pos.dtype)


def nearest(points: np.ndarray, point) -> int:
    """The first of the points nearest ``point``."""
    return int(np.argmin(np.sqrt(((points - np.asarray(point)) ** 2).sum(-1))))


def _newell(xyz: np.ndarray, centroid: np.ndarray) -> np.ndarray:
    rel = xyz - centroid
    normal = np.cross(rel, np.roll(rel, -1, axis=0)).sum(axis=0)
    n = np.linalg.norm(normal)
    return normal / n if n > 1e-12 else np.array([0.0, 0.0, 1.0], dtype=xyz.dtype)


def _axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    x, y, z = axis / np.linalg.norm(axis)
    c, s = math.cos(angle), math.sin(angle)
    C = 1.0 - c
    return np.array([[c + x * x * C, x * y * C - z * s, x * z * C + y * s],
                     [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
                     [z * x * C - y * s, z * y * C + x * s, c + z * z * C]], dtype=axis.dtype)


def frame_map(xyz: np.ndarray, centroid: np.ndarray, point: np.ndarray, tangent: np.ndarray):
    """align_algorithms.rs:128-173: the map x -> R (x + point - centroid -
    point) + point that puts the centroid on the centerline point and turns
    the frame's Newell normal onto the tangent about their cross axis."""
    normal = _newell(xyz, centroid)
    rot = np.eye(3, dtype=xyz.dtype)
    tn = np.linalg.norm(tangent)
    if tn > 1e-12:
        angle = math.acos(float(np.clip(np.dot(normal, tangent) / tn, -1.0, 1.0)))
        axis = np.cross(normal, tangent)
        if abs(angle) >= 1e-6 and np.linalg.norm(axis) >= 1e-6:
            rot = _axis_angle(axis, angle)
    return rot, point - centroid, point


def apply_map(m, x: np.ndarray) -> np.ndarray:
    rot, shift, pivot = m
    return (x + shift - pivot) @ rot.T + pivot


def turn_xy(xyz: np.ndarray, centroid: np.ndarray, angle: float) -> np.ndarray:
    """Each frame's points [F, P, 3] turned by ``angle`` in xy about its
    centroid [F, 3]."""
    c, s = math.cos(angle), math.sin(angle)
    cx, cy = centroid[:, None, 0], centroid[:, None, 1]
    x, y = xyz[..., 0] - cx, xyz[..., 1] - cy
    out = xyz.copy()
    out[..., 0] = x * c - y * s + cx
    out[..., 1] = x * s + y * c + cy
    return out


def ccw_sorted(xyz: np.ndarray) -> np.ndarray:
    """Each frame's points [F, P, 3] counter-clockwise about their xy mean,
    stable on equal angles, started at the last point of greatest y."""
    x, y = xyz[:, :, 0], xyz[:, :, 1]
    ang = np.arctan2(y - y.mean(axis=1)[:, None], x - x.mean(axis=1)[:, None])
    order = np.argsort(ang, axis=1, kind="stable")
    ys = np.take_along_axis(y, order, axis=1)
    n = xyz.shape[1]
    start = n - 1 - np.argmax(ys[:, ::-1], axis=1)
    order = np.take_along_axis(order, (np.arange(n)[None, :] + start[:, None]) % n, axis=1)
    return np.take_along_axis(xyz, order[:, :, None], axis=1)


def turned(xyz: np.ndarray, centroid: np.ndarray, angle: float) -> np.ndarray:
    """geometry.rs:241-250: turned and re-sorted, or as it is for 0."""
    return xyz if angle == 0.0 else ccw_sorted(turn_xy(xyz, centroid, angle))


def mapped(xyz, centroid, cl_pos, cl_tan, start: int):
    """align_algorithms.rs:96-126: frame i mapped onto centerline point
    ``start + i`` (a frame past either end stays where it is); returns
    (points, centroids)."""
    out, out_c = xyz.copy(), centroid.copy()
    for i in range(len(xyz)):
        j = start + i
        if 0 <= j < len(cl_pos):
            m = frame_map(xyz[i], centroid[i], cl_pos[j], cl_tan[j])
            out[i] = apply_map(m, xyz[i])
            out_c[i] = apply_map(m, centroid[i][None])[0]
    return out, out_c


def three_point(xyz, centroid, marks, point, tangent, step: float) -> float:
    """align_algorithms.rs:263-336 on the first frame: its points 0 (the
    reference point's index: a reference point given as an array row has
    index 0), 0 (the counter-clockwise side) and P // 2 (the clockwise side)
    turned about the Newell normal through the centroid by k * step, mapped
    onto ``point``; the first angle of least summed squared distance to the
    three landmarks."""
    n = len(xyz)
    normal = _newell(xyz, centroid)
    tracked = xyz[[0, 0, n // 2]]
    m = frame_map(xyz, centroid, point, tangent)
    best, best_err = 0.0, math.inf
    for k in range(int(math.ceil(2.0 * math.pi / step))):
        angle = k * step
        if angle >= 2.0 * math.pi:
            break
        moved = apply_map(m, (tracked - centroid) @ _axis_angle(normal, angle).T + centroid)
        err = float(((moved - marks) ** 2).sum())
        if err < best_err:
            best, best_err = angle, err
    return best


def refine_angles(angle_range: float, step: float) -> list:
    """The refine's grid about 0, accumulated as align_algorithms.rs does."""
    out, a = [], -angle_range
    while a <= angle_range:
        out.append(a)
        a += step
    return out


def hausdorff_sq(a: torch.Tensor, b: torch.Tensor) -> float:
    """Squared symmetric 2-D Hausdorff distance of point sets a [n, 2] and b
    [m, 2], over blocks of a's rows."""
    rows = max(1, BLOCK_ELEMENTS // b.shape[0])
    fwd = torch.full((), -math.inf, dtype=a.dtype, device=a.device)
    bwd = torch.full((b.shape[0],), math.inf, dtype=a.dtype, device=a.device)
    for i in range(0, a.shape[0], rows):
        dx = a[i:i + rows, None, 0] - b[None, :, 0]
        dy = a[i:i + rows, None, 1] - b[None, :, 1]
        d2 = dx * dx + dy * dy
        fwd = torch.maximum(fwd, d2.amin(dim=1).amax())
        bwd = torch.minimum(bwd, d2.amin(dim=0))
    return float(torch.maximum(fwd, bwd.amax()))


def _downsample(P: int, n: int) -> np.ndarray:
    if P <= n:
        return np.arange(P)
    return (np.arange(n) * (P / n)).astype(np.int64)


def candidate(xyz, centroid, maps, keep, angle: float) -> np.ndarray:
    """A refine candidate's xy points [F * len(keep), 2]: each frame turned
    by ``angle`` about its centroid, started at its last point of greatest
    y, the points ``keep`` taken and mapped by its segment map."""
    t = turn_xy(xyz, centroid, angle)
    P = xyz.shape[1]
    start = P - 1 - np.argmax(t[:, ::-1, 1], axis=1)
    idx = (start[:, None] + keep[None, :]) % P
    pts = np.take_along_axis(t, idx[:, :, None], axis=1)
    return np.concatenate([apply_map(m, p) for m, p in zip(maps, pts)])[:, :2]


def search(case: dict, args: dict, device, table_dtype=torch.float64, dt=np.float64) -> dict:
    """Every step up to the refine's table: the costs [S, K] (square roots
    of the squared distances) and what :func:`finish` needs, the pullback
    and centerline on the host in ``dt``, the distances in
    ``table_dtype``."""
    xyz, centroid = pullback(case["lumen"], dt)
    marks = np.asarray(case["landmarks"], dtype=dt)
    cloud = np.asarray(case["cloud"], dtype=dt)
    cl_pos, cl_tan = centerline(case["branch0"][0], centroid)
    step = math.radians(args["angle_step_deg"])
    ref_idx = nearest(cl_pos, marks[0])
    start = three_point(xyz[0], centroid[0], marks, cl_pos[ref_idx], cl_tan[ref_idx], step)
    aligned, aligned_c = mapped(turned(xyz, centroid, start), centroid, cl_pos, cl_tan, ref_idx)
    angles = refine_angles(math.radians(args["angle_range_deg"]), step)
    F, P = xyz.shape[:2]
    r = int(args["index_range"])
    shifts, costs = [], []
    for delta in (range(-r, r + 1) if r else [0]):
        cur = ref_idx + delta
        if cur < 0 or cur + F >= len(cl_pos):
            continue
        lo = np.minimum(cl_pos[cur], cl_pos[cur + F - 1]) - BOX_MARGIN_MM
        hi = np.maximum(cl_pos[cur], cl_pos[cur + F - 1]) + BOX_MARGIN_MM
        near = cloud[((cloud >= lo) & (cloud <= hi)).all(axis=1)]
        if not len(near):
            continue
        keep = _downsample(P, min(max(int(math.ceil(len(near) / (P * F) * P)), 1), P))
        maps = [frame_map(aligned[i], aligned_c[i], cl_pos[cur + i], cl_tan[cur + i])
                for i in range(F)]
        q = torch.as_tensor(near[:, :2], device=device).to(table_dtype)
        for angle in angles:
            p = candidate(aligned, aligned_c, maps, keep, angle)
            costs.append(hausdorff_sq(torch.as_tensor(p, device=device).to(table_dtype), q))
        shifts.append(cur)
    return {"xyz": xyz, "centroid": centroid, "cl_pos": cl_pos, "cl_tan": cl_tan,
            "start": start, "angles": angles, "shifts": shifts,
            "costs": np.sqrt(np.array(costs, dtype=np.float64)).reshape(len(shifts), len(angles))}


def finish(state: dict, s: int, k: int, frames=None):
    """The pullback turned by the start plus angle ``k`` and mapped from the
    centerline point nearest shift ``s``'s (frames ``frames`` alone where
    given): (points, centroids) in float64."""
    xyz, centroid = state["xyz"], state["centroid"]
    if frames is not None:
        xyz, centroid = xyz[frames], centroid[frames]
    cl_pos = state["cl_pos"]
    start = nearest(cl_pos, cl_pos[state["shifts"][s]])
    out, out_c = mapped(turned(xyz, centroid, state["start"] + state["angles"][k]), centroid,
                        cl_pos, state["cl_tan"], start)
    return out.astype(np.float64), out_c.astype(np.float64)


def winner(state: dict):
    """(shift slot, angle slot) of the first least cost."""
    return np.unravel_index(int(np.argmin(state["costs"])), state["costs"].shape)


def register(case: dict, args: dict, device, table_dtype=torch.float64, dt=np.float64) -> dict:
    """The registration's answer in the entry's form: ``coords`` by kind,
    ``centroids`` [F, 3]."""
    state = search(case, args, device, table_dtype, dt)
    xyz, c = finish(state, *winner(state))
    return {"coords": {"Lumen": xyz}, "centroids": c}


def judge(case: dict, ans: dict, args: dict, device) -> dict:
    """The program's answer against the reference.  The candidate the
    program chose is the one whose finish of the first frame lies nearest
    the program's first frame; ``cost_gap_rel`` is its exact cost less the
    least, over the least; ``coord_gap_mm`` and ``centroid_gap_mm`` the
    largest differences of the program's points and frame centroids from
    that candidate's finish."""
    state = search(case, args, device)
    won = winner(state)
    coords = ans["coords"]
    if set(coords) != {"Lumen"} or coords["Lumen"].shape != state["xyz"].shape:
        return {"cost_gap_rel": math.inf, "coord_gap_mm": math.inf, "centroid_gap_mm": math.inf}
    lumen = coords["Lumen"]
    S, K = state["costs"].shape
    first = [float(np.abs(finish(state, s, k, [0])[0] - lumen[:1]).max())
             for s in range(S) for k in range(K)]
    chosen = np.unravel_index(int(np.argmin(first)), (S, K))
    xyz, c = finish(state, *chosen)
    least = state["costs"][won]
    gap = state["costs"][chosen] - least
    return {"cost_gap_rel": float(gap / least) if least > 0 else (0.0 if gap == 0 else math.inf),
            "coord_gap_mm": float(np.abs(xyz - lumen).max()),
            "centroid_gap_mm": float(np.abs(c - ans["centroids"]).max())}
