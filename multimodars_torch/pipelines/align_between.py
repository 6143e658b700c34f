"""Inter-pullback alignment: register geometry B onto geometry A.

Parity: ``src/intravascular/processing/align_between.rs`` of the reference.

The global point clouds (>= 500 sampled lumen points per geometry) go
through the same batched rotation search as align_within, one slot per
(A, B) pair, masked to each slot's widths, with the reference cloud's
global centroid as pivot.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..config import config
from ..models.contour import downsample_indices
from ..models.geometry import PyGeometry, PyGeometryPair, shared_contour_blocks
from ..ops.argmin_repair import center_clouds, pack_sets, repair_between, split_packed
from ..ops.rotation_search import multires_rotation_search_packed
from ..utils.device import to_device
from ..utils.trace import span


def extract_geometry_points(geometry: PyGeometry, sample_size: int) -> np.ndarray:
    """Proportionally downsampled lumen points over all frames, (n, 2) xy.
    Parity: extract_geometry_points_with_frame_info (align_between.rs:154-178).
    """
    total_points = sum(f.lumen.n_points for f in geometry.frames)
    sample_ratio = sample_size / total_points
    rows = []
    for frame in geometry.frames:
        n = frame.lumen.n_points
        frame_n = max(int(np.ceil(n * sample_ratio)), 1)
        rows.append(frame.lumen.xyz_view()[downsample_indices(n, frame_n), :2])
    return np.concatenate(rows, axis=0)


def rotate_geometry_around_point(
    geometry: PyGeometry, angle_rad: float, center: Tuple[float, float, float]
) -> None:
    """Rotate the whole geometry (points, centroids, reference points) about
    a single pivot.  Parity: align_between.rs:95-145."""
    c = np.cos(angle_rad)
    s = np.sin(angle_rad)
    cx, cy = center[0], center[1]

    def rot(x, y):
        tx, ty = x - cx, y - cy
        return tx * c - ty * s + cx, tx * s + ty * c + cy

    blocks = shared_contour_blocks(geometry.frames)
    if blocks is not None:
        # block fast path: identical per-element expressions, one pass per
        # shared [F, N, 3] view block instead of per-contour numpy calls
        for base, rows, _contours in blocks:
            sub = base[rows]
            tx = sub[:, :, 0] - cx
            ty = sub[:, :, 1] - cy
            sub[:, :, 0] = tx * c - ty * s + cx
            sub[:, :, 1] = tx * s + ty * c + cy
            base[rows] = sub
        for frame in geometry.frames:
            for contour in frame.extras.values():
                if contour.centroid is not None:
                    ccx, ccy = rot(contour.centroid[0], contour.centroid[1])
                    contour.centroid = (ccx, ccy, contour.centroid[2])
            fx, fy = rot(frame.centroid[0], frame.centroid[1])
            frame.centroid = (fx, fy, frame.centroid[2])
            if frame.reference_point is not None:
                rx, ry = rot(frame.reference_point.x, frame.reference_point.y)
                frame.reference_point.x = rx
                frame.reference_point.y = ry
        return

    for frame in geometry.frames:
        for contour in [frame.lumen, *frame.extras.values()]:
            xyz = contour.xyz()
            tx = xyz[:, 0] - cx
            ty = xyz[:, 1] - cy
            xyz[:, 0] = tx * c - ty * s + cx
            xyz[:, 1] = tx * s + ty * c + cy
            contour.set_xyz(xyz)
            if contour is not frame.lumen and contour.centroid is not None:
                ccx, ccy = rot(contour.centroid[0], contour.centroid[1])
                contour.centroid = (ccx, ccy, contour.centroid[2])
        fx, fy = rot(frame.centroid[0], frame.centroid[1])
        frame.centroid = (fx, fy, frame.centroid[2])
        if frame.reference_point is not None:
            rx, ry = rot(frame.reference_point.x, frame.reference_point.y)
            frame.reference_point.x = rx
            frame.reference_point.y = ry


def pack_between(clouds: List[Tuple[np.ndarray, np.ndarray]]):
    """The between search's batch for ``clouds``: one slot per
    (reference_xy, target_xy) pair, centred on the reference cloud's mean,
    padded and masked.  Returns ``(test, ref, tmask, rmask)`` f64 arrays."""
    return pack_sets(*center_clouds(clouds))


def dispatch_between_search(
    clouds: List[Tuple[np.ndarray, np.ndarray]],
    step_deg: float,
    range_deg: float,
    bruteforce: bool = False,
) -> np.ndarray:
    """The batched between-geometry rotation search: every slot of
    :func:`pack_between` through a single search — the batched form of the
    reference's concurrent align-between threads (entry.rs:206-277).
    Returns the packed ``[2 * slots]`` f64 vector (angles | tie flags)."""
    dtype = config.compute_dtype
    test, ref, tmask, rmask = pack_between(clouds)
    return multires_rotation_search_packed(
        to_device(test, dtype),
        to_device(ref, dtype),
        to_device(tmask),
        to_device(rmask),
        float(step_deg),
        float(range_deg),
        bool(bruteforce),
    ).cpu().numpy()


def between_stage(
    pairs_defs: List[Tuple[PyGeometry, PyGeometry]],
    step_deg: float,
    range_deg: float,
    sample_size: int,
    verbose: bool = True,
    repair_bruteforce: bool = False,
):
    """One between-geometry stage: every (A, B) slot's clouds are built
    from the geometries as they stand (B's cloud moved by the initial
    translation only), all slots are searched in one masked batch, flagged
    slots are repaired, then each B is moved onto its A and the pair is
    built from copies.  Each slot follows align_between.rs:11-92; B is
    mutated in place like the reference.

    The search resolves its plan from (step, range) alone, as the JAX
    package's between searches do; the repair of flagged slots uses
    ``repair_bruteforce``, which the JAX package's full path sets to the
    caller's ``bruteforce`` and its pair paths to False (entry.py:575-580
    against :203-209 there).

    Returns ``(pairs, rotations, clouds)``: the built pairs, the winning
    angle per slot and the (reference, target) clouds it was searched on."""
    between_sample = max(sample_size, 500)
    preps, clouds = [], []
    with span("align_between.clouds"):
        for A, B in pairs_defs:
            ca = A.frames[A.ref_or_proximal_idx()].centroid
            cb = B.frames[B.ref_or_proximal_idx()].centroid
            t0 = tuple(ca[k] - cb[k] for k in range(3))
            cloud_ref = extract_geometry_points(A, between_sample)
            cloud_tgt = extract_geometry_points(B, between_sample) + np.array(
                [t0[0], t0[1]]
            )
            preps.append((ca, t0))
            clouds.append((cloud_ref, cloud_tgt))
    with span("align_between.search"):
        rot, ties = split_packed(dispatch_between_search(clouds, step_deg, range_deg))
    with span("align_between.repair"):
        rot = repair_between(
            rot, ties, clouds, float(step_deg), float(range_deg),
            bool(repair_bruteforce),
        )
    pairs = []
    with span("align_between.epilogue"):
        for (A, B), (ca, t0), r in zip(pairs_defs, preps, rot):
            apply_between_epilogue(A, B, float(r), ca, t0, range_deg, step_deg, verbose)
            pairs.append(build_pair(A, B))
    return pairs, rot, clouds


def align_between_geometries(
    geom_a: PyGeometry,
    geom_b: PyGeometry,
    rot_deg: float,
    step_rot_deg: float,
    sample_size: int,
    verbose: bool = True,
) -> PyGeometryPair:
    """Translate B's reference frame onto A's, find the best global rotation,
    apply it about A's reference centroid, then re-translate exactly.
    Parity: align_between.rs:11-92.  Mutates geom_b in place like the
    reference; the returned pair holds copies."""
    pairs, _, _ = between_stage(
        [(geom_a, geom_b)], step_rot_deg, rot_deg, sample_size, verbose
    )
    return pairs[0]


def _fused_between_epilogue_blocks(
    geom_a: PyGeometry,
    geom_b: PyGeometry,
    blocks,
    best_rotation: float,
    ref_a_centroid,
    initial_translation,
):
    """One-pass form of translate(t0) -> rotate about A's ref centroid ->
    exact re-translate over B's shared coordinate blocks.

    Bitwise-identical to the three sequential passes: each element runs the
    same f64 operation chain in the same order (add t0, the rotate
    expression of :func:`rotate_geometry_around_point`, add the final
    translation), the contour centroids are the means of exactly those
    final values (the sequential path's intermediate means are dead — the
    final translate recomputes them), and the final translation itself
    comes from B's reference frame centroid through the identical scalar
    steps.  Returns the final translation for narration."""
    c = np.cos(best_rotation)
    s = np.sin(best_rotation)
    cax, cay = ref_a_centroid[0], ref_a_centroid[1]
    t0x, t0y, t0z = initial_translation

    def scalar_chain(px, py, pz):
        # the exact translate -> rotate -> (pre-ft) scalar sequence
        x1, y1, z1 = px + t0x, py + t0y, pz + t0z
        tx, ty = x1 - cax, y1 - cay
        return tx * c - ty * s + cax, tx * s + ty * c + cay, z1

    ref_idx_a = geom_a.ref_or_proximal_idx()
    ref_idx_b = geom_b.ref_or_proximal_idx()
    final_a = geom_a.frames[ref_idx_a].centroid
    cb = geom_b.frames[ref_idx_b].centroid
    bx, by, bz = scalar_chain(cb[0], cb[1], cb[2])
    ftx, fty, ftz = final_a[0] - bx, final_a[1] - by, final_a[2] - bz

    for base, rows, contours in blocks:
        if base.shape[1] == 0:  # compute_centroid's empty case
            for cont in contours:
                cont.centroid = (0.0, 0.0, 0.0)
            continue
        sub = base[rows]
        x1 = sub[:, :, 0] + t0x
        y1 = sub[:, :, 1] + t0y
        z1 = sub[:, :, 2] + t0z
        tx = x1 - cax
        ty = y1 - cay
        sub[:, :, 0] = (tx * c - ty * s + cax) + ftx
        sub[:, :, 1] = (tx * s + ty * c + cay) + fty
        sub[:, :, 2] = z1 + ftz
        base[rows] = sub
        means = sub.mean(axis=1).tolist()
        for m, cont in zip(means, contours):
            cont.centroid = (m[0], m[1], m[2])
    for frame in geom_b.frames:
        fx, fy, fz = scalar_chain(*frame.centroid)
        frame.centroid = (fx + ftx, fy + fty, fz + ftz)
        rp = frame.reference_point
        if rp is not None:
            rx, ry, rz = scalar_chain(rp.x, rp.y, rp.z)
            rp.x, rp.y, rp.z = rx + ftx, ry + fty, rz + ftz
    return (ftx, fty, ftz)


def apply_between_epilogue(
    geom_a: PyGeometry,
    geom_b: PyGeometry,
    best_rotation: float,
    ref_a_centroid,
    initial_translation,
    rot_deg: float,
    step_rot_deg: float,
    verbose: bool,
) -> None:
    """Mutating tail of the between-alignment: move B by the initial
    translation (so far applied only to its search cloud), rotate it about
    A's reference centroid, re-translate exactly, narrate."""
    blocks = shared_contour_blocks(geom_b.frames)
    if blocks is not None:
        final_translation = _fused_between_epilogue_blocks(
            geom_a, geom_b, blocks, best_rotation, ref_a_centroid,
            initial_translation,
        )
    else:
        geom_b.translate_geometry(initial_translation)
        rotate_geometry_around_point(geom_b, best_rotation, ref_a_centroid)

        ref_idx_a = geom_a.ref_or_proximal_idx()
        ref_idx_b = geom_b.ref_or_proximal_idx()
        final_a = geom_a.frames[ref_idx_a].centroid
        final_b = geom_b.frames[ref_idx_b].centroid
        final_translation = tuple(final_a[k] - final_b[k] for k in range(3))
        geom_b.translate_geometry(final_translation)

    if verbose:
        print(f"\n✅ Aligned geometry '{geom_b.label}' to '{geom_a.label}'")
        print("-----------------------------------------")
        print(
            f"Applied initial translation: ({initial_translation[0]:.2f}, "
            f"{initial_translation[1]:.2f}, {initial_translation[2]:.2f}) mm"
        )
        print(
            f"Found best rotation of {np.degrees(best_rotation):.2f}° with "
            f"parameters: \nrange: {rot_deg:.2f}° \nstep size: {step_rot_deg:.2f}°"
        )
        print(
            f"Applied final translation: ({final_translation[0]:.2f}, "
            f"{final_translation[1]:.2f}, {final_translation[2]:.2f}) mm"
        )
        print("-----------------------------------------")


def build_pair(geom_a: PyGeometry, geom_b: PyGeometry) -> PyGeometryPair:
    """Pair with exclusive copies; parity with GeometryPair::new
    (geometry_pair.rs:12-19)."""
    return PyGeometryPair(
        geom_a.copy(), geom_b.copy(), f"{geom_a.label} - {geom_b.label}"
    )
