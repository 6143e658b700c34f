"""Geometry construction funnel + the 8-check integrity gate.

Parity: ``src/intravascular/io/build.rs`` and
``src/intravascular/io/integrity_check.rs`` of the reference.  Every entry
point (file or array) builds through here.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..models.contour import PyContour
from ..models.frame import PyFrame, create_catheter_points
from ..models.geometry import PyGeometry
from ..models.point import PyContourPoint
from ..models.record import PyRecord
from .csv_io import InputData, process_directory


def points_to_array(points) -> np.ndarray:
    """(N, 6) [frame, x, y, z, point_index, aortic] from a point list or an
    (N, >=4) array."""
    if isinstance(points, np.ndarray):
        arr = np.asarray(points, dtype=np.float64)
        out = np.zeros((arr.shape[0], 6))
        out[:, :4] = arr[:, :4]
        if arr.shape[1] > 4:
            out[:, 5] = arr[:, 4]
        return out
    out = np.empty((len(points), 6))
    for i, p in enumerate(points):
        out[i, 0] = p.frame_index
        out[i, 1] = p.x
        out[i, 2] = p.y
        out[i, 3] = p.z
        out[i, 4] = p.point_index
        out[i, 5] = p.aortic
    return out


def build_contours_with_mapping(
    points,
    records: Optional[List[PyRecord]],
    kind: str,
    frame_mapping: Dict[int, int],
) -> List[PyContour]:
    """Group raw points by frame_index, map to shared sequential ids, attach
    lumen measurements.  Parity: Contour::build_contour_with_mapping
    (contour.rs:158-211).  Accepts point lists or (N, >=4) arrays."""
    arr = points_to_array(points)

    measurements = None
    if kind == "Lumen":
        measurements = {}
        if records:
            for r in records:
                measurements[r.frame] = (r.measurement_1, r.measurement_2)

    frames = arr[:, 0].astype(np.int64)
    order = np.argsort(frames, kind="stable")  # preserves within-frame order
    arr = arr[order]
    frames = frames[order]
    uniq, starts = np.unique(frames, return_index=True)
    bounds = np.append(starts, len(frames))

    coords_all = np.ascontiguousarray(arr[:, 1:4])
    point_idx_all = arr[:, 4].astype(np.int64)
    aortic_all = arr[:, 5].astype(bool)

    contours: List[PyContour] = []
    for k, original_frame_idx in enumerate(uniq.tolist()):
        if original_frame_idx not in frame_mapping:
            raise KeyError(f"No mapping found for original frame {original_frame_idx}")
        sequential_id = frame_mapping[original_frame_idx]
        aortic = pulmonary = None
        if measurements is not None and original_frame_idx in measurements:
            aortic, pulmonary = measurements[original_frame_idx]
        lo, hi = bounds[k], bounds[k + 1]
        contours.append(
            PyContour.from_arrays(
                sequential_id,
                original_frame_idx,
                coords_all[lo:hi].copy(),
                (0.0, 0.0, 0.0),
                frames[lo:hi].copy(),
                point_idx_all[lo:hi].copy(),
                aortic_all[lo:hi].copy(),
                aortic,
                pulmonary,
                kind,
            )
        )
    return contours


class _BuildFallback(Exception):
    """Input shape the tensor funnel can't take (ragged per-kind counts,
    suspicious invariants) — rebuilt through the object funnel for exact
    error behaviour."""


def build_tensor_from_inputdata(
    input_data: InputData,
    label: str = "",
    diastole: bool = True,
    image_center=(4.5, 4.5),
    radius: float = 0.5,
    n_points: int = 20,
) -> "TensorGeometry":
    """Array-spine construction funnel: identical semantics to
    :func:`build_geometry_from_inputdata` (build.rs:9-205) on rectangular
    inputs, one vectorised pass per stage.  Raises :class:`_BuildFallback`
    when the input needs the object funnel."""
    from ..models.tensor import TensorGeometry

    groups = {
        "Lumen": input_data.lumen,
        "Eem": input_data.eem,
        "Calcification": input_data.calcification,
        "Sidebranch": input_data.sidebranch,
    }
    grouped_lumen = getattr(input_data, "lumen_grouped", None)
    arrs = {}
    for k, g in groups.items():
        if g is None or (k == "Lumen" and grouped_lumen is not None):
            continue
        a = points_to_array(g)
        if a.shape[0]:
            arrs[k] = a
    if "Lumen" not in arrs and grouped_lumen is None:
        raise _BuildFallback("no lumen points")

    all_orig = set()
    for a in arrs.values():
        all_orig.update(a[:, 0].astype(np.int64).tolist())
    if grouped_lumen is not None:
        all_orig.update(grouped_lumen["orig"].tolist())
    if input_data.ref_point is not None:
        all_orig.add(int(input_data.ref_point.frame_index))
    sorted_orig = sorted(all_orig)
    mapping = {orig: i for i, orig in enumerate(sorted_orig)}

    kind_data = {}
    if grouped_lumen is not None:
        kind_data["Lumen"] = dict(
            seq=np.array(
                [mapping[int(o)] for o in grouped_lumen["orig"]], dtype=np.int64
            ),
            orig=grouped_lumen["orig"],
            coords=grouped_lumen["coords"],
            pt_frame=grouped_lumen["pt_frame"],
            pt_index=grouped_lumen["pt_index"],
            pt_aortic=grouped_lumen["pt_aortic"],
        )
    for k, a in arrs.items():
        fcol = a[:, 0].astype(np.int64)
        if np.any(fcol[1:] < fcol[:-1]):  # skip the gather when pre-sorted
            order = np.argsort(fcol, kind="stable")
            a = a[order]
            fcol = fcol[order]
        uniq, starts = np.unique(fcol, return_index=True)
        counts = np.diff(np.append(starts, len(fcol)))
        if not (counts == counts[0]).all():
            raise _BuildFallback(f"ragged {k} point counts")
        P = int(counts[0])
        nk = len(uniq)
        kind_data[k] = dict(
            seq=np.array([mapping[int(o)] for o in uniq], dtype=np.int64),
            orig=uniq.astype(np.int64),
            coords=np.ascontiguousarray(a[:, 1:4]).reshape(nk, P, 3),
            pt_frame=fcol.reshape(nk, P),
            pt_index=a[:, 4].astype(np.int64).reshape(nk, P),
            pt_aortic=a[:, 5].astype(bool).reshape(nk, P),
        )

    lum = kind_data["Lumen"]

    F = len(lum["seq"])
    ids = lum["seq"].copy()
    orig_frame = lum["orig"].copy()
    pos_of_seq = {int(s): i for i, s in enumerate(ids)}

    kinds = ["Lumen"] + [
        k for k in ("Eem", "Calcification", "Sidebranch") if k in kind_data
    ]
    coords: Dict[str, np.ndarray] = {}
    present: Dict[str, np.ndarray] = {}
    pt_frame: Dict[str, np.ndarray] = {}
    pt_index: Dict[str, np.ndarray] = {}
    pt_aortic: Dict[str, np.ndarray] = {}
    con_centroid: Dict[str, np.ndarray] = {}
    aortic_th: Dict[str, np.ndarray] = {}
    pulm_th: Dict[str, np.ndarray] = {}

    for k in kinds:
        d = kind_data[k]
        P = d["coords"].shape[1]
        coords[k] = np.zeros((F, P, 3))
        present[k] = np.zeros(F, dtype=bool)
        pt_frame[k] = np.zeros((F, P), dtype=np.int64)
        pt_index[k] = np.zeros((F, P), dtype=np.int64)
        pt_aortic[k] = np.zeros((F, P), dtype=bool)
        con_centroid[k] = np.full((F, 3), np.nan)
        aortic_th[k] = np.full(F, np.nan)
        pulm_th[k] = np.full(F, np.nan)
        rows = [pos_of_seq.get(int(s), -1) for s in d["seq"]]
        if rows == list(range(F)):
            # every frame carries this kind, already in frame order: adopt
            # the grouped arrays directly (no copy)
            present[k][:] = True
            coords[k] = np.ascontiguousarray(d["coords"])
            pt_frame[k] = d["pt_frame"]
            pt_index[k] = d["pt_index"]
            # owned copy: the grouped fast path (csv_io lumen_grouped) hands
            # InputData-owned arrays through here, ccw_sort skips re-taking
            # an all-False flag array, and the finish's aortic assignment
            # then writes in place — an alias would corrupt the caller's
            # InputData for subsequent builds.  (coords/pt_index are always
            # replaced by ccw_sort/reorder before any in-place write;
            # pt_frame is never mutated.)
            pt_aortic[k] = d["pt_aortic"].copy()
        else:
            for j, i in enumerate(rows):
                if i < 0:
                    continue  # extra contour on a frame without lumen: dropped
                present[k][i] = True
                coords[k][i] = d["coords"][j]
                pt_frame[k][i] = d["pt_frame"][j]
                pt_index[k][i] = d["pt_index"][j]
                pt_aortic[k][i] = d["pt_aortic"][j]
        cc = coords[k][present[k]].mean(axis=1)
        con_centroid[k][present[k]] = cc

    if input_data.record:
        meas = {r.frame: (r.measurement_1, r.measurement_2) for r in input_data.record}
        for i in range(F):
            m = meas.get(int(orig_frame[i]))
            if m is not None:
                aortic_th["Lumen"][i] = np.nan if m[0] is None else float(m[0])
                pulm_th["Lumen"][i] = np.nan if m[1] is None else float(m[1])

    # catheter synthesis: ring at each frame's first lumen z
    # (Frame::create_catheter_points, frame.rs:163-204)
    if n_points > 0:
        import math as _math

        angles = 2.0 * _math.pi * np.arange(n_points) / n_points
        ring = np.empty((n_points, 2))
        ring[:, 0] = image_center[0] + radius * np.cos(angles)
        ring[:, 1] = image_center[1] + radius * np.sin(angles)
        cat = np.empty((F, n_points, 3))
        cat[:, :, :2] = ring[None]
        cat[:, :, 2] = coords["Lumen"][:, 0, 2][:, None]
        kinds.append("Catheter")
        coords["Catheter"] = cat
        present["Catheter"] = np.ones(F, dtype=bool)
        pt_frame["Catheter"] = np.broadcast_to(orig_frame[:, None], (F, n_points)).copy()
        pt_index["Catheter"] = np.zeros((F, n_points), dtype=np.int64)
        pt_aortic["Catheter"] = np.zeros((F, n_points), dtype=bool)
        con_centroid["Catheter"] = cat.mean(axis=1)
        aortic_th["Catheter"] = np.full(F, np.nan)
        pulm_th["Catheter"] = np.full(F, np.nan)

    centroids = con_centroid["Lumen"].copy()

    ref_pos = None
    ref_point = None
    if input_data.ref_point is not None:
        seq = mapping.get(int(input_data.ref_point.frame_index))
        pos = pos_of_seq.get(seq) if seq is not None else None
        if pos is not None:
            ref_pos = pos
            ref_point = input_data.ref_point.copy()

    tg = TensorGeometry(
        label=label,
        kinds=kinds,
        coords=coords,
        present=present,
        pt_frame=pt_frame,
        pt_index=pt_index,
        pt_aortic=pt_aortic,
        con_centroid=con_centroid,
        aortic_th=aortic_th,
        pulm_th=pulm_th,
        ids=ids,
        orig_frame=orig_frame,
        centroids=centroids,
        ref_pos=ref_pos,
        ref_point=ref_point,
    )

    if input_data.record is not None:
        _reorder_tensor_by_records(tg, input_data.record, diastole)

    tg.ccw_sort()
    _ensure_proximal_tensor(tg)
    check_tensor_integrity(tg)
    # freshly built by the funnel: the align pipelines may consume it in
    # place (one-shot); a user-held TensorGeometry re-aligned later is
    # copied first (align_within._finish-path ownership handshake)
    tg._funnel_fresh = True
    return tg


def _reorder_tensor_by_records(tg, records, diastole: bool) -> None:
    """Geometry::reorder_frames on the spine (geometry.rs:72-144): permute to
    the record sequence, renumber ids / per-point frame indices, restore each
    frame's original (first-point lumen) z."""
    phase = "D" if diastole else "S"
    filtered = [r.frame for r in records if r.phase == phase]
    F = tg.n_frames
    first_z = tg.coords["Lumen"][:, 0, 2].copy()

    pos_by_orig = {}
    for i in range(F):
        pos_by_orig.setdefault(int(tg.orig_frame[i]), i)
    perm = []
    taken = set()
    for orig in filtered:
        i = pos_by_orig.get(int(orig))
        if i is not None and i not in taken:
            perm.append(i)
            taken.add(i)
    rest = sorted(
        (i for i in range(F) if i not in taken),
        key=lambda i: int(tg.orig_frame[i]),
    )
    perm.extend(rest)
    perm = np.array(perm, dtype=np.int64)

    z_new = first_z[perm]  # each frame keeps its own original z
    for k in tg.kinds:
        tg.coords[k] = tg.coords[k][perm]
        tg.coords[k][:, :, 2] = z_new[:, None]
        tg.present[k] = tg.present[k][perm]
        tg.pt_frame[k] = np.broadcast_to(
            np.arange(F, dtype=np.int64)[:, None], tg.pt_frame[k].shape
        ).copy()
        tg.pt_index[k] = tg.pt_index[k][perm]
        tg.pt_aortic[k] = tg.pt_aortic[k][perm]
        tg.con_centroid[k] = tg.con_centroid[k][perm]
        tg.con_centroid[k][:, 2] = z_new
        tg.aortic_th[k] = tg.aortic_th[k][perm]
        tg.pulm_th[k] = tg.pulm_th[k][perm]
    tg.centroids = tg.centroids[perm]
    tg.centroids[:, 2] = z_new
    tg.orig_frame = tg.orig_frame[perm]
    tg.ids = np.arange(F, dtype=np.int64)
    if tg.ref_pos is not None:
        tg.ref_pos = int(np.nonzero(perm == tg.ref_pos)[0][0])
        if tg.ref_point is not None:
            tg.ref_point.z = float(z_new[tg.ref_pos])


def _ensure_proximal_tensor(tg) -> None:
    """Geometry::ensure_proximal_at_position_zero on the spine
    (geometry.rs:325-381): reverse so the proximal end sits first, assign
    sorted z by index, renumber ids."""
    F = tg.n_frames
    if F == 0:
        return
    if F == 1 or tg.orig_frame[0] > tg.orig_frame[-1]:
        proximal_idx = int(tg.ids[0])
    else:
        proximal_idx = int(tg.ids[-1])
    proximal_idx = min(proximal_idx, F - 1)
    if proximal_idx != 0:
        for k in tg.kinds:
            tg.coords[k] = tg.coords[k][::-1].copy()
            tg.present[k] = tg.present[k][::-1].copy()
            tg.pt_frame[k] = tg.pt_frame[k][::-1].copy()
            tg.pt_index[k] = tg.pt_index[k][::-1].copy()
            tg.pt_aortic[k] = tg.pt_aortic[k][::-1].copy()
            tg.con_centroid[k] = tg.con_centroid[k][::-1].copy()
            tg.aortic_th[k] = tg.aortic_th[k][::-1].copy()
            tg.pulm_th[k] = tg.pulm_th[k][::-1].copy()
        tg.centroids = tg.centroids[::-1].copy()
        tg.orig_frame = tg.orig_frame[::-1].copy()
        if tg.ref_pos is not None:
            tg.ref_pos = F - 1 - tg.ref_pos

    zs = np.sort(tg.centroids[:, 2])
    for k in tg.kinds:
        tg.coords[k][:, :, 2] = zs[:, None]
        tg.con_centroid[k][:, 2] = zs
    tg.centroids[:, 2] = zs
    tg.ids = np.arange(F, dtype=np.int64)
    if tg.ref_point is not None and tg.ref_pos is not None:
        tg.ref_point.z = float(zs[tg.ref_pos])


def check_tensor_integrity(tg) -> None:
    """Vectorised equivalents of the 8-check gate; anything suspicious
    raises _BuildFallback so the object funnel reproduces the exact
    reference error."""
    F = tg.n_frames
    if F == 0:
        raise _BuildFallback("no frames")
    if not np.array_equal(tg.ids, np.arange(F, dtype=np.int64)):
        raise _BuildFallback("non-consecutive ids")
    if not tg.present["Lumen"].all() or tg.coords["Lumen"].shape[1] == 0:
        raise _BuildFallback("missing lumen")
    n_ref = 1 if (tg.ref_pos is not None and tg.ref_point is not None) else 0
    if n_ref != 1:
        raise _BuildFallback(f"expected exactly one reference point, found {n_ref}")
    computed = tg.coords["Lumen"].mean(axis=1)
    if not np.allclose(computed, tg.centroids, atol=_EPSILON):
        raise _BuildFallback("centroid mismatch")
    if tg.ref_point is not None and tg.ref_pos is not None:
        if int(tg.ref_point.frame_index) != int(tg.orig_frame[tg.ref_pos]):
            raise _BuildFallback("reference point original frame mismatch")
    # proximal index vs min z
    if F == 1 or tg.orig_frame[0] > tg.orig_frame[-1]:
        proximal = 0
    else:
        proximal = F - 1
    zs = tg.centroids[:, 2]
    if proximal != int(np.argmin(zs)):
        raise _BuildFallback("proximal end not at min z")
    if zs[0] > zs[-1]:
        raise _BuildFallback("z distribution reversed")


def build_any_from_inputdata(
    input_data: Optional[InputData] = None,
    path=None,
    label: str = "",
    diastole: bool = True,
    image_center=(4.5, 4.5),
    radius: float = 0.5,
    n_points: int = 20,
    verbose: bool = True,
):
    """Build through the tensor funnel where possible, returning the
    TensorGeometry directly (the align pipelines consume it without a
    round-trip through the object model); falls back to
    :func:`build_geometry_from_inputdata` otherwise."""
    if input_data is None:
        if path is None:
            raise ValueError("Either input_data or path must be provided")
        input_data = process_directory(path, None, diastole, label)
    try:
        tg = build_tensor_from_inputdata(
            input_data, label, diastole, image_center, radius, n_points
        )
        if verbose:
            _print_success_message(input_data, path is not None)
        return tg
    except _BuildFallback:
        return build_geometry_from_inputdata(
            input_data, None, label, diastole, image_center, radius, n_points,
            verbose=verbose,
        )


def build_geometry_from_inputdata(
    input_data: Optional[InputData] = None,
    path=None,
    label: str = "",
    diastole: bool = True,
    image_center=(4.5, 4.5),
    radius: float = 0.5,
    n_points: int = 20,
    verbose: bool = True,
) -> PyGeometry:
    """Single construction funnel: shared frame-id mapping across contour
    types -> contour building -> catheter synthesis -> frame assembly ->
    record reordering -> CCW sort -> proximal-at-zero -> integrity gate.
    Parity: build.rs:9-205."""
    if input_data is None:
        if path is None:
            raise ValueError("Either input_data or path must be provided")
        input_data = process_directory(path, None, diastole, label)

    try:
        tg = build_tensor_from_inputdata(
            input_data, label, diastole, image_center, radius, n_points
        )
        geometry = tg.to_geometry()
        if verbose:
            _print_success_message(input_data, path is not None)
        return geometry
    except _BuildFallback:
        pass

    def frame_ids_of(group):
        if isinstance(group, np.ndarray):
            return set(group[:, 0].astype(int).tolist())
        return {p.frame_index for p in group}

    all_original_frames = frame_ids_of(input_data.lumen)
    for group in (input_data.eem, input_data.calcification, input_data.sidebranch):
        if group is not None:
            all_original_frames.update(frame_ids_of(group))
    if input_data.ref_point is not None:
        all_original_frames.add(input_data.ref_point.frame_index)

    sorted_original = sorted(all_original_frames)
    frame_mapping = {orig: i for i, orig in enumerate(sorted_original)}

    lumen_contours = build_contours_with_mapping(
        input_data.lumen, input_data.record, "Lumen", frame_mapping
    )
    extra_groups = {
        "Eem": input_data.eem,
        "Calcification": input_data.calcification,
        "Sidebranch": input_data.sidebranch,
    }

    frame_map: Dict[int, PyFrame] = {}
    for contour in lumen_contours:
        contour.compute_centroid()
        frame = PyFrame(contour.id, contour.centroid, contour, {}, None)
        if (
            input_data.ref_point is not None
            and frame_mapping.get(input_data.ref_point.frame_index) == contour.id
        ):
            frame.reference_point = input_data.ref_point.copy()
        frame_map[contour.id] = frame

    for kind, group in extra_groups.items():
        if group is None:
            continue
        for contour in build_contours_with_mapping(group, None, kind, frame_mapping):
            contour.compute_centroid()
            if contour.id in frame_map:
                frame_map[contour.id].extras[kind] = contour

    if n_points > 0:
        # catheter synthesis: one ring per frame at the frame's (constant) z.
        # Parity: Frame::create_catheter_points uses the first-encountered z
        # per original frame (frame.rs:163-204).
        import math as _math

        angles = 2.0 * _math.pi * np.arange(n_points) / n_points
        ring_x = image_center[0] + radius * np.cos(angles)
        ring_y = image_center[1] + radius * np.sin(angles)
        catheter_rows = []
        for frame in frame_map.values():
            if frame.lumen.n_points == 0:
                continue
            orig = frame.lumen.original_frame
            z = float(frame.lumen.xyz_view()[0, 2])
            block = np.empty((n_points, 4))
            block[:, 0] = orig
            block[:, 1] = ring_x
            block[:, 2] = ring_y
            block[:, 3] = z
            catheter_rows.append(block)
        if catheter_rows:
            for contour in build_contours_with_mapping(
                np.concatenate(catheter_rows), None, "Catheter", frame_mapping
            ):
                contour.compute_centroid()
                if contour.id in frame_map:
                    frame_map[contour.id].extras["Catheter"] = contour

    frames = sorted(frame_map.values(), key=lambda f: f.id)
    geometry = PyGeometry(frames, label)

    if input_data.record is not None:
        geometry.reorder_frames(input_data.record, diastole)

    from ..models.batched import ccw_sort_frames

    ccw_sort_frames(geometry.frames)

    geometry.ensure_proximal_at_position_zero()

    for frame in geometry.frames:
        frame.set_value(frame.id, None, None, None)

    check_geometry_integrity(geometry)

    if verbose:
        _print_success_message(input_data, path is not None)
    return geometry


def _print_success_message(input_data: InputData, from_path: bool) -> None:
    print(f"\n✅ Successfully built geometry from {'path' if from_path else 'input data'}")
    check = lambda present: "✅" if present else "❌"  # noqa: E731
    print("-----------------------------------------")
    print(f"{check(len(input_data.lumen) > 0)} Lumen")
    print(f"{check(input_data.eem is not None)} Eem")
    print(f"{check(input_data.calcification is not None)} Calcification")
    print(f"{check(input_data.sidebranch is not None)} Sidebranch")
    print("✅ Catheter")
    print("-----------------------------------------")
    print(f"Label: {input_data.label}")
    print(f"Diastole phase: {'Yes' if input_data.diastole else 'No'}")
    print()


# ---------------------------------------------------------------------------
# integrity checks
# ---------------------------------------------------------------------------

_EPSILON = 1e-6


def _approx_equal(a, b) -> bool:
    return all(abs(a[i] - b[i]) < _EPSILON for i in range(3))


def check_geometry_integrity(geometry: PyGeometry) -> None:
    """8 invariant checks; raises ValueError on the first failure.
    Parity: integrity_check.rs:8-234."""
    if not geometry.frames:
        raise ValueError("Geometry has no frames")
    for name, fn in (
        ("check_frame_ids_consecutive", _check_frame_ids_consecutive),
        ("check_centroids_match", _check_centroids_match),
        ("check_lumen_presence", _check_lumen_presence),
        ("check_reference_point", _check_reference_point),
        ("check_contour_point_counts", _check_contour_point_counts),
        ("check_original_frame_consistency", _check_original_frame_consistency),
        ("check_proximal_end_index", _check_proximal_end_index),
        ("check_z_distribution", _check_z_distribution),
    ):
        try:
            fn(geometry)
        except ValueError as e:
            print(f"Integrity check '{name}' failed: {e}")
            raise


def _check_frame_ids_consecutive(geometry: PyGeometry) -> None:
    for index, frame in enumerate(geometry.frames):
        if frame.id != index:
            raise ValueError(
                f"Frame IDs are not consecutive. Expected ID {index}, found ID {frame.id}"
            )


def _check_centroids_match(geometry: PyGeometry) -> None:
    for frame_index, frame in enumerate(geometry.frames):
        pts = frame.lumen.xyz_view()
        computed = tuple(pts.mean(axis=0)) if len(pts) else (0.0, 0.0, 0.0)
        lumen_centroid = frame.lumen.centroid if frame.lumen.centroid is not None else computed
        if not _approx_equal(frame.centroid, lumen_centroid):
            raise ValueError(
                f"Frame centroid does not match lumen centroid in frame {frame_index} "
                f"(ID {frame.id}). Frame: {frame.centroid}, Lumen: {lumen_centroid}"
            )
        if frame.lumen.centroid is not None and not _approx_equal(
            frame.lumen.centroid, computed
        ):
            raise ValueError(
                f"Stored lumen centroid does not match computed centroid in frame "
                f"{frame_index} (ID {frame.id})"
            )


def _check_lumen_presence(geometry: PyGeometry) -> None:
    for frame_index, frame in enumerate(geometry.frames):
        if frame.lumen.n_points == 0:
            raise ValueError(
                f"Lumen contour has no points in frame {frame_index} (ID {frame.id})"
            )
        if frame.lumen.kind != "Lumen":
            raise ValueError(
                f"Lumen contour has incorrect type in frame {frame_index} "
                f"(ID {frame.id}). Expected Lumen, found {frame.lumen.kind}"
            )


def _check_reference_point(geometry: PyGeometry) -> None:
    n = sum(1 for f in geometry.frames if f.reference_point is not None)
    if n != 1:
        raise ValueError(f"Expected exactly one reference point, found {n}")


def _check_contour_point_counts(geometry: PyGeometry) -> None:
    expected: Dict[str, int] = {}
    for frame_index, frame in enumerate(geometry.frames):
        for kind, contour in [("Lumen", frame.lumen)] + list(frame.extras.items()):
            count = contour.n_points
            if kind in expected:
                if count != expected[kind]:
                    raise ValueError(
                        f"{kind} contour point count mismatch in frame {frame_index} "
                        f"(ID {frame.id}). Expected {expected[kind]}, found {count}"
                    )
            else:
                expected[kind] = count


def _check_original_frame_consistency(geometry: PyGeometry) -> None:
    for frame_index, frame in enumerate(geometry.frames):
        expected = frame.lumen.original_frame
        for kind, contour in frame.extras.items():
            if contour.original_frame != expected:
                raise ValueError(
                    f"Original frame mismatch in frame {frame_index} (ID {frame.id}). "
                    f"Lumen has original_frame {expected}, {kind} has "
                    f"original_frame {contour.original_frame}"
                )
        if (
            frame.reference_point is not None
            and frame.reference_point.frame_index != expected
        ):
            raise ValueError(
                f"Reference point original frame mismatch in frame {frame_index} "
                f"(ID {frame.id})"
            )


def _check_proximal_end_index(geometry: PyGeometry) -> None:
    proximal_idx = geometry.find_proximal_end_idx()
    zs = np.array([f.centroid[2] for f in geometry.frames])
    min_idx = int(np.argmin(zs))
    if proximal_idx != min_idx:
        raise ValueError(
            f"Proximal end index is {proximal_idx}, but frame with minimum z is "
            f"{min_idx} (z={zs[min_idx]})."
        )


def _check_z_distribution(geometry: PyGeometry) -> None:
    z0 = geometry.frames[0].centroid[2]
    zn = geometry.frames[-1].centroid[2]
    if z0 > zn:
        raise ValueError(f"First frame has higher z-coords {z0} than last frame {zn}")
