"""Numpy bridge: convert between Py* objects and plain arrays.

Parity: ``multimodars/_converters.py`` of the reference.  Row convention for
contour layers is ``[frame_index, x, y, z]``; centerlines are ``(N, 3)``.
The JAX package's converters take the same arrays, so both packages are fed
identical inputs.  ``geometry_to_trimesh`` returns the port's own
:class:`multimodars_torch.ccta.mesh.Mesh`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .models.centerline import PyCenterline
from .models.contour import PyContour
from .models.frame import PyFrame
from .models.geometry import PyGeometry, PyGeometryPair
from .models.point import PyContourPoint, PyContourType
from .models.record import PyInputData, PyRecord


def to_array(generic):
    """Convert Py* objects into numpy arrays / dicts of arrays.

    - PyContour / PyCenterline -> (N, 4) array of (frame_index, x, y, z)
    - PyFrame / PyGeometry -> dict of per-layer (M, 4) arrays + "reference"
    - PyGeometryPair -> (dict_a, dict_b)
    - PyInputData -> dict of layer arrays + metadata
    """
    if isinstance(generic, PyContour):
        return np.array(
            [(p.frame_index, p.x, p.y, p.z) for p in generic.points], dtype=float
        )
    if isinstance(generic, PyCenterline):
        return np.array(
            [
                (p.contour_point.frame_index, p.contour_point.x, p.contour_point.y, p.contour_point.z)
                for p in generic.points
            ],
            dtype=float,
        )
    if isinstance(generic, PyFrame):
        return _frame_to_numpy(generic)
    if isinstance(generic, PyGeometry):
        return _geometry_to_numpy(generic)
    if isinstance(generic, PyGeometryPair):
        return _geometry_to_numpy(generic.geom_a), _geometry_to_numpy(generic.geom_b)
    if isinstance(generic, PyInputData):
        return _input_data_to_numpy(generic)
    raise TypeError(f"Unsupported type for to_array: {type(generic)}")


def _frame_to_numpy(frame: PyFrame) -> Dict[str, np.ndarray]:
    result = {}
    lumen_pts = [(p.frame_index, p.x, p.y, p.z) for p in frame.lumen.points]
    result["lumen"] = (
        np.array(lumen_pts, dtype=float) if lumen_pts else np.zeros((0, 4), dtype=float)
    )
    for contour_type, contour in frame.extras.items():
        pts = [(p.frame_index, p.x, p.y, p.z) for p in contour.points]
        result[contour_type.lower()] = (
            np.array(pts, dtype=float) if pts else np.zeros((0, 4), dtype=float)
        )
    if frame.reference_point:
        ref = frame.reference_point
        result["reference"] = np.array([[ref.frame_index, ref.x, ref.y, ref.z]], dtype=float)
    else:
        result["reference"] = np.zeros((0, 4), dtype=float)
    return result


def _geometry_to_numpy(geom: PyGeometry) -> Dict[str, np.ndarray]:
    result = {
        key: np.zeros((0, 4), dtype=float)
        for key in ("lumen", "eem", "calcification", "sidebranch", "catheter", "wall", "reference")
    }
    for frame in geom.frames:
        frame_data = _frame_to_numpy(frame)
        for key in result:
            if key in frame_data and len(frame_data[key]) > 0:
                if len(result[key]) == 0:
                    result[key] = frame_data[key]
                else:
                    result[key] = np.vstack([result[key], frame_data[key]])
    return result


def _input_data_to_numpy(input_data: PyInputData):
    result = {
        "lumen": np.zeros((0, 4), dtype=float),
        "eem": np.zeros((0, 4), dtype=float),
        "calcification": np.zeros((0, 4), dtype=float),
        "sidebranch": np.zeros((0, 4), dtype=float),
        "reference": np.zeros((0, 4), dtype=float),
        "diastole": input_data.diastole,
        "label": input_data.label,
    }
    if input_data.lumen:
        pts = []
        for contour in input_data.lumen:
            pts.extend((p.frame_index, p.x, p.y, p.z) for p in contour.points)
        if pts:
            result["lumen"] = np.array(pts, dtype=float)
    for name in ("eem", "calcification", "sidebranch"):
        contours = getattr(input_data, name)
        if contours:
            pts = []
            for contour in contours:
                pts.extend((p.frame_index, p.x, p.y, p.z) for p in contour.points)
            if pts:
                result[name] = np.array(pts, dtype=float)
    if input_data.ref_point is not None:
        ref = input_data.ref_point
        result["reference"] = np.array([[ref.frame_index, ref.x, ref.y, ref.z]], dtype=float)
    if input_data.record:
        rows = []
        for r in input_data.record:
            rows.append(
                [
                    r.frame,
                    r.phase,
                    r.measurement_1 if r.measurement_1 is not None else np.nan,
                    r.measurement_2 if r.measurement_2 is not None else np.nan,
                ]
            )
        result["records"] = np.array(rows, dtype=object)
    return result


# ---------------------------------------------------------------------------
# numpy -> objects
# ---------------------------------------------------------------------------


def _to_numeric_array(arr, name: str) -> np.ndarray:
    if arr is None:
        return np.zeros((0, 4), dtype=float)
    arr = np.asarray(arr)
    if arr.ndim == 1 and arr.dtype.names:
        try:
            arr = np.vstack([arr[n] for n in arr.dtype.names]).T
        except Exception:
            raise ValueError(f"Could not convert structured array for {name}")
    arr = np.asarray(arr, dtype=float)
    if arr.ndim == 1 and arr.size > 0:
        arr = arr.reshape(1, -1)
    return arr


def _group_contours_by_frame(arr: np.ndarray, contour_type: str):
    """{frame_id: PyContour} grouped in one argsort pass (within-frame
    order preserved)."""
    out = {}
    if arr.size == 0:
        return out
    frames = arr[:, 0].astype(np.int64)
    order = np.argsort(frames, kind="stable")
    sorted_arr = arr[order]
    sorted_frames = frames[order]
    uniq, starts = np.unique(sorted_frames, return_index=True)
    bounds = np.append(starts, len(sorted_frames))
    for k, frame_id in enumerate(uniq.tolist()):
        block = sorted_arr[bounds[k]:bounds[k + 1]]
        coords = block[:, 1:4].copy()
        out[int(frame_id)] = PyContour.from_arrays(
            int(frame_id),
            int(frame_id),
            coords,
            tuple(coords.mean(axis=0)),
            block[:, 0].astype(np.int64),
            None,
            None,
            None,
            None,
            contour_type,
        )
    return out


def _build_contour_from_array(arr: np.ndarray, frame_id: int, contour_type: str):
    if arr.size == 0:
        return None
    mask = arr[:, 0].astype(int) == int(frame_id)
    pts_arr = arr[mask]
    if pts_arr.shape[0] == 0:
        return None
    coords = pts_arr[:, 1:4].copy()
    centroid = tuple(coords.mean(axis=0))
    return PyContour.from_arrays(
        int(frame_id),
        int(frame_id),
        coords,
        centroid,
        pts_arr[:, 0].astype(np.int64),
        None,
        None,
        None,
        None,
        contour_type,
    )


def _records_from_array(arr):
    if arr is None:
        return None
    if isinstance(arr, np.ndarray) and arr.ndim == 1 and arr.dtype.names:
        try:
            arr = np.vstack([arr[n] for n in arr.dtype.names]).T
        except Exception:
            arr = np.asarray(arr)
    arr = np.asarray(arr)
    if arr.size == 0:
        return None
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)

    def _opt_float(v):
        try:
            fv = float(v)
            return None if np.isnan(fv) else fv
        except Exception:
            return None

    recs = []
    for row in arr:
        frame = int(row[0])
        phase_val = row[1] if len(row) > 1 else ""
        if isinstance(phase_val, (bytes, bytearray)):
            phase = phase_val.decode("utf-8", errors="replace")
        elif isinstance(phase_val, (int, float, np.number)):
            phase = "D" if int(phase_val) == 0 else "S"
        else:
            phase = str(phase_val)
        m1 = _opt_float(row[2]) if len(row) > 2 else None
        m2 = _opt_float(row[3]) if len(row) > 3 else None
        recs.append(PyRecord(frame, phase, m1, m2))
    return recs or None


def numpy_to_inputdata(
    lumen_arr: np.ndarray,
    ref_point: np.ndarray,
    diastole: bool,
    record=None,
    eem_arr=None,
    calcification=None,
    sidebranch=None,
    label: str = "",
) -> PyInputData:
    """Build a PyInputData from (N, 4) [frame, x, y, z] arrays grouped by
    frame index.  Parity: _converters.py:204-437."""
    lumen_arr = _to_numeric_array(lumen_arr, "lumen_arr")
    eem_arr = _to_numeric_array(eem_arr, "eem_arr")
    calc_arr = _to_numeric_array(calcification, "calcification")
    side_arr = _to_numeric_array(sidebranch, "sidebranch")

    global_ref = None
    if ref_point is not None:
        try:
            ref_arr = np.asarray(ref_point, dtype=float)
            row = ref_arr[:4] if ref_arr.ndim == 1 else ref_arr[0, :4]
            global_ref = PyContourPoint(
                int(row[0]), 0, float(row[1]), float(row[2]), float(row[3]), False
            )
        except Exception:
            global_ref = None
    if global_ref is None:
        global_ref = PyContourPoint(0, 0, 0.0, 0.0, 0.0, False)

    if lumen_arr.size == 0:
        raise ValueError("lumen_arr cannot be empty")

    lumen_groups = _group_contours_by_frame(lumen_arr, "Lumen")
    eem_groups = _group_contours_by_frame(eem_arr, "Eem")
    calc_groups = _group_contours_by_frame(calc_arr, "Calcification")
    side_groups = _group_contours_by_frame(side_arr, "Sidebranch")

    lumen_list, eem_list, calc_list, side_list = [], [], [], []
    for frame_id in sorted(lumen_groups):
        lumen_list.append(lumen_groups[frame_id])
        for groups, out in (
            (eem_groups, eem_list),
            (calc_groups, calc_list),
            (side_groups, side_list),
        ):
            if frame_id in groups:
                out.append(groups[frame_id])

    return PyInputData(
        lumen=lumen_list,
        eem=eem_list or None,
        calcification=calc_list or None,
        sidebranch=side_list or None,
        record=_records_from_array(record),
        ref_point=global_ref,
        diastole=bool(diastole),
        label=label or "",
    )


def numpy_to_geometry(
    lumen_arr: np.ndarray,
    eem_arr=None,
    catheter_arr=None,
    wall_arr=None,
    reference_arr=None,
    label: str = "",
) -> PyGeometry:
    """Build a PyGeometry from (N, 4) [frame, x, y, z] arrays grouped by
    frame index.  Parity: _converters.py:440-602."""
    lumen_arr = _to_numeric_array(lumen_arr, "lumen_arr")
    eem_arr = _to_numeric_array(eem_arr, "eem_arr")
    catheter_arr = _to_numeric_array(catheter_arr, "catheter_arr")
    wall_arr = _to_numeric_array(wall_arr, "wall_arr")
    reference_arr = _to_numeric_array(reference_arr, "reference_arr")

    if lumen_arr.size == 0:
        raise ValueError("lumen_arr cannot be empty")

    global_reference = None
    if reference_arr.size > 0:
        row = reference_arr[:4] if reference_arr.ndim == 1 else reference_arr[0, :4]
        global_reference = PyContourPoint(
            int(row[0]), 0, float(row[1]), float(row[2]), float(row[3]), False
        )

    all_frames = set()
    for arr in (lumen_arr, eem_arr, catheter_arr, wall_arr):
        if arr.size > 0:
            all_frames.update(arr[:, 0].astype(int))

    lumen_groups = _group_contours_by_frame(lumen_arr, "Lumen")
    eem_groups = _group_contours_by_frame(eem_arr, "Eem")
    catheter_groups = _group_contours_by_frame(catheter_arr, "Catheter")
    wall_groups = _group_contours_by_frame(wall_arr, "Wall")

    frames = []
    for frame_id in sorted(all_frames):
        lumen_contour = lumen_groups.get(int(frame_id))
        if lumen_contour is None:
            continue
        extras = {}
        for groups, kind in (
            (eem_groups, "Eem"),
            (catheter_groups, "Catheter"),
            (wall_groups, "Wall"),
        ):
            if int(frame_id) in groups:
                extras[kind] = groups[int(frame_id)]
        frames.append(
            PyFrame(frame_id, lumen_contour.centroid, lumen_contour, extras, global_reference)
        )
    return PyGeometry(frames, label)


def numpy_to_centerline(arr: np.ndarray, aortic: bool = False) -> PyCenterline:
    """Build a PyCenterline from an (N, 3) array; NaNs are linearly
    interpolated per coordinate.  Parity: _converters.py:605-686."""
    arr = np.asarray(arr, dtype=float)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError("Input must be a (N,3) array")
    n = arr.shape[0]
    if n == 0:
        raise ValueError("Input array must contain at least one point")

    if np.isnan(arr).any():
        idx = np.arange(n)
        arr_interp = arr.copy()
        for col in range(3):
            col_vals = arr[:, col]
            valid = ~np.isnan(col_vals)
            if valid.sum() == 0:
                raise ValueError(
                    f"All values are NaN for coordinate column {col}; cannot build centerline."
                )
            if valid.sum() < n:
                arr_interp[:, col] = np.interp(idx, idx[valid], col_vals[valid])
        arr = arr_interp

    if arr.shape[0] < 2:
        raise ValueError(
            "Centerline must contain at least two points after cleaning/interpolation."
        )

    pts = [
        PyContourPoint(i, i, float(x), float(y), float(z), aortic)
        for i, (x, y, z) in enumerate(arr.tolist())
    ]
    for p in pts:
        if any(np.isnan((p.x, p.y, p.z))):
            raise ValueError("NaN coordinate found after interpolation — aborting.")
    return PyCenterline.from_contour_points(pts)


def array_to_pyinputdata(
    lumen=None,
    eem=None,
    calcification=None,
    sidebranch=None,
    records=None,
    reference=None,
    diastole: bool = True,
    label: str = "",
) -> PyInputData:
    """Flexible PyInputData constructor accepting Py* objects or arrays.
    Parity: _converters.py:689-964."""

    def ensure_contours(maybe, kind: str):
        if maybe is None:
            return []
        if isinstance(maybe, list) and maybe and hasattr(maybe[0], "points"):
            return maybe
        arr = _to_numeric_array(np.asarray(maybe), kind)
        if arr.size == 0:
            return []
        if arr.ndim != 2 or arr.shape[1] < 4:
            raise ValueError(f"{kind} must be (N,4)-like, got shape {arr.shape}")
        out = []
        for frame in np.unique(arr[:, 0].astype(int)):
            contour = _build_contour_from_array(arr, int(frame), kind)
            if contour is not None:
                out.append(contour)
        return out

    lumen_contours = ensure_contours(lumen, "Lumen")
    eem_contours = ensure_contours(eem, "Eem")
    calc_contours = ensure_contours(calcification, "Calcification")
    side_contours = ensure_contours(sidebranch, "Sidebranch")

    if records is not None and isinstance(records, (list, tuple)) and records and hasattr(records[0], "frame"):
        parsed_records: Optional[List[PyRecord]] = list(records)
    else:
        parsed_records = _records_from_array(records)

    if reference is None:
        ref_point = PyContourPoint(0, 0, 0.0, 0.0, 0.0, False)
    else:
        arr = np.asarray(reference, dtype=float)
        if arr.ndim == 1:
            if arr.shape[0] < 4:
                raise ValueError("reference must be length 4 or shape (1,4)")
            row = arr[:4]
        else:
            if arr.shape[1] < 4:
                raise ValueError("reference must be (N,4)-like")
            nonzero = np.any(arr != 0, axis=1)
            row = arr[nonzero][0] if np.any(nonzero) else arr[0]
        ref_point = PyContourPoint(int(row[0]), 0, float(row[1]), float(row[2]), float(row[3]), False)

    return PyInputData(
        lumen=lumen_contours,
        eem=eem_contours or None,
        calcification=calc_contours or None,
        sidebranch=side_contours or None,
        record=parsed_records,
        ref_point=ref_point,
        diastole=bool(diastole),
        label=str(label),
    )


def geometry_to_frames_array(geometry: PyGeometry) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-frame dict of layer arrays.  Parity: _converters.py:967-1015."""
    return {str(frame.id): _frame_to_numpy(frame) for frame in geometry.frames}


def geometry_to_trimesh(geometry: PyGeometry, contour_type=None):
    """Closed tube mesh over one contour type's stacked rings (two triangles
    per quad, outward-oriented).  Parity: _converters.py:1018-1088 but
    returning the package-native Mesh."""
    from .ccta.mesh import Mesh

    if contour_type is None:
        contour_type = PyContourType.Lumen
    name = contour_type.name if isinstance(contour_type, PyContourType) else str(contour_type)
    if name == "Lumen":
        contours = geometry.get_lumen_contours()
    else:
        contours = geometry.get_contours_by_type(name)
    if len(contours) < 2:
        raise ValueError("Need at least two contours to build a mesh.")

    n = len(contours[0].points)
    vertices = np.concatenate(
        [np.asarray(c.xyz_view(), dtype=np.float64) for c in contours], axis=0
    )
    # quad strip between consecutive rings, same (i, j, [abd, bcd]) order as
    # the scalar loop
    i_ = np.arange(len(contours) - 1, dtype=np.int64)[:, None]
    j_ = np.arange(n, dtype=np.int64)[None, :]
    j1 = (j_ + 1) % n
    a = i_ * n + j_
    b = i_ * n + j1
    c = (i_ + 1) * n + j1
    d = (i_ + 1) * n + j_
    faces = np.stack(
        [np.stack([a, b, d], axis=-1), np.stack([b, c, d], axis=-1)], axis=2
    ).reshape(-1, 3)
    mesh = Mesh(vertices, faces)

    first_centroid = np.asarray(contours[0].centroid, dtype=np.float64)
    first_face_center = mesh.triangles_center[0]
    first_normal = mesh.face_normals[0]
    if np.dot(first_normal, first_face_center - first_centroid) < 0:
        mesh.faces = mesh.faces[:, ::-1]
        mesh._invalidate()
    # the uniform quad-strip pattern is consistently wound by construction
    # (every shared edge is traversed once in each direction: b-d within a
    # quad, ring-neighbour and row-neighbour edges across quads), and the
    # whole-mesh flip above preserves that — certify it so the stitch's
    # fix_normals skips the full winding BFS on the tube
    mesh._oriented = True
    return mesh
