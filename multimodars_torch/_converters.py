"""Numpy bridge: build the input bundle of the alignment pipelines from
plain arrays.

Parity: ``multimodars/_converters.py`` of the reference.  Row convention for
contour layers is ``[frame_index, x, y, z]``.  The JAX package's converter
takes the same arrays, so both packages are fed identical inputs.
"""

from __future__ import annotations

import numpy as np

from .models.contour import PyContour
from .models.point import PyContourPoint
from .models.record import PyInputData, PyRecord


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
