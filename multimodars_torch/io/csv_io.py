"""CSV contour/record readers and the ASCII VTP centerline parser.

Parity: ``src/intravascular/io/input.rs`` of the reference.

- contour CSVs are headerless rows ``frame, x, y, z`` with sniffed tab/comma
  delimiters; malformed rows are skipped with a warning
- record CSVs have headers and are matched by column name
- VTP parsing accepts ASCII-format PolyData only and orders branches by
  descending arc length (longest = branch 0)
"""

from __future__ import annotations

import csv
import math
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.centerline import (
    PyCenterline,
    PyCenterlinePoint,
    clpoints_from_lists,
)
from ..models.point import PyContourPoint
from ..models.record import PyInputData, PyRecord

RECORD_FILE_NAME = "combined_sorted_manual.csv"  # legacy AIVUS
RECORD_FILE_NAME_ALT = "diastolic_systolic_records.csv"  # holOrama


def _resolve_record_path(directory: Path) -> Path:
    primary = directory / RECORD_FILE_NAME
    return primary if primary.exists() else directory / RECORD_FILE_NAME_ALT


def _detect_delimiter(path) -> str:
    with open(path, "r", errors="replace") as fh:
        first_line = fh.readline()
    return "\t" if first_line.count("\t") > first_line.count(",") else ","


# -- contour read-ahead -------------------------------------------------------
# the native CSV parser releases the GIL (ctypes call into libmmio), so
# directories 2..n of a multi-geometry entry point can parse in background
# threads while the funnel builds geometry 1 (entry.prepare_n_geometries).
# Entries are keyed by (path, mtime_ns, size) and consumed exactly once
# (popped), so a file change between prefetch and read can only miss, never
# serve stale rows.
_READAHEAD: Dict[tuple, object] = {}
_READAHEAD_LOCK = None
_READAHEAD_POOL = None


def _readahead_state():
    global _READAHEAD_LOCK, _READAHEAD_POOL
    if _READAHEAD_LOCK is None:
        import threading

        _READAHEAD_LOCK = threading.Lock()
    if _READAHEAD_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _READAHEAD_POOL = ThreadPoolExecutor(max_workers=4)
    return _READAHEAD_LOCK, _READAHEAD_POOL


def _readahead_key(path):
    st = os.stat(path)
    return (str(path), st.st_mtime_ns, st.st_size)


def _read_contour_array_direct(path):
    from .native import read_contour_csv_native

    arr = read_contour_csv_native(path)
    if arr is not None:
        return arr
    pts = read_contour_data(path)
    out = np.empty((len(pts), 5))
    for i, p in enumerate(pts):
        out[i] = (p.frame_index, p.x, p.y, p.z, p.aortic)
    return out


def prefetch_contour_files(paths) -> None:
    """Queue background parses for the given contour CSVs (missing paths are
    skipped).  Each parse is consumed by the next matching
    :func:`read_contour_array` call."""
    lock, pool = _readahead_state()
    for p in paths:
        try:
            key = _readahead_key(p)
        except OSError:
            continue
        with lock:
            if key in _READAHEAD:
                continue
            # bound abandoned entries (a build that errors never consumes
            # its prefetch): drop oldest beyond a small working set
            while len(_READAHEAD) >= 64:
                _READAHEAD.pop(next(iter(_READAHEAD)))
            _READAHEAD[key] = pool.submit(_read_contour_array_direct, p)


def read_contour_array(path):
    """(N, 5) [frame, x, y, z, aortic] array via the native CSV parser,
    falling back to the Python reader.  Consumes a read-ahead parse when one
    is in flight for this exact file state."""
    if _READAHEAD and _READAHEAD_LOCK is not None:
        try:
            key = _readahead_key(path)
        except OSError:
            key = None
        if key is not None:
            with _READAHEAD_LOCK:
                fut = _READAHEAD.pop(key, None)
            if fut is not None:
                return fut.result()
    return _read_contour_array_direct(path)


def read_contour_data(path) -> List[PyContourPoint]:
    """Headerless ``frame, x, y, z`` rows; skips malformed rows.
    Parity: input.rs:172-194."""
    delim = _detect_delimiter(path)
    points: List[PyContourPoint] = []
    with open(path, "r", newline="") as fh:
        for row in csv.reader(fh, delimiter=delim):
            if not row:
                continue
            try:
                tok = row[0].strip()
                digits = tok[1:] if tok.startswith("+") else tok
                # u32 semantics like the reference's serde deserialize (and
                # the native parser): plain ASCII digits only — no sign, no
                # underscores, no floats/exponents, <= 2^32-1
                if not (digits.isascii() and digits.isdigit()):
                    raise ValueError(f"invalid frame id {row[0]!r}")
                frame = int(digits)
                if frame > 0xFFFFFFFF:
                    raise ValueError(f"frame id out of range: {frame}")
                x, y, z = float(row[1]), float(row[2]), float(row[3])
                aortic = False
                if len(row) > 4 and row[4].strip():
                    aortic = row[4].strip().lower() in ("true", "1")
                points.append(PyContourPoint(frame, 0, x, y, z, aortic))
            except (ValueError, IndexError) as e:
                print(f"Skipping invalid record: {e!r}", file=sys.stderr)
    return points


def read_reference_point(path) -> PyContourPoint:
    """First row of a reference-point CSV.  Parity: input.rs:213-233."""
    delim = _detect_delimiter(path)
    with open(path, "r", newline="") as fh:
        for row in csv.reader(fh, delimiter=delim):
            if not row:
                continue
            return PyContourPoint(int(row[0]), 0, float(row[1]), float(row[2]), float(row[3]), False)
    raise ValueError(f"reference-point file {path!r} was empty — this data is required")


def _parse_opt_float(value: str) -> Optional[float]:
    value = value.strip()
    if not value:
        return None
    try:
        return float(value)
    except ValueError:
        return None


def read_records(path) -> List[PyRecord]:
    """Header CSV matched by column name (frame/phase/measurement_1/_2).
    Parity: input.rs:235-249."""
    delim = _detect_delimiter(path)
    records: List[PyRecord] = []
    with open(path, "r", newline="") as fh:
        for row in csv.DictReader(fh, delimiter=delim):
            records.append(
                PyRecord(
                    int(row["frame"]),
                    row["phase"].strip(),
                    _parse_opt_float(row.get("measurement_1", "") or ""),
                    _parse_opt_float(row.get("measurement_2", "") or ""),
                )
            )
    return records


def _read_optional_contour_file(directory: Path, prefix: str, phase: str, label: str):
    p = directory / f"{prefix}_{phase}_contours.csv"
    if not p.exists():
        print(f"{label} file not found, skipping: {p}", file=sys.stderr)
        return None
    return read_contour_array(p)


def _read_optional_records(path: Path):
    if not path.exists():
        return None
    return read_records(path)


def process_directory(
    path,
    names: Optional[Dict[str, str]] = None,
    diastole: bool = True,
    label: str = "",
) -> PyInputData:
    """Load an AIVUS-CAA measurement directory into a raw input bundle.
    Parity: ``InputData::process_directory`` (input.rs:62-146).

    ``names`` maps contour-type names to file prefixes; the default mirrors
    build.rs:22-28 (lumen/eem/calcium/branch)."""
    path = Path(path)
    phase = "diastolic" if diastole else "systolic"
    if names is None:
        names = {
            "Lumen": "lumen",
            "Eem": "eem",
            "Calcification": "calcium",
            "Sidebranch": "branch",
            "Catheter": "catheter",
        }

    contours_path = path / f"{phase}_contours.csv"
    if not contours_path.exists():
        raise FileNotFoundError(f"required contours file missing: {contours_path}")
    lumen_points = read_contour_array(contours_path)

    ref_path = path / f"{phase}_reference_points.csv"
    if not ref_path.exists():
        raise FileNotFoundError(f"required reference-point file missing: {ref_path}")
    ref_point = read_reference_point(ref_path)

    eem = calcification = sidebranch = record = None
    for raw_name in names.values():
        name = raw_name.strip().lower()
        if name in ("", "lumen"):
            continue
        elif name in ("branch", "sidebranch"):
            sidebranch = _read_optional_contour_file(path, "branch", phase, "sidebranch")
        elif name in ("calcium", "calcification"):
            calcification = _read_optional_contour_file(path, "calcium", phase, "calcification")
        elif name in ("eem", "e_e_m"):
            eem = _read_optional_contour_file(path, "eem", phase, "eem")
        elif name in ("records", "record", "phases"):
            record = _read_optional_records(_resolve_record_path(path))
            if record is None:
                print(f"records file not found, skipping: {_resolve_record_path(path)}", file=sys.stderr)
        else:
            print(f"process_directory: unknown mapping name '{name}', skipping", file=sys.stderr)

    if record is None:
        record = _read_optional_records(_resolve_record_path(path))

    # InputData stores raw point lists on this internal class (the public
    # PyInputData wraps them as single contours like py_input_data.rs:183-253)
    return InputData(
        lumen=lumen_points,
        eem=eem,
        calcification=calcification,
        sidebranch=sidebranch,
        record=record,
        ref_point=ref_point,
        diastole=diastole,
        label=label,
    )


class InputData:
    """Raw flattened input bundle (internal form; mirrors the Rust
    ``InputData`` with Vec<ContourPoint> groups)."""

    __slots__ = (
        "lumen",
        "eem",
        "calcification",
        "sidebranch",
        "record",
        "ref_point",
        "diastole",
        "label",
        "lumen_grouped",
    )

    def __init__(
        self,
        lumen: List[PyContourPoint],
        eem=None,
        calcification=None,
        sidebranch=None,
        record: Optional[List[PyRecord]] = None,
        ref_point: Optional[PyContourPoint] = None,
        diastole: bool = True,
        label: str = "",
    ) -> None:
        self.lumen = lumen
        self.eem = eem
        self.calcification = calcification
        self.sidebranch = sidebranch
        self.record = record
        self.ref_point = ref_point
        self.diastole = diastole
        self.label = label
        self.lumen_grouped = None  # set by from_py_input_data's fast path

    @staticmethod
    def from_py_input_data(py_in: PyInputData) -> "InputData":
        """Flatten list-of-PyContour groups into raw point arrays.
        Parity: py_input_data.rs:103-172."""
        def flatten(group):
            if group is None:
                return None
            blocks = []
            for contour in group:
                block = np.empty((contour.n_points, 5))
                block[:, 0] = contour.frame_indices
                block[:, 1:4] = contour.xyz_view()
                block[:, 4] = contour.aortic_flags
                blocks.append(block)
            return np.concatenate(blocks) if blocks else np.zeros((0, 5))

        def group_lumen(group):
            """Rectangular frame-sorted lumen groups skip the flat round
            trip: stack straight to [F, P, 3] (+ the flat view derived from
            it in one pass), so the tensor funnel starts from grouped arrays.
            Returns (grouped dict, flat array) or None when the shape needs
            the generic flatten + re-group."""
            if not group:
                return None
            P = group[0].n_points
            if P == 0 or any(c.n_points != P for c in group):
                return None
            coords = np.stack([c.xyz_view() for c in group])
            pt_frame = np.stack([c.frame_indices for c in group])
            pt_aortic = np.stack([c.aortic_flags for c in group])
            firsts = pt_frame[:, 0]
            if not (pt_frame == firsts[:, None]).all():
                return None  # mixed per-point frame ids: generic grouping
            if not (firsts[1:] > firsts[:-1]).all():
                return None  # unsorted/duplicate frames: generic grouping
            flat = np.empty((coords.shape[0] * P, 5))
            flat[:, 0] = pt_frame.reshape(-1)
            flat[:, 1:4] = coords.reshape(-1, 3)
            flat[:, 4] = pt_aortic.reshape(-1)
            grouped = dict(
                orig=firsts.astype(np.int64),
                coords=coords,
                pt_frame=pt_frame.astype(np.int64),
                # the flat funnel drops point indices (points_to_array fills
                # zeros for array input); keep identical semantics
                pt_index=np.zeros(pt_frame.shape, dtype=np.int64),
                pt_aortic=pt_aortic.astype(bool),
            )
            return grouped, flat

        lumen_grouped = None
        g = group_lumen(py_in.lumen)
        if g is not None:
            lumen_grouped, lumen = g
        else:
            lumen = flatten(py_in.lumen)
        out = InputData(
            lumen=lumen if lumen is not None else np.zeros((0, 5)),
            eem=flatten(py_in.eem),
            calcification=flatten(py_in.calcification),
            sidebranch=flatten(py_in.sidebranch),
            record=list(py_in.record) if py_in.record is not None else None,
            ref_point=py_in.ref_point.copy() if py_in.ref_point is not None else None,
            diastole=py_in.diastole,
            label=py_in.label,
        )
        out.lumen_grouped = lumen_grouped
        return out


# ---------------------------------------------------------------------------
# VTP centerline parser
# ---------------------------------------------------------------------------

_BINARY_PROBE_BYTES = 512
_MIN_TANGENT_NORM = 1e-12


def _extract_section(xml: str, tag: str) -> str:
    open_tag = f"<{tag}"
    close_tag = f"</{tag}>"
    start = xml.find(open_tag)
    if start < 0:
        raise ValueError(f"VTP: <{tag}> section not found")
    rest = xml[start:]
    end_rel = rest.find(close_tag)
    if end_rel < 0:
        raise ValueError(f"VTP: </{tag}> not found")
    return rest[: end_rel + len(close_tag)]


def _dataarray_text(section: str, name: str) -> str:
    needle = f'Name="{name}"'
    pos = section.find(needle)
    if pos < 0:
        raise ValueError(f'VTP: DataArray Name="{name}" not found')
    da_start = section.rfind("<DataArray", 0, pos)
    if da_start < 0:
        raise ValueError(f'VTP: no <DataArray before Name="{name}"')
    rest = section[da_start:]
    tag_end = rest.find(">")
    if tag_end < 0:
        raise ValueError(f'VTP: unclosed <DataArray Name="{name}">')
    inner = rest[tag_end + 1 :]
    close_pos = inner.find("</DataArray>")
    if close_pos < 0:
        raise ValueError(f'VTP: no </DataArray> for Name="{name}"')
    text = inner[:close_pos].strip()
    text_end = text.find("<")
    if text_end < 0:
        text_end = len(text)
    return text[:text_end].strip()


def read_centerline_vtp(path) -> PyCenterline:
    """ASCII VTP centerline parser: branches ordered by descending arc
    length (longest = branch 0), forward-difference tangents, optional
    MaximumInscribedSphereRadius.  Parity: input.rs:259-460."""
    raw = Path(path).read_bytes()
    if any(b < 0x09 or (0x0D < b < 0x20) for b in raw[:_BINARY_PROBE_BYTES]):
        raise ValueError(
            f"{path!r} appears to be a binary VTP file; only ASCII-format VTP "
            "is supported. Re-export from your software with 'ASCII' data mode."
        )
    xml = raw.decode("utf-8")
    for fmt in ('format="binary"', 'format="appended"'):
        if fmt in xml:
            raise ValueError(
                f"{path!r}: binary-encoded DataArrays detected ({fmt}); only "
                "ASCII format is supported. Re-export with 'ASCII' data mode."
            )

    pts_raw = np.array(
        _dataarray_text(_extract_section(xml, "Points"), "Points").split(),
        dtype=np.float64,
    )
    if pts_raw.size % 3 != 0:
        raise ValueError(f"VTP: Points array length {pts_raw.size} not divisible by 3")
    coords = pts_raw.reshape(-1, 3)
    n_pts = coords.shape[0]

    radii = np.zeros(n_pts)
    try:
        point_data = _extract_section(xml, "PointData")
        r = np.array(
            _dataarray_text(point_data, "MaximumInscribedSphereRadius").split(),
            dtype=np.float64,
        )
        if r.size == n_pts:
            radii = r
    except ValueError:
        pass

    lines_sec = _extract_section(xml, "Lines")
    connectivity = np.array(_dataarray_text(lines_sec, "connectivity").split(), dtype=np.int64)
    offsets = np.array(_dataarray_text(lines_sec, "offsets").split(), dtype=np.int64)
    if offsets.size == 0:
        raise ValueError("VTP: Lines section is empty (no branches)")
    if offsets[-1] != connectivity.size:
        raise ValueError(
            f"VTP: last offset ({offsets[-1]}) != connectivity length ({connectivity.size})"
        )

    starts = np.concatenate([[0], offsets])
    vtk_branches = [
        connectivity[starts[i] : offsets[i]] for i in range(offsets.size)
    ]

    def branch_arc_length(branch):
        if branch.size < 2:
            return 0.0
        seg = coords[branch[1:]] - coords[branch[:-1]]
        return float(np.sqrt((seg * seg).sum(-1)).sum())

    lengths = [branch_arc_length(b) for b in vtk_branches]
    order = sorted(range(len(vtk_branches)), key=lambda i: -lengths[i])

    cl_points: List[PyCenterlinePoint] = []
    branch_start_indices: List[int] = []
    for branch_id, vtk_idx in enumerate(order):
        branch_start_indices.append(len(cl_points))
        branch = vtk_branches[vtk_idx]
        L = int(branch.size)
        if L == 0:
            continue
        bad = branch[branch >= n_pts]
        if bad.size:
            raise ValueError(
                f"VTP: connectivity index {int(bad[0])} out of range ({n_pts} points)"
            )
        bc = coords[branch]  # [L, 3]
        # forward-difference tangents, one vectorised pass (bit-equal to the
        # per-point np.linalg.norm form: the 3-vector dot sums in the same
        # x,y,z order); last point inherits its predecessor's tangent
        tang = np.zeros((L, 3))
        if L >= 2:
            diff = bc[1:] - bc[:-1]
            norm = np.sqrt((diff * diff).sum(-1))
            ok = norm > _MIN_TANGENT_NORM
            tang[:-1] = np.where(
                ok[:, None], diff / np.where(ok, norm, 1.0)[:, None], 0.0
            )
            tang[-1] = tang[-2]
        cl_points.extend(
            clpoints_from_lists(
                bc.tolist(), tang.tolist(), radii[branch].tolist(),
                branch_id, len(cl_points),
            )
        )
    return PyCenterline(cl_points, branch_start_indices)
