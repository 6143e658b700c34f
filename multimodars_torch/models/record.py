"""Per-frame measurement records and raw input bundles.

Parity: ``src/types/binding/py_record.rs`` and
``src/types/binding/py_input_data.rs`` of the reference.
"""

from __future__ import annotations

from typing import List, Optional

from .point import PyContourPoint


class PyRecord:
    """Per-frame measurement row: frame number, phase ("D"/"S") and two
    optional measurements (aortic / pulmonary thickness)."""

    __slots__ = ("frame", "phase", "measurement_1", "measurement_2")

    def __init__(
        self,
        frame: int,
        phase: str,
        measurement_1: Optional[float] = None,
        measurement_2: Optional[float] = None,
    ) -> None:
        self.frame = int(frame)
        self.phase = str(phase)
        self.measurement_1 = None if measurement_1 is None else float(measurement_1)
        self.measurement_2 = None if measurement_2 is None else float(measurement_2)

    def __repr__(self) -> str:
        return (
            f"Record(frame={self.frame}, phase='{self.phase}', "
            f"m1={self.measurement_1}, m2={self.measurement_2})"
        )


class PyInputData:
    """Raw intravascular input for one cardiac phase.

    ``lumen``/``eem``/``calcification``/``sidebranch`` are lists of
    :class:`PyContour`; the pipelines flatten them into point clouds grouped
    by ``frame_index`` exactly like the reference binding
    (py_input_data.rs:103-172).
    """

    __slots__ = (
        "lumen",
        "eem",
        "calcification",
        "sidebranch",
        "record",
        "ref_point",
        "diastole",
        "label",
    )

    def __init__(
        self,
        lumen,
        eem=None,
        calcification=None,
        sidebranch=None,
        record: Optional[List[PyRecord]] = None,
        ref_point: Optional[PyContourPoint] = None,
        diastole: bool = True,
        label: str = "",
    ) -> None:
        self.lumen = list(lumen)
        self.eem = None if eem is None else list(eem)
        self.calcification = None if calcification is None else list(calcification)
        self.sidebranch = None if sidebranch is None else list(sidebranch)
        self.record = None if record is None else list(record)
        self.ref_point = ref_point
        self.diastole = bool(diastole)
        self.label = str(label)

    def flatten_points(self, which: str) -> Optional[List[PyContourPoint]]:
        """Flatten a contour group into its raw points (or None)."""
        group = getattr(self, which)
        if group is None:
            return None
        out: List[PyContourPoint] = []
        for contour in group:
            out.extend(contour.points)
        return out

    def __repr__(self) -> str:
        def n(group):
            return 0 if group is None else len(group)

        return (
            f"InputData(lumen={len(self.lumen)}, eem={n(self.eem)}, "
            f"calcification={n(self.calcification)}, sidebranch={n(self.sidebranch)}, "
            f"record={n(self.record)}, ref_point={self.ref_point!r}, "
            f"diastole={self.diastole}, label='{self.label}')"
        )
