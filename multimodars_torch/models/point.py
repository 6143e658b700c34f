"""Contour points and contour-type enumeration.

Parity: ``src/types/binding/py_contour_point.rs`` and the ``PyContourType``
enum in ``src/types/binding/py_contour.rs:310-409`` of the reference.
"""

from __future__ import annotations

import math


CONTOUR_TYPE_NAMES = ("Lumen", "Eem", "Calcification", "Sidebranch", "Catheter", "Wall")


class PyContourType:
    """Enumeration of supported intravascular contour types.

    Members: Lumen, Eem, Calcification, Sidebranch, Catheter, Wall.
    Instances are interned singletons so identity / equality / hashing behave
    like a Rust enum exposed through PyO3.
    """

    __slots__ = ("_name",)
    _registry: dict = {}

    def __new__(cls, name: str = "Lumen"):
        key = name
        inst = cls._registry.get(key)
        if inst is None:
            if key not in CONTOUR_TYPE_NAMES:
                raise ValueError(f"Unknown contour type: '{name}'")
            inst = super().__new__(cls)
            inst._name = key
            cls._registry[key] = inst
        return inst

    @property
    def name(self) -> str:
        return self._name

    @staticmethod
    def from_string(name: str) -> "PyContourType":
        lowered = name.lower()
        for canonical in CONTOUR_TYPE_NAMES:
            if canonical.lower() == lowered:
                return PyContourType(canonical)
        raise ValueError(
            f"Unknown contour type: '{name}'. Valid types are: "
            "lumen, eem, calcification, sidebranch, catheter, wall"
        )

    @staticmethod
    def all_types() -> list:
        return [PyContourType(n) for n in CONTOUR_TYPE_NAMES]

    def __repr__(self) -> str:
        return f"PyContourType.{self._name}"

    def __str__(self) -> str:
        return self._name

    def __hash__(self) -> int:
        return hash(self._name)

    def __eq__(self, other) -> bool:
        if isinstance(other, PyContourType):
            return self._name == other._name
        return NotImplemented


# Class-level enum members (PyContourType.Lumen etc.)
for _n in CONTOUR_TYPE_NAMES:
    setattr(PyContourType, _n, PyContourType(_n))


class PyContourPoint:
    """A single 3-D point on a contour or centerline.

    Attributes: frame_index, point_index, x, y, z (mm), aortic flag.
    """

    __slots__ = ("frame_index", "point_index", "x", "y", "z", "aortic")

    def __init__(
        self,
        frame_index: int,
        point_index: int,
        x: float,
        y: float,
        z: float,
        aortic: bool,
    ) -> None:
        self.frame_index = int(frame_index)
        self.point_index = int(point_index)
        self.x = float(x)
        self.y = float(y)
        self.z = float(z)
        self.aortic = bool(aortic)

    def distance(self, other: "PyContourPoint") -> float:
        return math.sqrt(
            (self.x - other.x) ** 2 + (self.y - other.y) ** 2 + (self.z - other.z) ** 2
        )

    def distance_2d(self, other: "PyContourPoint") -> float:
        return math.hypot(self.x - other.x, self.y - other.y)

    def translate(self, dx: float, dy: float, dz: float) -> "PyContourPoint":
        return PyContourPoint(
            self.frame_index,
            self.point_index,
            self.x + dx,
            self.y + dy,
            self.z + dz,
            self.aortic,
        )

    def rotate(self, angle_rad: float, center: tuple) -> "PyContourPoint":
        """Rotate in the x/y plane about ``center`` (radians)."""
        if angle_rad == 0.0:
            return PyContourPoint(
                self.frame_index, self.point_index, self.x, self.y, self.z, self.aortic
            )
        cx, cy = center
        x = self.x - cx
        y = self.y - cy
        c = math.cos(angle_rad)
        s = math.sin(angle_rad)
        return PyContourPoint(
            self.frame_index,
            self.point_index,
            x * c - y * s + cx,
            x * s + y * c + cy,
            self.z,
            self.aortic,
        )

    def copy(self) -> "PyContourPoint":
        return PyContourPoint(
            self.frame_index, self.point_index, self.x, self.y, self.z, self.aortic
        )

    def __repr__(self) -> str:
        return (
            f"Point(frame={self.frame_index}, idx={self.point_index}, "
            f"x={self.x:.2f}, y={self.y:.2f}, z={self.z:.2f}, aortic={self.aortic})"
        )

    __str__ = __repr__

    def __eq__(self, other) -> bool:
        if isinstance(other, PyContourPoint):
            return (
                self.frame_index == other.frame_index
                and self.point_index == other.point_index
                and self.x == other.x
                and self.y == other.y
                and self.z == other.z
                and self.aortic == other.aortic
            )
        return NotImplemented
