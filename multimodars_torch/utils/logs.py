"""Alignment logs: the machine-readable observability surface.

Parity: ``AlignLog`` (align_within.rs:14-22), the tuple conversion
(functions.rs:8,26-40) and the printed table (align_within.rs:681-779).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class AlignLog:
    contour_id: int
    matched_to: int
    rot_deg: float
    tx: float
    ty: float
    centroid: Tuple[float, float]


def logs_to_tuples(logs: List[AlignLog]):
    """(id, matched_to, rot_deg, tx, ty, centroid_x, centroid_y) tuples."""
    return [
        (l.contour_id, l.matched_to, l.rot_deg, l.tx, l.ty, l.centroid[0], l.centroid[1])
        for l in logs
    ]


def dump_table(title: str, logs: List[AlignLog]) -> None:
    headers = ["Contour", "Matched To", "Rotation (°)", "Tx", "Ty", "Centroid"]
    rows = [
        (
            str(l.contour_id),
            str(l.matched_to),
            f"{l.rot_deg:.2f}",
            f"{l.tx:.2f}",
            f"{l.ty:.2f}",
            f"({l.centroid[0]:.2f},{l.centroid[1]:.2f})",
        )
        for l in logs
    ]
    widths = [
        max(len(h), max((len(r[i]) for r in rows), default=0))
        for i, h in enumerate(headers)
    ]

    total_inner = sum(widths) + 3 * len(widths) - 1
    pad = max(total_inner - len(title), 0)
    sep = "+" + "".join("-" * (w + 2) + "+" for w in widths)
    header_cells = "|" + "".join(
        f" {h:^{w}} |" for h, w in zip(headers, widths)
    )
    fmt = "|" + "".join(f" {{:<{w}}} |" for w in widths)
    lines = [
        "\n+" + "-" * total_inner + "+",
        "|" + " " * (pad // 2) + title + " " * (pad - pad // 2) + "|",
        sep,
        header_cells,
        sep,
    ]
    lines.extend(fmt.format(*row) for row in rows)
    lines.append(sep)
    print("\n".join(lines))
