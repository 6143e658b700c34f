"""Primitive constructors matching the trimesh.creation subset used by the
reference tests: an icosphere (subdivided icosahedron projected onto the
unit sphere) and an axis-aligned unit box, both with consistent outward
(CCW-from-outside) winding."""

from __future__ import annotations

import numpy as np

from multimodars_torch.ccta.mesh import Mesh


def _icosahedron():
    phi = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return verts, faces


def icosphere(subdivisions: int = 3, radius: float = 1.0) -> Mesh:
    """Subdivided icosahedron projected onto a sphere (outward winding)."""
    verts, faces = _icosahedron()
    for _ in range(int(subdivisions)):
        vlist = verts.tolist()
        midpoint = {}

        def mid(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            if key not in midpoint:
                m = (np.asarray(vlist[a]) + np.asarray(vlist[b])) / 2.0
                m /= np.linalg.norm(m)
                midpoint[key] = len(vlist)
                vlist.append(m.tolist())
            return midpoint[key]

        new_faces = []
        for a, b, c in faces.tolist():
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces.extend([[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]])
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, dtype=np.int64)
    return Mesh(verts * radius, faces)


def box(extents=(1.0, 1.0, 1.0)) -> Mesh:
    """Axis-aligned box centered at the origin (outward winding)."""
    e = np.asarray(extents, dtype=np.float64) / 2.0
    corners = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
        dtype=np.float64,
    ) * e  # index bits: x<<2 | y<<1 | z
    quads = [
        (0, 1, 3, 2),  # -x
        (4, 6, 7, 5),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    faces = []
    for a, b, c, d in quads:
        faces.append([a, b, c])
        faces.append([a, c, d])
    return Mesh(corners, np.asarray(faces, dtype=np.int64))
