"""Mesh loading with lightweight repair.

Parity: ``multimodars/io/read_geometrical.py`` of the reference (trimesh
replaced by the package-native Mesh)."""

from __future__ import annotations

import warnings
from pathlib import Path


def read_mesh(path):
    """Load a mesh from disk and attempt lightweight repairs: dedupe faces,
    drop degenerate faces + unreferenced vertices, fix normals, fill holes;
    warns when the result is not watertight."""
    from ..ccta.mesh import read_mesh_file

    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Geometry file not found: {path}")

    try:
        mesh = read_mesh_file(path)
    except Exception as exc:
        raise RuntimeError(f"Failed to load mesh from {path}: {exc}") from exc

    mesh.remove_duplicate_faces()
    mesh.remove_unreferenced_vertices()
    mesh.remove_degenerate_faces()
    mesh.fix_normals()

    try:
        mesh.fill_holes()
    except Exception:
        warnings.warn(f"fill_holes failed for mesh from {path}", RuntimeWarning)

    if not mesh.is_watertight:
        warnings.warn(f"Mesh from {path} is not watertight after repairs", RuntimeWarning)
    return mesh
