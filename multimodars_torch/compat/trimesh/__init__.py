"""Minimal trimesh-compatible facade over the package-native Mesh.

The reference's CCTA layer (and its test suite) is written against the
``trimesh`` package; this framework ships its own array-native
:class:`multimodars_torch.ccta.mesh.Mesh` with a constructor/attribute
surface designed to match the subset the pipelines use.  Prepending
``multimodars_torch/compat`` to ``sys.path`` makes ``import trimesh``
resolve here, so reference-targeting code runs unmodified without the
external dependency.

Covered surface: ``Trimesh(vertices=, faces=, process=)`` with
vertices/faces/copy/face_normals/vertex_normals/volume/is_watertight/
fill_holes/update_faces/unique_faces/nondegenerate_faces/merge_vertices/
remove_unreferenced_vertices/export, plus ``trimesh.creation.icosphere``
and ``trimesh.creation.box``.
"""

from multimodars_torch.ccta.mesh import Mesh as Trimesh  # noqa: F401

from . import creation  # noqa: F401

__all__ = ["Trimesh", "creation"]
