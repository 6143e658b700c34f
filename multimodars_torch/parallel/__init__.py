"""Batched registration of many pullbacks on one device."""

from .cohort import batched_pairs_from_geometries, cohort_relative_rotations

__all__ = ["batched_pairs_from_geometries", "cohort_relative_rotations"]
