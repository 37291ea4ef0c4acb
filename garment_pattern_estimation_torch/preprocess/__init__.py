"""Mesh preprocessing: the port's copy of
garment_pattern_estimation_tpu/preprocess/ (`mesh.py`, `native.py` and the
C++ source: OBJ IO, host sampling, snap) and the on-device sampling stage
(`device_sampling.py`)."""

from .mesh import read_triangle_mesh, sample_mesh_points, snap_points

__all__ = ['read_triangle_mesh', 'sample_mesh_points', 'snap_points']
