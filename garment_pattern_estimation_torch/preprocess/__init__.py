"""Host-side mesh preprocessing (OBJ IO, sampling, snap): the port's copy of
garment_pattern_estimation_tpu/preprocess/ (`mesh.py`, `native.py` and the
C++ source). On-device sampling (`device_sampling.py`) is not ported."""

from .mesh import read_triangle_mesh, sample_mesh_points, snap_points

__all__ = ['read_triangle_mesh', 'sample_mesh_points', 'snap_points']
