"""Rotation conversions used by the sewing-pattern spec.

Panel rotations in the garment dataset follow the Maya convention: rotations
are applied around the fixed world X, then Y, then Z axes (scipy's extrinsic
'xyz' order), stored as degrees. The reference relies on
``scipy.spatial.transform.Rotation.from_euler('xyz', degrees=True)``
(reference: nn/data/pattern_converter.py:223) and on the external pattern
library's ``rotation.euler_xyz_to_R`` for the same conversion; we reproduce
both here on top of scipy so quaternion signs match bit-for-bit.

The port's copy of garment_pattern_estimation_tpu/core/rotations.py:1-37.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as _R


def euler_xyz_to_matrix(euler_deg) -> np.ndarray:
    """3x3 rotation matrix from Maya-convention euler angles in degrees."""
    return _R.from_euler('xyz', np.asarray(euler_deg, dtype=float), degrees=True).as_matrix()


def euler_xyz_to_quat(euler_deg) -> np.ndarray:
    """Quaternion (x, y, z, w — scipy order) from euler angles in degrees."""
    return np.asarray(_R.from_euler('xyz', np.asarray(euler_deg, dtype=float), degrees=True).as_quat())


def quat_to_euler_xyz(quat) -> np.ndarray:
    """Euler angles in degrees from an (x, y, z, w) quaternion."""
    return np.asarray(_R.from_quat(np.asarray(quat, dtype=float)).as_euler('xyz', degrees=True))


def quat_to_matrix(quat) -> np.ndarray:
    return np.asarray(_R.from_quat(np.asarray(quat, dtype=float)).as_matrix())


def matrix_to_euler_xyz(matrix) -> np.ndarray:
    return np.asarray(_R.from_matrix(np.asarray(matrix, dtype=float)).as_euler('xyz', degrees=True))
