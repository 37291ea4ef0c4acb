"""Mesh IO + surface sampling + nearest-point snap (host-side).

Counterpart of garment_pattern_estimation_tpu/preprocess/mesh.py:1-88, the
port's own copy (numpy inside, the native library of `native.py`).

Replaces the reference's libigl calls (nn/data/datasets.py:832-888,
nn/data/utils.py:96-110): OBJ loading, area-weighted barycentric point
sampling, and nearest-vertex queries for segmentation label transfer. The
fast path is the C++ extension in `preprocess/_native`; numpy/scipy
fallbacks keep everything functional without a toolchain.

Sampling is deterministic per (mesh, seed): the reference's igl path was not,
which made caching the only source of epoch-to-epoch consistency; here every
call with the same seed returns the same points.
"""
from __future__ import annotations

import numpy as np

from . import native


def read_triangle_mesh(path):
    """(verts [V,3] float64, faces [F,3] int64) from an OBJ file."""
    result = native.obj_parse_native(path)
    if result is not None:
        return result
    return _read_obj_numpy(path)


def _read_obj_numpy(path):
    verts, faces = [], []
    with open(path, 'r') as f:
        for line in f:
            if line.startswith('v '):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith('f '):
                idx = [int(tok.split('/')[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(2, len(idx)):  # fan triangulation
                    faces.append([idx[0], idx[k - 1], idx[k]])
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int64)


def sample_mesh_points(num_points, verts, faces, seed=None, rng=None):
    """Area-weighted uniform sampling of `num_points` points on the surface.

    Deterministic when `seed` is given (routes to the native counter-based
    RNG); falls back to vectorized numpy with `rng`/fresh entropy otherwise.
    """
    if seed is not None:
        result = native.sample_surface_native(verts, faces, num_points, seed)
        if result is not None:
            return result
        rng = np.random.default_rng(seed)
    if rng is None:
        rng = np.random.default_rng()
    return _sample_numpy(num_points, verts, faces, rng)


def _sample_numpy(num_points, verts, faces, rng):
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    tri = verts[faces]  # (F, 3, 3)
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    probs = areas / areas.sum()
    face_ids = rng.choice(len(faces), size=num_points, p=probs)
    u = rng.random(num_points)
    v = rng.random(num_points)
    flip = u + v > 1.0
    u[flip], v[flip] = 1.0 - u[flip], 1.0 - v[flip]
    w = 1.0 - u - v
    chosen = tri[face_ids]
    return (w[:, None] * chosen[:, 0] + u[:, None] * chosen[:, 1]
            + v[:, None] * chosen[:, 2])


def snap_points(queries, targets):
    """Nearest `targets` index (and squared distance) for every query point."""
    queries = np.asarray(queries, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    if len(queries) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0)
    result = native.snap_points_native(queries, targets)
    if result is not None:
        return result
    from scipy.spatial import cKDTree
    dist, idx = cKDTree(targets).query(queries)
    return idx.astype(np.int64), dist ** 2
