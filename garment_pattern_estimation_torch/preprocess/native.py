"""ctypes loader for the native mesh-ops library (builds on first use).

Counterpart of garment_pattern_estimation_tpu/preprocess/native.py, with
the port's own copy of the C++ source (`_native/mesh_ops.cpp`). The library
is built with g++ at first use into the port's `_build/` directory, under a
name that hashes the source and the flags, never next to the source. Where
no toolchain exists the loader returns None and the callers take their
numpy/scipy fallbacks, as the JAX package's loader does (its lines 24-26):
the samples a dataset yields are defined by that choice.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / '_native' / 'mesh_ops.cpp'
_BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']

_lib = None
_load_error = None


def _library_path():
    digest = hashlib.sha256(_SRC.read_bytes() + ' '.join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f'libmesh_ops-{digest}.so'


def _build(path):
    """g++ into a temporary file beside `path`, then an atomic rename, so a
    concurrent loader never opens a half-written library."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(['g++', *_FLAGS, str(_SRC), '-o', tmp], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded native library, building it if needed; None when a native
    toolchain is unavailable (callers fall back to numpy/scipy)."""
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        path = _library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))

        lib.obj_parse.restype = ctypes.c_void_p
        lib.obj_parse.argtypes = [ctypes.c_char_p]
        lib.obj_free.argtypes = [ctypes.c_void_p]
        lib.obj_n_verts.restype = ctypes.c_int64
        lib.obj_n_verts.argtypes = [ctypes.c_void_p]
        lib.obj_n_faces.restype = ctypes.c_int64
        lib.obj_n_faces.argtypes = [ctypes.c_void_p]
        lib.obj_copy_verts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
        lib.obj_copy_faces.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]

        lib.sample_surface.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_double),
        ]
        lib.snap_points.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
    except Exception as e:  # pragma: no cover - toolchain-dependent
        _load_error = e
        print(f'preprocess.native::Warning::native mesh ops unavailable ({e}); '
              'using numpy/scipy fallbacks')
    return _lib


def _dptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def obj_parse_native(path):
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.obj_parse(str(path).encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        n_verts, n_faces = lib.obj_n_verts(handle), lib.obj_n_faces(handle)
        verts = np.empty((n_verts, 3), dtype=np.float64)
        faces = np.empty((n_faces, 3), dtype=np.int64)
        lib.obj_copy_verts(handle, _dptr(verts))
        lib.obj_copy_faces(handle, _iptr(faces))
    finally:
        lib.obj_free(handle)
    return verts, faces


def sample_surface_native(verts, faces, n_points, seed):
    lib = get_lib()
    if lib is None:
        return None
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    out = np.empty((n_points, 3), dtype=np.float64)
    lib.sample_surface(_dptr(verts), len(verts), _iptr(faces), len(faces),
                       n_points, ctypes.c_uint64(seed & (2**64 - 1)), _dptr(out))
    return out


def snap_points_native(queries, targets):
    lib = get_lib()
    if lib is None:
        return None
    queries = np.ascontiguousarray(queries, dtype=np.float64)
    targets = np.ascontiguousarray(targets, dtype=np.float64)
    idx = np.empty(len(queries), dtype=np.int64)
    sq_dist = np.empty(len(queries), dtype=np.float64)
    lib.snap_points(_dptr(queries), len(queries), _dptr(targets), len(targets),
                    _iptr(idx), _dptr(sq_dist))
    return idx, sq_dist
