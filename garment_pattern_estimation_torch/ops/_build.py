"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each source under `csrc/` compiles into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The library lands
in `garment_pattern_estimation_torch/_build/` under a name that carries a
hash of its source, the shared headers and the flags, so an edited source
or header is rebuilt and a current one is loaded as it is. Nothing is built
when a module is imported: the first launch builds what it needs, and
`build_all` builds every source at once (one nvcc process each, all started
together)."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
SOURCES = {'fused_edgeconv': _CSRC / 'fused_edgeconv.cu',
           'knn_gather': _CSRC / 'knn_gather.cu',
           'knn': _CSRC / 'knn.cu',
           'knn_wide': _CSRC / 'knn_wide.cu'}
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    candidate = Path(cuda_home) / 'bin' / 'nvcc'
    if candidate.exists():
        return str(candidate)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA toolkit')
    return found


def library_path(name: str) -> Path:
    """The library of `name`, named by a hash of its source, of every
    header under `csrc/` (a source may include any of them) and of the
    flags."""
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(_CSRC.glob('*.cuh')):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def _start(name: str):
    """Start nvcc for `name` into a temporary file; returns (process, tmp)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def build_all(names=None) -> dict:
    """Build every named source that has no current library, all nvcc
    processes running at once. Returns {name: {'seconds', 'log', 'path'}}
    (a current library's log is its build's, kept beside it); raises if any
    build fails."""
    names = list(names or SOURCES)
    started = {}
    t0 = time.perf_counter()
    for name in names:
        if not library_path(name).exists():
            started[name] = _start(name)
    report, failures = {}, []
    for name in names:
        if name not in started:
            log_path = library_path(name).with_suffix('.log')
            report[name] = {'seconds': 0.0, 'path': str(library_path(name)),
                            'log': log_path.read_text() if log_path.exists() else 'cached'}
            continue
        proc, tmp = started[name]
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failures.append(f'{name} (nvcc exit {proc.returncode}):\n{log}')
            continue
        library_path(name).with_suffix('.log').write_text(log)   # nvcc's -Xptxas -v report
        os.replace(tmp, library_path(name))
        report[name] = {'seconds': seconds, 'log': log,
                        'path': str(library_path(name))}
    if failures:
        raise RuntimeError('CUDA build failed: ' + '\n'.join(failures))
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of `name`, built first if it has no current build."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
