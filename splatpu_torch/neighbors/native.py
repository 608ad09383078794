"""ctypes bindings of the repo's native C++ KD-tree kNN
(``native/knn/kdtree.cpp``, read as it is; port of
``splatpu/neighbors/native.py``).

The library is built with g++ at first use into
``splatpu_torch/_build/knn/`` (written to a file of this process's own and
renamed into place, so processes building at once do not collide).  Where
g++ or the build fails, ``available()`` is false and ``knn`` keeps to the
brute force.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "knn" / "kdtree.cpp"
LIBRARY = Path(__file__).resolve().parents[1] / "_build" / "knn" / "libsplatpu_knn.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
                LIBRARY.parent.mkdir(parents=True, exist_ok=True)
                tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp),
                                str(SOURCE), "-lpthread"], check=True, capture_output=True,
                               timeout=300)
                tmp.replace(LIBRARY)
            lib = ctypes.CDLL(str(LIBRARY))
        except (OSError, subprocess.SubprocessError):
            return None
        i32p, f32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
        lib.splatpu_knn.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32, i32p, f32p,
                                    ctypes.c_int32]
        lib.splatpu_knn_query.argtypes = [f32p, ctypes.c_int32, f32p, ctypes.c_int32,
                                          ctypes.c_int32, i32p, f32p, ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def knn_native(points: np.ndarray, k: int, num_threads: int = 0):
    """Exact self-kNN: (indices int32, squared distances float32), both
    (N, k), ascending; index -1 and distance inf where fewer than k other
    points exist.  Raises RuntimeError if the library cannot be built."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native kNN library could not be built (is g++ installed?)")
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = pts.shape[0]
    idx = np.empty((n, k), np.int32)
    d2 = np.empty((n, k), np.float32)
    lib.splatpu_knn(_ptr(pts, ctypes.c_float), n, k, _ptr(idx, ctypes.c_int32),
                    _ptr(d2, ctypes.c_float), num_threads)
    return idx, d2


def knn_query_native(points: np.ndarray, queries: np.ndarray, k: int, num_threads: int = 0):
    """kNN of external query points in the cloud (no self-exclusion)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native kNN library could not be built (is g++ installed?)")
    pts = np.ascontiguousarray(points, dtype=np.float32)
    q = np.ascontiguousarray(queries, dtype=np.float32)
    m = q.shape[0]
    idx = np.empty((m, k), np.int32)
    d2 = np.empty((m, k), np.float32)
    lib.splatpu_knn_query(_ptr(pts, ctypes.c_float), pts.shape[0], _ptr(q, ctypes.c_float), m,
                          k, _ptr(idx, ctypes.c_int32), _ptr(d2, ctypes.c_float), num_threads)
    return idx, d2
