"""Convex-hull preprocessing on the host (the GCLIB_QuickHull / GCLIB_DeHull
capability).

Port of ``gjkepa_tpu/utils/hull.py``.  The reference presumes hull
construction and a face-soup deduplicator from its private GCLIB library; the
query path never rebuilds hulls (incremental EPA), so these prepare input:

  * :func:`convex_hull` / :func:`convex_hull_batch`: point cloud ->
    triangle faces and extreme-vertex indices, through the repository's
    C++ QuickHull (``native/quickhull.cpp``, built by ``native/Makefile``
    into ``native/build/libquickhull.so`` at first use) or scipy's qhull;
  * :func:`hull_vertices`: the extreme subset of a cloud;
  * :func:`dedup_vertices`: face soup -> unique vertex list
    (getHullMeshesVertex's contract);
  * :func:`pad_hulls`: ragged hulls -> padded (B, N, 3) and (B, N) mask for
    :func:`gjkepa_tpu_torch.gjkepa_batch`.

numpy in, numpy out, as in the JAX package: the query functions take the
arrays through ``torch.from_numpy``.  With ``backend="auto"`` a missing
compiler falls back to scipy, which gives the same extreme sets (a host
utility, not a kernel).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["convex_hull", "convex_hull_batch", "hull_vertices",
           "dedup_vertices", "pad_hulls", "native_available"]

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libquickhull.so"
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


class _Native:
    """The QuickHull library, built and loaded once a process."""

    lib = None
    failed = False


def _build() -> None:
    """``make`` into a directory of its own under ``native/build``, then an
    atomic rename, so that processes building at once never load a
    half-written library."""
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=_LIB_PATH.parent))
    try:
        subprocess.run(["make", "-s", "-C", str(_NATIVE_DIR),
                        f"BUILD={tmp}"], check=True, capture_output=True)
        os.replace(tmp / _LIB_PATH.name, _LIB_PATH)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _load_native():
    if _Native.lib is not None or _Native.failed:
        return _Native.lib
    try:
        if not _LIB_PATH.exists():
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"[gjkepa_tpu_torch] native quickhull unavailable ({e}); "
              "using scipy", file=sys.stderr)
        _Native.failed = True
        return None
    lib.qh_convex_hull.restype = ctypes.c_int
    lib.qh_convex_hull.argtypes = [_F64P, ctypes.c_int, _I32P, ctypes.c_int,
                                   _I32P, _I32P, ctypes.c_int, _I32P]
    lib.qh_convex_hull_batch.restype = ctypes.c_int
    lib.qh_convex_hull_batch.argtypes = [_F64P, ctypes.c_int, ctypes.c_int,
                                         _I32P, ctypes.c_int, _I32P, _I32P,
                                         ctypes.c_int, _I32P]
    _Native.lib = lib
    return lib


def native_available() -> bool:
    return _load_native() is not None


def _i32p(a):
    return a.ctypes.data_as(_I32P)


def _f64p(a):
    return a.ctypes.data_as(_F64P)


def _use_native(backend: str) -> bool:
    if backend not in ("auto", "native", "scipy"):
        raise ValueError(f"unknown hull backend {backend!r}")
    if backend == "native" and not native_available():
        raise RuntimeError("native quickhull could not be built or loaded")
    return backend == "native" or (backend == "auto" and native_available())


def _hull_native(points: np.ndarray):
    n = points.shape[0]
    max_faces = max(4, 2 * n)
    pts = np.ascontiguousarray(points, dtype=np.float64)
    faces = np.empty((max_faces, 3), np.int32)
    verts = np.empty((n,), np.int32)
    nf = np.zeros(1, np.int32)
    nv = np.zeros(1, np.int32)
    rc = _load_native().qh_convex_hull(_f64p(pts), n, _i32p(faces),
                                       max_faces, _i32p(nf), _i32p(verts), n,
                                       _i32p(nv))
    if rc != 0:
        raise ValueError(f"qh_convex_hull failed (rc={rc}): degenerate input?")
    return faces[: int(nf[0])].copy(), verts[: int(nv[0])].copy()


def _hull_scipy(points: np.ndarray):
    from scipy.spatial import ConvexHull

    h = ConvexHull(points, qhull_options="Qt")
    return h.simplices.astype(np.int32), h.vertices.astype(np.int32)


def convex_hull(points: np.ndarray, backend: str = "auto"):
    """3-D convex hull: (faces (F, 3) int32 vertex indices, vert_idx (V,))."""
    points = np.asarray(points, dtype=np.float64)
    if _use_native(backend):
        return _hull_native(points)
    return _hull_scipy(points)


def convex_hull_batch(points: np.ndarray, backend: str = "auto"):
    """Batch hulls: points (B, N, 3) -> list of (faces, vert_idx) a cloud."""
    points = np.asarray(points, dtype=np.float64)
    b, n = points.shape[0], points.shape[1]
    if not _use_native(backend):
        return [_hull_scipy(points[i]) for i in range(b)]
    max_faces = max(4, 2 * n)
    pts = np.ascontiguousarray(points)
    faces = np.empty((b, max_faces, 3), np.int32)
    verts = np.empty((b, n), np.int32)
    nf = np.zeros(b, np.int32)
    nv = np.zeros(b, np.int32)
    fails = _load_native().qh_convex_hull_batch(
        _f64p(pts), b, n, _i32p(faces), max_faces, _i32p(nf), _i32p(verts),
        n, _i32p(nv))
    if fails:
        raise ValueError(f"{fails} clouds failed convex_hull_batch")
    return [(faces[i, : nf[i]].copy(), verts[i, : nv[i]].copy())
            for i in range(b)]


def hull_vertices(points: np.ndarray, backend: str = "auto") -> np.ndarray:
    """The extreme subset of a cloud (interior points stripped)."""
    _, idx = convex_hull(points, backend)
    return np.asarray(points, dtype=np.float64)[idx]


def dedup_vertices(face_soup: np.ndarray, tol: float = 0.0) -> np.ndarray:
    """Face soup (F, 3, 3) -> unique vertex list (getHullMeshesVertex, ref
    :920); with ``tol`` > 0, points within a ``tol`` grid cell merge (the
    first kept, in input order)."""
    pts = np.asarray(face_soup, dtype=np.float64).reshape(-1, 3)
    if tol <= 0:
        return np.unique(pts, axis=0)
    scaled = np.round(pts / tol).astype(np.int64)
    _, idx = np.unique(scaled, axis=0, return_index=True)
    return pts[np.sort(idx)]


def pad_hulls(hulls, pad_to: int | None = None, dtype=np.float32):
    """Ragged list of (Ni, 3) vertex arrays -> padded (B, N, 3) and (B, N)
    mask.  Padding repeats each hull's first vertex, so the padded buffer is
    the same convex set even without the mask."""
    sizes = [len(h) for h in hulls]
    n = pad_to or max(sizes)
    if max(sizes) > n:
        raise ValueError(f"pad_to={n} smaller than largest hull "
                         f"({max(sizes)})")
    out = np.empty((len(hulls), n, 3), dtype=dtype)
    mask = np.zeros((len(hulls), n), dtype=bool)
    for i, h in enumerate(hulls):
        k = len(h)
        out[i, :k] = h
        out[i, k:] = h[0]
        mask[i, :k] = True
    return out, mask
