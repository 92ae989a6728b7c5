"""Build and bind the hull kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles the CUDA sources of this package, and nothing else, into
one shared library with a plain C interface for ``sm_90a`` (H100), which
``ctypes`` loads.  The library name carries a hash of the sources and the
flags, so an edit rebuilds it; the build goes to ``gjkepa_tpu_torch/build/``
(ignored by git) through a temporary file, so concurrent first uses do not
see a half-written library.  The compiler's register and spill report
(``-Xptxas -v``) is kept beside the library as ``<name>.log``.

``--fmad=false`` keeps every product and sum separately rounded, as in the
plain PyTorch versions, so the kernels' discrete verdicts can be held to
them exactly (see PERF.md).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("gjk_hulls.cu", "epa_hulls.cu")
HEADERS = ("lane_geom.cuh",)
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found: the hull kernels build only where the "
                       "CUDA toolkit is installed")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libgjkepa_hulls_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(str(CSRC / s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lib.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def ptr(t) -> ctypes.c_void_p:
    """A tensor's data pointer as a C pointer argument."""
    return ctypes.c_void_p(t.data_ptr())


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    lib.gjk_hulls_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                     cf, cf, cf, cf, ci, vp]
    lib.gjk_hulls_launch.restype = ci
    lib.epa_hulls_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                     ci, ci, ci, ci, ip, ip, ci, cf, cf, ci, vp]
    lib.epa_hulls_launch.restype = ci
    lib.epa_scratch_words_per_face.argtypes = []
    lib.epa_scratch_words_per_face.restype = ci
    return lib
