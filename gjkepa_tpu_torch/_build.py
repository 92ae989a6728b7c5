"""Build and bind the port's kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles each CUDA source of this package into its own shared
library with a plain C interface for ``sm_90a`` (H100), all sources at once
(one ``nvcc`` process each), and ``ctypes`` loads them.  A library's name
carries a hash of its source, the shared headers and the flags, so an edit
rebuilds it; the build goes to ``gjkepa_tpu_torch/build/`` (ignored by git)
through a temporary file, so concurrent first uses do not see a
half-written library.  The compiler's register and spill report
(``-Xptxas -v``) is kept beside each library as ``<name>.log``.

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
import types
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("gjk_hulls.cu", "epa_hulls.cu", "cf_shapes.cu", "gjk_shapes.cu",
           "epa_shapes.cu", "distance_hulls.cu", "gjk_hull_shape.cu",
           "epa_hull_shape.cu", "gjk_hulls_big.cu", "epa_hulls_big.cu")
HEADERS = ("lane_geom.cuh", "gjk_core.cuh", "gjk_quad.cuh", "epa_core.cuh",
           "shape_geom.cuh", "hull_shape.cuh", "hull_stream.cuh",
           "epa_warp.cuh", "epa_polish_warp.cuh", "tma_stage.cuh")
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ip = ctypes.POINTER(ctypes.c_int)
# C entry points: name -> (source, argument types); each returns an int.
ENTRY_POINTS = {
    "gjk_hulls_launch": ("gjk_hulls.cu", [_vp] * 8 + [_ci] * 6
                         + [_cf] * 4 + [_ci, _vp]),
    "gjk_hulls_staged_bytes": ("gjk_hulls.cu", [_ci] * 2),
    "epa_hulls_launch": ("epa_hulls.cu", [_vp] * 12 + [_ci] * 4
                         + [_ip, _ip] + [_ci] * 4 + [_cf, _cf, _ci, _vp]),
    "epa_hulls_smem_bytes": ("epa_hulls.cu", [_ci, _ci]),
    "epa_hulls_device": ("epa_hulls.cu", [_ci, _ip]),
    "epa_hulls_blocks_per_sm": ("epa_hulls.cu", [_ci, _ci]),
    "epa_scratch_words_per_face": ("epa_hulls.cu", []),
    "gjk_hulls_big_launch": ("gjk_hulls_big.cu", [_vp] * 9 + [_ci] * 3
                             + [_cf] * 4 + [_ci, _vp]),
    "gjk_hulls_big_staged": ("gjk_hulls_big.cu", [_ci, _ci]),
    "epa_hulls_big_launch": ("epa_hulls_big.cu", [_vp] * 10 + [_ci] * 4
                             + [_ip, _ip, _ci, _ci, _cf, _cf, _ci, _vp]),
    "epa_hulls_big_smem_bytes": ("epa_hulls_big.cu", [_ci]),
    "epa_hulls_big_smem_limit": ("epa_hulls_big.cu", []),
    "cf_shapes_launch": ("cf_shapes.cu", [_vp] * 9 + [_ci, _cf, _vp]),
    "gjk_sub_shapes_launch": ("gjk_shapes.cu", [_vp] * 11 + [_ci]
                              + [_cf] * 4 + [_ci, _vp]),
    "gjk_shapes_launch": ("gjk_shapes.cu", [_vp] * 12 + [_ci] + [_cf] * 4
                          + [_ci, _vp]),
    "epa_shapes_launch": ("epa_shapes.cu", [_vp] * 9 + [_ci, _ci, _ip, _ip,
                                                        _ci, _cf, _cf, _ci,
                                                        _vp]),
    "epa_shapes_smem_bytes": ("epa_shapes.cu", [_ci]),
    "distance_hulls_launch": ("distance_hulls.cu", [_vp] * 10 + [_ci] * 4
                              + [_cf, _ci, _vp]),
    "gjk_hull_shape_launch": ("gjk_hull_shape.cu", [_vp] * 10 + [_ci] * 3
                              + [_cf] * 4 + [_ci, _vp]),
    "epa_hull_shape_launch": ("epa_hull_shape.cu", [_vp] * 9
                              + [_ci, _ci, _ci, _ip, _ip, _ci, _cf, _cf, _ci,
                                 _vp]),
    "epa_hull_shape_smem_bytes": ("epa_hull_shape.cu", [_ci]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found: the port's kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(source: str) -> Path:
    """Where the library of one source lives (its name hashes the inputs)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source whose library does not exist yet, all at once."""
    libs = {s: library_path(s) for s in SOURCES}
    todo = [s for s, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for s in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / s)]
            jobs.append((s, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for s, tmp, cmd, proc in jobs:
            out, err = proc.communicate()
            libs[s].with_suffix(".log").write_text(" ".join(cmd) + "\n" + out
                                                   + err)
            if proc.returncode != 0:
                failed.append(f"{s}: nvcc failed ({proc.returncode}):\n"
                              f"{err[-4000:]}")
            else:
                os.replace(tmp, libs[s])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return libs


def bind(libs: dict[str, ctypes.CDLL]) -> types.SimpleNamespace:
    """Declare the C entry points of loaded libraries (source -> CDLL)."""
    fns = {}
    for name, (source, argtypes) in ENTRY_POINTS.items():
        fn = getattr(libs[source], name)
        fn.argtypes = argtypes
        fn.restype = _ci
        fns[name] = fn
    return types.SimpleNamespace(**fns)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's data pointer as a C pointer argument."""
    return ctypes.c_void_p(t.data_ptr())


def on_card(t: torch.Tensor, kernel: str) -> bool:
    """False for CPU tensors (a wrapper then runs the plain version), True
    for CUDA tensors (it launches the kernel); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {t.device}")
    return True


@functools.cache
def smem_limit(dev: torch.device) -> int:
    """The most dynamic shared memory a block may opt into on ``dev``, in
    bytes (232,448 on an H100)."""
    with torch.cuda.device(dev):
        limit = load().epa_hulls_big_smem_limit()
    if limit < 0:
        raise RuntimeError(f"cannot read the shared memory limit of {dev}")
    return limit


def smem_refusal(smem_bytes, faces: int, dev: torch.device):
    """An ``explain`` for :func:`launch` by a kernel whose block keeps a
    polytope of ``faces`` faces in shared memory (``smem_bytes(faces)``
    bytes a block): names the bytes when they are past ``dev``'s limit."""
    def explain(rc):
        need, limit = smem_bytes(faces), smem_limit(dev)
        if need > limit:
            return (f"the polytope of {faces} faces needs {need} bytes of "
                    f"shared memory a block, the device allows {limit}")
        return None
    return explain


def launch(name: str, dev: torch.device, counts: dict, *args,
           explain=None) -> None:
    """Call the C entry point ``<name>_launch(*args, stream)`` on ``dev``'s
    current stream, raise on its CUDA error code (with what
    ``explain(rc)`` says, if anything, on ``dev``), and count the launch in
    ``counts[name]``."""
    lib = load()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = getattr(lib, f"{name}_launch")(*args, stream)
        if rc != 0:
            why = explain(rc) if explain else None
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}"
                               + (f": {why}" if why else ""))
    counts[name] += 1


@functools.cache
def load() -> types.SimpleNamespace:
    """Build if needed, load, and declare the C entry points."""
    return bind({s: ctypes.CDLL(str(p)) for s, p in build().items()})
