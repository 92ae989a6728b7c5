"""gjkepa_tpu_torch: the PyTorch/CUDA port of gjkepa_tpu.

This slice ports the fused hull-pair query, the reference's main path:

  * :func:`gjkepa_batch_fused` / :func:`derive_contact_batch` (``api``);
  * :func:`fused_gjkepa_hulls` (``ops.fused``): K1, the GJK hull kernel
    (``csrc/gjk_hulls.cu``), then K2, the EPA cascade kernel
    (``csrc/epa_hulls.cu``), over the hit lanes;
  * :func:`derive_contact_rows` (``ops.contact_rows``): contact versions
    1, 2 and 3.

On CUDA tensors the kernels launch (built from ``csrc/`` with ``nvcc`` at
first use); on CPU tensors their plain PyTorch versions run.  Nothing
falls back from one to the other.  The package imports neither jax nor
gjkepa_tpu.
"""

from .api import derive_contact_batch, gjkepa_batch_fused
from .config import DEFAULT_CONFIG, GJKEPAConfig
from .ops.contact_rows import derive_contact_rows
from .ops.fused import FusedResult, fused_gjkepa_hulls
from .types import CollisionResult, Status

__all__ = ["gjkepa_batch_fused", "derive_contact_batch", "fused_gjkepa_hulls",
           "derive_contact_rows", "FusedResult", "GJKEPAConfig",
           "DEFAULT_CONFIG", "CollisionResult", "Status"]
