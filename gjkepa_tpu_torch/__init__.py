"""gjkepa_tpu_torch: the PyTorch/CUDA port of gjkepa_tpu.

The port holds the JAX package's portable query and its four fused
queries:

  * the portable path (``api``), torch code over the support maps in
    float32 or float64: :func:`gjkepa` and :func:`gjkepa_batch` over hull
    pairs (``ops.gjk``, ``ops.epa``, ``ops.contact``, with
    :func:`derive_contact`), :func:`collide_supports` over any support map
    with the depth polish, :func:`collide_shapes_batch` and
    :func:`collide_hull_shape_batch`; the hull utilities are
    ``utils.hull``;

  * hull pairs: :func:`gjkepa_batch_fused` / :func:`derive_contact_batch`
    (``api``) over :func:`fused_gjkepa_hulls` (``ops.fused``): K1, the GJK
    hull kernel, a team of threads a pair (``csrc/gjk_hulls.cu``), then
    K2, the EPA cascade kernel (``csrc/epa_hulls.cu``), over the hit
    lanes; contact versions 1, 2 and 3 from :func:`derive_contact_rows`
    (``ops.contact_rows``); hull pairs with n1 + n2 > 4096 vertices take
    the large-hull path (``ops.fused_streamed``): K12, a warp a pair
    (``csrc/gjk_hulls_big.cu``), and K13, a block of warps a hit with the
    polytope in shared memory (``csrc/epa_hulls_big.cu``), over the team
    support K11 (``csrc/hull_stream.cuh``);
  * analytic shape pairs (:class:`ShapeBatch` of spheres, boxes, capsules
    and cylinders): :func:`collide_shapes_batch_fused` (``api``) over
    :func:`fused_gjkepa_shapes` (``ops.fused_shapes``): K5, the closed-form
    kernel (``csrc/cf_shapes.cu``), K6a or K6b, GJK (``csrc/gjk_shapes.cu``),
    and K7, the capped EPA cascade with the polish (``csrc/epa_shapes.cu``);
  * closest distance over hull pairs: :func:`fused_gjk_distance_hulls`
    (``ops.fused_distance``): K8, distance GJK with witness points
    (``csrc/distance_hulls.cu``), launched twice, the second time over the
    pairs the first left unconverged;
  * hull against analytic shape: :func:`fused_gjkepa_hull_shapes`
    (``ops.fused_hull_shapes``): K9, GJK (``csrc/gjk_hull_shape.cu``), then
    K10, the capped EPA cascade with the polish
    (``csrc/epa_hull_shape.cu``), over the hit lanes;
  * the portable distance queries :func:`gjk_distance_batch` and
    :func:`gjk_distance_shapes_batch` (``api``): torch code over the hull or
    shape support (``ops.distance``), float32 or float64;
  * contact manifolds of up to 4 points a pair from any of those queries'
    normals (``ops.manifold``, torch code): :func:`manifold_batch` over
    hull pairs, :func:`manifold_shapes_batch` over shape pairs and
    :func:`manifold_hull_shape_batch` over hull-vs-shape pairs;
  * the rigid-body sim of falling boxes (``sim``): :func:`sim.sim_step`,
    whose narrowphase on the card is K1 and K2 over the boxes' corners;
  * the pair axis split over a list of devices (``parallel``):
    ``pair_mesh``, ``shard_pairs``, the sharded portable and fused hull
    queries and the summed contact count;
  * the sanitizer (``debug``): the portable, fused and manifold queries
    under JAX's numerics checks, read back in one copy a call;
  * the entry points (``entry``): the flagship query with its
    inputs, and the sharded pipeline's dry run.

Like the JAX package's, the package does not export the last three; import
them by module.

``ShapeBatch.from_numpy`` and the shape constructors put their tensors on
the card unless the caller names another device (``device="cpu"``).

On CUDA tensors the kernels launch (built from ``csrc/`` with ``nvcc`` at
first use); on CPU tensors their plain PyTorch versions run.  Nothing
falls back from one to the other.  The package imports neither jax nor
gjkepa_tpu.
"""

from .api import (collide_hull_shape_batch, collide_shapes_batch,
                  collide_shapes_batch_fused, collide_supports,
                  derive_contact, derive_contact_batch, gjk_distance_batch,
                  gjk_distance_shapes_batch, gjkepa, gjkepa_batch,
                  gjkepa_batch_fused)
from .config import DEFAULT_CONFIG, GJKEPAConfig
from .models.shapes import (ShapeBatch, boxes, capsules, concat_shapes,
                            cylinders, spheres)
from .ops.contact_rows import derive_contact_rows
from .ops.distance import DistanceResult
from .ops.fused import (FusedResult, fused_gjk_distance_hulls,
                        fused_gjkepa_hull_shapes, fused_gjkepa_hulls,
                        fused_gjkepa_shapes)
from .ops.manifold import (ManifoldResult, manifold_batch,
                           manifold_hull_shape_batch, manifold_shapes_batch)
from .types import CollisionResult, Status

__all__ = ["gjkepa", "gjkepa_batch", "derive_contact", "collide_supports",
           "collide_shapes_batch", "collide_hull_shape_batch",
           "gjkepa_batch_fused", "derive_contact_batch", "fused_gjkepa_hulls",
           "derive_contact_rows", "collide_shapes_batch_fused",
           "fused_gjkepa_shapes", "fused_gjk_distance_hulls",
           "fused_gjkepa_hull_shapes", "gjk_distance_batch",
           "gjk_distance_shapes_batch", "DistanceResult", "ShapeBatch",
           "spheres", "boxes", "capsules", "cylinders", "concat_shapes",
           "FusedResult", "ManifoldResult", "manifold_batch",
           "manifold_shapes_batch", "manifold_hull_shape_batch",
           "GJKEPAConfig", "DEFAULT_CONFIG", "CollisionResult", "Status"]
