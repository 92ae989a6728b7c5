// The hull-vs-shape support of the mixed kernels K9 and K10.
//
// Ports _make_hull_shape_support (gjkepa_tpu/ops/fused.py:2544) and
// _hull_shape_broadphase (:2561).  Plain PyTorch versions:
// make_hull_shape_support and hull_shape_broadphase in
// gjkepa_tpu_torch/ops/fused_hull_shapes.py.
#pragma once

#include "shape_geom.cuh"

namespace gjkepa {

// Side A a row-major (N, 3) hull (its first maximum of <v, d>), side B one
// packed analytic shape (its support along -d): the functor of gjk_core.cuh
// and epa_core.cuh.
struct HullShapeSupport {
  const float* v1;
  int n1;
  Shape b;
  __device__ __forceinline__ P3 operator()(P3 d) const {
    return sub(vertex(v1, first_max_vertex<false>(v1, n1, d)), shape_support_side(b, neg(d)));
  }
};

// The hull's bounding sphere against the shape's bounding radius.
__device__ __forceinline__ bool hull_shape_broadphase(const float* __restrict__ v1, int n1,
                                                      const Shape& b, float tol) {
  P3 c1;
  float r1;
  bounding_sphere(v1, n1, &c1, &r1);
  return norm(sub(c1, b.pos)) <= r1 + shape_radius(b) + tol;
}

}  // namespace gjkepa
