// The hull-vs-shape support of the mixed kernels K9 and K10.
//
// Ports _make_hull_shape_support (gjkepa_tpu/ops/fused.py:2544).  Plain
// PyTorch version: make_hull_shape_support in
// gjkepa_tpu_torch/ops/fused_hull_shapes.py.  K9 (gjk_hull_shape.cu) calls
// it with a team of T = 4-32 threads a pair, K10 (epa_hull_shape.cu) with a
// warp (T = 32).
#pragma once

#include "hull_stream.cuh"
#include "shape_geom.cuh"

namespace gjkepa {

// Side A a row-major (N, 3) hull, its first maximum of <v, d> scanned by
// the T threads of the calling team (strided_first_max, then the team's
// (value, index) shuffles: ties go to the smaller index, the serial scan's
// and torch.argmax's vertex); side B one packed analytic shape, its support
// along -d, which every thread evaluates to the same point.  The functor of
// gjk_core.cuh and epa_warp.cuh; every thread of the team calls it with the
// same direction.
template <int T>
struct TeamHullShapeSupport {
  const float* v1;
  int n1;
  Shape b;
  __device__ __forceinline__ P3 operator()(P3 d) const {
    float best;
    int idx;
    strided_first_max<false, T>(v1, n1, d, threadIdx.x & (T - 1), &best, &idx);
    team_reduce_first_max<T>(team_mask<T>(), &best, &idx);
    return sub(vertex(v1, idx), shape_support_side(b, neg(d)));
  }
};

}  // namespace gjkepa
