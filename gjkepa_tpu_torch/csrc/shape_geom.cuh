// Analytic-shape device functions of the shape kernels K5, K6a, K6b and K7.
//
// Ports, from gjkepa_tpu/ops/fused.py:
//   K3 (:1598-1659): the packed-shape support map, bounding radius and
//      broadphase (_shape_support_side, _make_shape_support, _shape_radius,
//      _shape_broadphase);
//   K4 (:1662-1864): the closed forms (_closed_form_rows, _cf_kind_mask):
//      swept-sphere segment-segment, sphere-box, sphere-cylinder and the
//      15-axis box-box SAT;
//   _polish_direction (:752-834): the tangent-grid descent run after the
//      capped EPA cascade.
// Plain PyTorch versions: gjkepa_tpu_torch/ops/shape_geom.py (K3, K4) and
// polish_direction in ops/fused_shapes.py.  Every expression keeps their
// operation order (the kernels build with --fmad=false).  Where the plain
// version computes every branch and selects by kind, a thread computes
// only its own kind's branch: the same value, without the other three.
#pragma once

#include "lane_geom.cuh"

namespace gjkepa {

constexpr float kCfBig = 3.4e38f;

// One packed shape row [kind, p0, p1, p2, pos(3), rot(9) row-major].
struct Shape {
  float kind, p0, p1, p2;
  P3 pos;
  float r00, r01, r02, r10, r11, r12, r20, r21, r22;
};

// Row `lane` of a (B, 16) float32 buffer: four 16-byte loads.
__device__ __forceinline__ Shape load_shape(const float* __restrict__ rows, int lane) {
  const float4* q = reinterpret_cast<const float4*>(rows + (size_t)lane * 16);
  const float4 a = q[0], b = q[1], c = q[2], d = q[3];
  Shape s;
  s.kind = a.x;
  s.p0 = a.y;
  s.p1 = a.z;
  s.p2 = a.w;
  s.pos = mk(b.x, b.y, b.z);
  s.r00 = b.w;
  s.r01 = c.x;
  s.r02 = c.y;
  s.r10 = c.z;
  s.r11 = c.w;
  s.r12 = d.x;
  s.r20 = d.y;
  s.r21 = d.z;
  s.r22 = d.w;
  return s;
}

// Column j of R: the world direction of local axis j.
__device__ __forceinline__ P3 rot_col(const Shape& s, int j) {
  if (j == 0) return mk(s.r00, s.r10, s.r20);
  if (j == 1) return mk(s.r01, s.r11, s.r21);
  return mk(s.r02, s.r12, s.r22);
}

// R^T d.
__device__ __forceinline__ P3 to_local(const Shape& s, P3 d) {
  return mk(s.r00 * d.x + s.r10 * d.y + s.r20 * d.z, s.r01 * d.x + s.r11 * d.y + s.r21 * d.z,
            s.r02 * d.x + s.r12 * d.y + s.r22 * d.z);
}

// R v.
__device__ __forceinline__ P3 to_world(const Shape& s, P3 v) {
  return mk(s.r00 * v.x + s.r01 * v.y + s.r02 * v.z, s.r10 * v.x + s.r11 * v.y + s.r12 * v.z,
            s.r20 * v.x + s.r21 * v.y + s.r22 * v.z);
}

__device__ __forceinline__ float safe_inv(float n) { return n > 1e-20f ? 1.0f / n : 0.0f; }

// K3: world support point of one side along d (>= on every sign test).
__device__ __forceinline__ P3 shape_support_side(const Shape& s, P3 d) {
  const P3 dl = to_local(s, d);
  P3 sl;
  if (s.kind < 0.5f) {
    sl = scale(dl, safe_inv(norm(dl)) * s.p0);
  } else if (s.kind < 1.5f) {
    sl = mk(dl.x >= 0.0f ? s.p0 : -s.p0, dl.y >= 0.0f ? s.p1 : -s.p1,
            dl.z >= 0.0f ? s.p2 : -s.p2);
  } else if (s.kind < 2.5f) {
    const P3 sph = scale(dl, safe_inv(norm(dl)) * s.p0);
    sl = mk(sph.x, sph.y, sph.z + (dl.z >= 0.0f ? s.p1 : -s.p1));
  } else {
    const float invp = safe_inv(sqrtf(dl.x * dl.x + dl.y * dl.y));
    sl = mk(s.p0 * dl.x * invp, s.p0 * dl.y * invp, dl.z >= 0.0f ? s.p1 : -s.p1);
  }
  const P3 w = to_world(s, sl);
  return mk(w.x + s.pos.x, w.y + s.pos.y, w.z + s.pos.z);
}

// K3: the Minkowski support over a pair, as the functor of gjk_core.cuh /
// epa_core.cuh.
struct ShapeSupport {
  Shape a, b;
  __device__ __forceinline__ P3 operator()(P3 d) const {
    return sub(shape_support_side(a, d), shape_support_side(b, neg(d)));
  }
};

// K3: conservative bounding radius.
__device__ __forceinline__ float shape_radius(const Shape& s) {
  if (s.kind < 0.5f) return s.p0;
  if (s.kind < 1.5f) return sqrtf(s.p0 * s.p0 + s.p1 * s.p1 + s.p2 * s.p2);
  return s.p0 + s.p1;
}

__device__ __forceinline__ bool shape_broadphase(const Shape& a, const Shape& b, float tol) {
  return norm(sub(a.pos, b.pos)) <= shape_radius(a) + shape_radius(b) + tol;
}

// K4: the pair kinds with a closed form.
__device__ __forceinline__ bool cf_kind_mask(float k1, float k2) {
  const bool is_ss1 = k1 < 0.5f || (k1 > 1.5f && k1 < 2.5f);
  const bool is_ss2 = k2 < 0.5f || (k2 > 1.5f && k2 < 2.5f);
  const bool s_b = k1 < 0.5f && fabsf(k2 - 1.0f) < 0.5f;
  const bool b_s = fabsf(k1 - 1.0f) < 0.5f && k2 < 0.5f;
  const bool s_c = k1 < 0.5f && k2 > 2.5f;
  const bool c_s = k1 > 2.5f && k2 < 0.5f;
  const bool b_b = fabsf(k1 - 1.0f) < 0.5f && fabsf(k2 - 1.0f) < 0.5f;
  return (is_ss1 && is_ss2) || s_b || b_s || s_c || c_s || b_b;
}

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float signf(float c) { return c >= 0.0f ? 1.0f : -1.0f; }

struct CfPart {
  float depth;
  P3 n;
  float gap;
};

// Sphere (centre c, radius r) against a box: point-box clamp.
__device__ __forceinline__ CfPart sphere_vs_box(P3 c, float r, const Shape& box) {
  const P3 dl = to_local(box, sub(c, box.pos));
  const float hx = box.p0, hy = box.p1, hz = box.p2;
  const P3 delta = sub(dl, mk(clipf(dl.x, -hx, hx), clipf(dl.y, -hy, hy), clipf(dl.z, -hz, hz)));
  const float d_out = norm(delta);
  CfPart o;
  P3 nl;
  if (d_out > 1e-12f) {
    nl = scale(delta, -1.0f / fmaxf(d_out, 1e-20f));
    o.depth = r - d_out;
  } else {
    const float penx = hx - fabsf(dl.x), peny = hy - fabsf(dl.y), penz = hz - fabsf(dl.z);
    const bool ax_x = penx <= peny && penx <= penz;
    const bool ax_y = !ax_x && peny <= penz;
    const bool ax_z = !ax_x && !ax_y;
    nl = mk(-(ax_x ? signf(dl.x) : 0.0f), -(ax_y ? signf(dl.y) : 0.0f),
            -(ax_z ? signf(dl.z) : 0.0f));
    o.depth = r + fminf(penx, fminf(peny, penz));
  }
  o.n = to_world(box, nl);
  o.gap = fmaxf(d_out - r, 0.0f);
  return o;
}

// Sphere against a solid cylinder.
__device__ __forceinline__ CfPart sphere_vs_cyl(P3 c, float r, const Shape& cyl) {
  const float rc = cyl.p0, hc = cyl.p1;
  const P3 dl = to_local(cyl, sub(c, cyl.pos));
  const float rho = sqrtf(dl.x * dl.x + dl.y * dl.y);
  const float inv_rho = 1.0f / fmaxf(rho, 1e-20f);
  // exactly 1.0 inside (clip semantics, fused.py:1770-1772)
  const float sc = rho > rc ? rc * inv_rho : 1.0f;
  const P3 delta = mk(dl.x - dl.x * sc, dl.y - dl.y * sc, dl.z - clipf(dl.z, -hc, hc));
  const float d_out = norm(delta);
  CfPart o;
  P3 nl;
  if (d_out > 1e-12f) {
    nl = scale(delta, -1.0f / fmaxf(d_out, 1e-20f));
    o.depth = r - d_out;
  } else {
    const float pen_lat = rc - rho, pen_cap = hc - fabsf(dl.z);
    const bool use_lat = pen_lat <= pen_cap;
    const float lx = rho > 1e-12f ? dl.x * inv_rho : 1.0f;
    const float ly = rho > 1e-12f ? dl.y * inv_rho : 0.0f;
    nl = mk(use_lat ? -lx : 0.0f, use_lat ? -ly : 0.0f, use_lat ? 0.0f : -signf(dl.z));
    o.depth = r + fminf(pen_lat, pen_cap);
  }
  o.n = to_world(cyl, nl);
  o.gap = fmaxf(d_out - r, 0.0f);
  return o;
}

// Box-box SAT over the 15 axes: ax(3), bx(3), cross(ax_i, bx_j) i-major;
// the strict < keeps the first minimal axis.  Unrolled, every axis index
// is a constant and ax, bx stay in registers (rolled, they took a 72-byte
// stack frame).
__device__ __forceinline__ CfPart box_box_sat(const Shape& a, const Shape& b) {
  P3 ax[3], bx[3];
  for (int j = 0; j < 3; ++j) {
    ax[j] = rot_col(a, j);
    bx[j] = rot_col(b, j);
  }
  const P3 t = sub(b.pos, a.pos);
  float best = kCfBig, sep = -kCfBig;
  P3 bn = mk(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < 15; ++k) {
    const P3 L = k < 3 ? ax[k] : (k < 6 ? bx[k - 3] : cross(ax[(k - 6) / 3], bx[(k - 6) % 3]));
    const float ln2 = dot(L, L);
    const bool valid = ln2 > 1e-12f;
    const float inv = 1.0f / sqrtf(valid ? ln2 : 1.0f);
    const float s = dot(t, L) * inv;
    const float ra = (a.p0 * fabsf(dot(ax[0], L)) + a.p1 * fabsf(dot(ax[1], L)) +
                      a.p2 * fabsf(dot(ax[2], L))) * inv;
    const float rb = (b.p0 * fabsf(dot(bx[0], L)) + b.p1 * fabsf(dot(bx[1], L)) +
                      b.p2 * fabsf(dot(bx[2], L))) * inv;
    const float ov = ra + rb - fabsf(s);
    sep = fmaxf(sep, valid ? -ov : -kCfBig);
    const float ovv = valid ? ov : kCfBig;
    if (ovv < best) {
      best = ovv;
      bn = scale(L, inv * signf(s));
    }
  }
  CfPart o;
  o.depth = best;
  o.n = bn;
  o.gap = fmaxf(sep, 0.0f);
  return o;
}

struct ClosedForm {
  bool final;    // the pair kind has a closed form
  float depth;   // 0 unless a closed-form hit
  P3 normal;     // A -> B, zero unless a closed-form hit
  float gap;     // separation (closed-form lanes only)
  int status;    // closed-form lanes only
};

// K4: the exact answer for the pair kinds with closed forms.
__device__ __forceinline__ ClosedForm closed_form(const Shape& a, const Shape& b, float tol) {
  const float k1 = a.kind, k2 = b.kind;
  const bool is_ss1 = k1 < 0.5f || (k1 > 1.5f && k1 < 2.5f);
  const bool is_ss2 = k2 < 0.5f || (k2 > 1.5f && k2 < 2.5f);
  const bool s_b = k1 < 0.5f && fabsf(k2 - 1.0f) < 0.5f;
  const bool b_s = fabsf(k1 - 1.0f) < 0.5f && k2 < 0.5f;
  const bool s_c = k1 < 0.5f && k2 > 2.5f;
  const bool c_s = k1 > 2.5f && k2 < 0.5f;
  const bool b_b = fabsf(k1 - 1.0f) < 0.5f && fabsf(k2 - 1.0f) < 0.5f;
  ClosedForm o;
  o.final = (is_ss1 && is_ss2) || s_b || b_s || s_c || c_s || b_b;
  CfPart p;
  p.depth = 0.0f;
  p.n = mk(0.0f, 0.0f, 0.0f);
  p.gap = 0.0f;
  if (is_ss1 && is_ss2) {
    // swept-sphere pair: segment-segment closest points, clamps s -> t -> s
    const float l1 = (k1 > 1.5f && k1 < 2.5f) ? a.p1 : 0.0f;
    const float l2 = (k2 > 1.5f && k2 < 2.5f) ? b.p1 : 0.0f;
    const P3 u1 = rot_col(a, 2), u2 = rot_col(b, 2);
    const P3 rv = sub(a.pos, b.pos);
    const float bb = dot(u1, u2), cc = dot(u1, rv), ff = dot(u2, rv);
    const float den = 1.0f - bb * bb;
    const float s0 = den > 1e-12f ? (ff * bb - cc) / den : 0.0f;
    float s = clipf(s0, -l1, l1);
    const float t = clipf(s * bb + ff, -l2, l2);
    s = clipf(t * bb - cc, -l1, l1);
    const P3 dvec = sub(add(b.pos, scale(u2, t)), add(a.pos, scale(u1, s)));
    const float dist = norm(dvec);
    const float inv = 1.0f / fmaxf(dist, 1e-20f);
    p.n = dist > 1e-12f ? scale(dvec, inv) : mk(0.0f, 0.0f, 1.0f);
    p.depth = a.p0 + b.p0 - dist;
    p.gap = dist - (a.p0 + b.p0);
  } else if (s_b) {
    p = sphere_vs_box(a.pos, a.p0, b);
  } else if (b_s) {
    p = sphere_vs_box(b.pos, b.p0, a);
    p.n = neg(p.n);
  } else if (s_c) {
    p = sphere_vs_cyl(a.pos, a.p0, b);
  } else if (c_s) {
    p = sphere_vs_cyl(b.pos, b.p0, a);
    p.n = neg(p.n);
  } else if (b_b) {
    p = box_box_sat(a, b);
  }
  const bool hit = o.final && p.depth > 0.0f;
  o.depth = hit ? p.depth : 0.0f;
  o.normal = hit ? p.n : mk(0.0f, 0.0f, 0.0f);
  o.gap = p.gap;
  o.status = hit ? kHit : (p.gap > tol ? kMissBroadphase : kMissGjk);
  return o;
}

// _polish_direction with promote_capacity=True for one active lane: 6
// rounds x 8 ring probes of h(d) = <support(d), d> on the tangent grid
// around the normal; the ring skips the centre, and the step shrinks by 1/3
// after each round's 8th probe (POLISH_ROUNDS, POLISH_SPREAD and
// POLISH_SHRINK of ops/fused_shapes.py).  A lane whose normal is not unit
// (a degenerate EPA exit) passes through untouched.
template <class Support>
__device__ __forceinline__ void polish_direction(const Support& support, float* depth, P3* normal,
                                                 int* status) {
  const P3 n = *normal;
  if (!(norm(n) > 0.5f)) return;
  const bool small_x = fabsf(n.x) < 0.9f;
  const P3 u = utz(cross(n, mk(small_x ? 1.0f : 0.0f, small_x ? 0.0f : 1.0f, 0.0f)), 1e-20f);
  const P3 v = cross(n, u);
  auto dir_at = [&](float a, float b) {
    // |n + a u + b v|^2 = 1 + a^2 + b^2 exactly (orthonormal frame)
    const float inv = 1.0f / sqrtf(1.0f + a * a + b * b);
    return mk((n.x + a * u.x + b * v.x) * inv, (n.y + a * u.y + b * v.y) * inv,
              (n.z + a * u.z + b * v.z) * inv);
  };
  float a0 = 0.0f, b0 = 0.0f, step = 0.45f;
  P3 d = dir_at(a0, b0);
  float best_h = dot(support(d), d);
  for (int r = 0; r < 48; ++r) {
    const int k = r % 8;
    const int k2 = k + (k >= 4 ? 1 : 0);
    const float aa = a0 + (float)(k2 / 3 - 1) * step;
    const float bb = b0 + (float)(k2 % 3 - 1) * step;
    d = dir_at(aa, bb);
    const float hh = dot(support(d), d);
    if (hh < best_h) {
      best_h = hh;
      a0 = aa;
      b0 = bb;
    }
    if (k == 7) step = step * (1.0f / 3.0f);
  }
  *depth = best_h;
  *normal = dir_at(a0, b0);
  *status = kHit;
}

}  // namespace gjkepa
