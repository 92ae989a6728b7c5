"""Rigid-body mini-sim: falling boxes.

Port of ``gjkepa_tpu/sim/rigid.py``.  One :func:`sim_step` runs on the
device of the state (on the card with no host read of its own):

  * gravity;
  * the sweep-and-prune broadphase over each box's bounding sphere
    (:func:`swept_candidate_pairs`: fixed-capacity pairs, overflow
    reported);
  * the narrowphase over the candidate pairs.  On CUDA tensors the boxes
    enter the hull kernels K1 (GJK) and K2 (EPA) as their 8 world corners
    (:func:`fused_gjkepa_hulls`); on CPU tensors the portable GJK and EPA
    run over the analytic box supports, as the JAX package does off the
    TPU.  No path falls back to the other;
  * up-to-4-point manifolds on the first ``k_man`` contact rows through the
    public :func:`manifold_shapes_batch` (contacts beyond keep the single
    narrowphase point, and ``manifold_overflow`` says so);
  * the deepest corner of each box against the ground plane;
  * ``solver_iters`` Jacobi iterations of sequential impulses with a
    Baumgarte bias and Coulomb friction, pair values read by index gathers
    and body sums written with ``index_add_``;
  * semi-implicit Euler integration.

On CUDA, ``index_add_`` adds in no fixed order, so a step on the card
matches the same step on the CPU within rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GJKEPAConfig
from ..models.shapes import BOX, ShapeBatch, make_shape_pair_support
from ..ops.broadphase import swept_candidate_pairs
from ..ops.epa import run_epa
from ..ops.fused import fused_gjkepa_hulls
from ..ops.geom import cross3, dot3, norm3
from ..ops.gjk import run_gjk
from ..ops.lane_geom import fsqrt
from ..ops.manifold import manifold_shapes_batch

__all__ = ["SimState", "SimConfig", "init_boxes", "sim_step", "quat_to_mat",
           "quat_integrate"]

# box corner signs, (sx, sy, sz) with sx outermost
_SIGNS = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
          for sz in (-1.0, 1.0)]


class SimState(NamedTuple):
    pos: torch.Tensor       # (N, 3)
    quat: torch.Tensor      # (N, 4) (w, x, y, z)
    vel: torch.Tensor       # (N, 3)
    angvel: torch.Tensor    # (N, 3)
    half: torch.Tensor      # (N, 3) box half extents


class SimConfig(NamedTuple):
    dt: float = 1.0 / 60.0
    gravity: float = -9.81
    max_pairs: int = 8192
    bp_window: int = 64          # sweep-and-prune neighbour window
    solver_iters: int = 4
    baumgarte: float = 0.2
    restitution: float = 0.0
    friction: float = 0.4
    ground_z: float = 0.0


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations of (N, 4) unit quaternions (w, x, y, z)."""
    w, x, y, z = q.unbind(1)
    rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    return torch.stack([torch.stack(r, 1) for r in rows], 1)


def quat_integrate(q: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """q' = q + dt/2 (0, w) q, renormalised (semi-implicit), row by row."""
    qw, qx, qy, qz = q.unbind(1)
    wx, wy, wz = w.unbind(1)
    dq = 0.5 * torch.stack([-wx * qx - wy * qy - wz * qz,
                            wx * qw + wy * qz - wz * qy,
                            -wx * qz + wy * qw + wz * qx,
                            wx * qy - wy * qx + wz * qw], 1)
    qn = q + dt * dq
    nrm = fsqrt(qn[:, 0] * qn[:, 0] + qn[:, 1] * qn[:, 1]
                + qn[:, 2] * qn[:, 2] + qn[:, 3] * qn[:, 3])
    return qn / nrm[:, None]


def init_boxes(n: int, seed: int = 0, spread: float = 12.0,
               height: float = 10.0, dtype=torch.float32,
               device="cuda") -> SimState:
    """n boxes in a jittered grid above the ground plane, on ``device``
    (the card unless the caller names another).  The grid is the smallest
    cube of side s with s^3 >= n, spacing ``spread / s``; positions
    jittered by U(-0.2, 0.2) * 0.3 spacing, half extents 0.5 * U(0.8,
    1.2), velocities U(-0.5, 0.5), all drawn from a CPU generator seeded
    with ``seed``, so a seed gives the same boxes on every device.  (The
    JAX package draws from ``jax.random``: the two packages' boxes
    differ.)"""
    gen = torch.Generator().manual_seed(seed)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype)

    side = 1
    while side ** 3 < n:
        side += 1
    idx = torch.arange(n)
    spacing = spread / side
    pos = torch.stack([((idx % side).to(dtype) - side / 2) * spacing,
                       (((idx // side) % side).to(dtype) - side / 2) * spacing,
                       (idx // (side * side)).to(dtype) * spacing + height], 1)
    pos = pos + uniform((n, 3), -0.2, 0.2) * spacing * 0.3
    quat = torch.zeros((n, 4), dtype=dtype)
    quat[:, 0] = 1.0
    half = torch.full((n, 3), 0.5, dtype=dtype) * uniform((n, 1), 0.8, 1.2)
    vel = uniform((n, 3), -0.5, 0.5)
    return SimState(*(t.to(device) for t in (pos, quat, vel,
                                             torch.zeros((n, 3), dtype=dtype),
                                             half)))


def _boxes(state: SimState, rot, idx) -> ShapeBatch:
    kind = torch.full(idx.shape, BOX, dtype=torch.int32, device=idx.device)
    return ShapeBatch(kind, state.half[idx], state.pos[idx], rot[idx])


def _corners(state: SimState, rot, idx) -> torch.Tensor:
    """(P, 8, 3) world corners R (s h) + t of the boxes ``idx``, each sum
    left to right (elementwise, so every device rounds alike)."""
    signs = torch.tensor(_SIGNS, dtype=state.half.dtype,
                         device=state.half.device)
    local = signs[None] * state.half[idx][:, None, :]
    r = rot[idx][:, None]
    t = state.pos[idx][:, None]
    return torch.stack([r[..., i, 0] * local[..., 0] + r[..., i, 1] * local[..., 1]
                        + r[..., i, 2] * local[..., 2] + t[..., i]
                        for i in range(3)], -1)


def _pair_contacts_portable(state: SimState, rot, pairs, valid,
                            cfg: GJKEPAConfig):
    """The portable narrowphase: GJK over the valid candidates and EPA over
    their hits (torch code, each lane on its own, so running only those
    lanes changes no result), over the analytic box pair supports, with
    depth and normal zero on the other lanes as EPA leaves them; the
    contact point is the witnesses' midpoint along the normal.  Returns
    (hit, depth, normal, point)."""
    def support(lanes):
        return make_shape_pair_support(
            _boxes(state, rot, pairs[lanes, 0].long()),
            _boxes(state, rot, pairs[lanes, 1].long()))

    lanes = valid.nonzero()[:, 0]
    g = run_gjk(support(lanes), cfg, torch.ones_like(lanes, dtype=torch.bool),
                dtype=state.pos.dtype)
    hits = lanes[g.hit]
    e = run_epa(support(hits), g.simplex[g.hit],
                torch.ones_like(hits, dtype=torch.bool), cfg)
    p = valid.shape[0]
    hit = torch.zeros_like(valid).index_fill_(0, hits, True)
    depth = e.depth.new_zeros(p).index_copy_(0, hits, e.depth)
    normal = e.normal.new_zeros((p, 3)).index_copy_(0, hits, e.normal)
    s = support(slice(None))(normal)
    return hit, depth, normal, 0.5 * (s.a + s.b)


def _pair_contacts_fused(state: SimState, rot, pairs, valid,
                         cfg: GJKEPAConfig):
    """The hull kernels' narrowphase: each box as its 8 world corners
    through :func:`fused_gjkepa_hulls` (K1, K2 on CUDA tensors, their plain
    versions on CPU tensors); the contact point is the midpoint of the
    analytic box supports along the EPA normal.  Returns (hit, depth,
    normal, point)."""
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    # invalid candidates, the self-pairs (i, i) among them, would be deep
    # hits that grind through EPA: moved out of broadphase range, they
    # retire in K1
    displace = torch.where(valid, 0.0, 4e4).to(state.pos.dtype)[:, None, None]
    res = fused_gjkepa_hulls(_corners(state, rot, i),
                             _corners(state, rot, j) + displace, cfg=cfg)
    s = make_shape_pair_support(_boxes(state, rot, i),
                                _boxes(state, rot, j))(res.normal)
    return res.hit & valid, res.depth, res.normal, 0.5 * (s.a + s.b)


def _matvec(m, v):
    """(N, 3): m (N, 3, 3) times v (N, 3), row by row."""
    return torch.stack([dot3(m[:, i], v) for i in range(3)], 1)


def _ang_term(inv_i, r, d):
    """c . I^-1 c with c = r x d: the angular part of the effective mass
    along d at offset r."""
    c = cross3(r, d)
    return dot3(c, _matvec(inv_i, c))


def sim_step(state: SimState, scfg: SimConfig = SimConfig(),
             cfg: GJKEPAConfig | None = None) -> tuple[SimState, dict]:
    """One physics step on the state's device.  Returns (new state,
    diagnostics): ``n_candidates``, ``candidate_overflow``,
    ``manifold_overflow``, ``n_contacts``, ``n_ground`` and ``max_depth``,
    as 0-d tensors.  CUDA states take the hull kernels' narrowphase, CPU
    states the portable one; any other device raises."""
    cfg = cfg or GJKEPAConfig.for_f32()
    kind = state.pos.device.type
    if kind == "cuda":
        return _step(state, scfg, cfg, _pair_contacts_fused)
    if kind == "cpu":
        return _step(state, scfg, cfg, _pair_contacts_portable)
    raise ValueError(f"no sim narrowphase for device {state.pos.device}")


def _step(state: SimState, scfg: SimConfig, cfg: GJKEPAConfig,
          pair_contacts) -> tuple[SimState, dict]:
    """:func:`sim_step` over the narrowphase ``pair_contacts``."""
    n = state.pos.shape[0]
    dtype, dev = state.pos.dtype, state.pos.device
    dt = torch.tensor(scfg.dt, dtype=dtype, device=dev)
    first = torch.arange(4, device=dev) == 0

    vel = state.vel + torch.tensor([0.0, 0.0, scfg.gravity], dtype=dtype,
                                   device=dev) * dt
    angvel = state.angvel
    rot = quat_to_mat(state.quat)

    # -- broadphase and narrowphase --------------------------------------------
    pairs, valid, n_cand, bp_overflow = swept_candidate_pairs(
        state.pos, norm3(state.half), max_pairs=scfg.max_pairs,
        window=scfg.bp_window, inflate=0.5)
    hit, depth, normal, point = pair_contacts(state, rot, pairs, valid, cfg)
    contact = hit & valid

    # -- manifolds on the first k_man contacts ------------------------------------
    # a stable contacts-first order; contacts beyond k_man keep the single
    # narrowphase point
    n_pairs = pairs.shape[0]
    k_man = min(n_pairs, max(scfg.max_pairs // 4, 128))
    hit_i = contact.long()
    n_hit = hit_i.sum()
    dest = torch.where(contact, torch.cumsum(hit_i, 0) - 1,
                       n_hit + torch.cumsum(1 - hit_i, 0) - 1)
    order = torch.empty_like(dest).scatter_(
        0, dest, torch.arange(n_pairs, device=dev))
    take = order[:k_man]
    i_c, j_c = pairs[take, 0].long(), pairs[take, 1].long()
    mf = manifold_shapes_batch(_boxes(state, rot, i_c), _boxes(state, rot, j_c),
                               normal[take], depth[take], contact[take],
                               point[take], cfg=cfg, poly_cap=4)
    dc = torch.clamp(dest, max=k_man - 1)
    in_k = contact & (dest < k_man)
    mpoints = torch.where(in_k[:, None, None], mf.points[dc],
                          point[:, None, :])
    mdepths = torch.where(in_k[:, None], mf.depths[dc],
                          depth[:, None] * first.to(dtype))
    mmask = torch.where(in_k[:, None], mf.mask[dc],
                        first[None, :] & contact[:, None]) & valid[:, None]

    # -- ground contacts: the deepest corner of each box ---------------------------
    corners = _corners(state, rot, torch.arange(n, device=dev))
    k = torch.argmin(corners[..., 2], dim=1)
    g_point = torch.gather(corners, 1, k[:, None, None].expand(-1, 1, 3))[:, 0]
    pen = scfg.ground_z - g_point[:, 2]
    g_hit = pen > 0
    g_pen = torch.clamp(pen, min=0.0)

    # -- sequential impulses --------------------------------------------------------
    h = state.half
    inv_mass = 1.0 / (8.0 * h[:, 0] * h[:, 1] * h[:, 2])
    # box inertia, diagonal in the body frame, I_k = m/12 sum_{j != k}
    # (2 h_j)^2; its world-frame inverse R diag(1 / I) R^T
    ext2 = (2 * h) ** 2
    i_body = ((1.0 / inv_mass)[:, None] / 12.0
              * ((ext2[:, 0:1] + ext2[:, 1:2] + ext2[:, 2:3]) - ext2))
    inv_ib = 1.0 / i_body
    inv_iw = torch.stack([torch.stack([
        rot[:, a, 0] * inv_ib[:, 0] * rot[:, b, 0]
        + rot[:, a, 1] * inv_ib[:, 1] * rot[:, b, 1]
        + rot[:, a, 2] * inv_ib[:, 2] * rot[:, b, 2] for b in range(3)], 1)
        for a in range(3)], 1)

    i_idx, j_idx = pairs[:, 0].long(), pairs[:, 1].long()
    bias = scfg.baumgarte / dt
    pos_i, pos_j = state.pos[i_idx], state.pos[j_idx]
    invm_i, invm_j = inv_mass[i_idx], inv_mass[j_idx]
    inv_i, inv_j = inv_iw[i_idx], inv_iw[j_idx]

    def body_sum(idx, pair_vals):            # (P, 3) -> (N, 3)
        return torch.zeros_like(state.pos).index_add_(0, idx, pair_vals)

    # restitution targets from the pre-solve approach velocities (post-solve
    # separation = e * approach speed), per manifold point
    vel_i0, vel_j0 = vel[i_idx], vel[j_idx]
    av_i0, av_j0 = angvel[i_idx], angvel[j_idx]
    rest_pair = []
    for s in range(4):
        ra0 = mpoints[:, s] - pos_i
        rb0 = mpoints[:, s] - pos_j
        rel0 = (vel_j0 + cross3(av_j0, rb0) - vel_i0 - cross3(av_i0, ra0))
        rest_pair.append(scfg.restitution
                         * torch.clamp(-dot3(rel0, normal), min=0.0))
    rg = g_point - state.pos
    vn_g0 = (vel + cross3(angvel, rg))[:, 2]
    rest_ground = scfg.restitution * torch.clamp(-vn_g0, min=0.0)
    zhat = torch.zeros_like(rg)
    zhat[:, 2] = 1.0
    k_g = inv_mass + _ang_term(inv_iw, rg, zhat)

    for _ in range(scfg.solver_iters):
        vel_i, vel_j = vel[i_idx], vel[j_idx]
        av_i, av_j = angvel[i_idx], angvel[j_idx]
        # pair contacts, up to 4 points a pair, Jacobi within the
        # iteration: impulses from the iteration-start velocities, applied
        # together
        imp_sum = torch.zeros_like(normal)         # total impulse on body B
        tau_a = torch.zeros_like(normal)           # total torque on body A
        tau_b = torch.zeros_like(normal)
        for s in range(4):
            cmask = mmask[:, s]
            ra = mpoints[:, s] - pos_i
            rb = mpoints[:, s] - pos_j
            # the normal points from A to B: the impulse pushes B along it
            rel = (vel_j + cross3(av_j, rb)) - (vel_i + cross3(av_i, ra))
            vn = dot3(rel, normal)
            k_n = (invm_i + invm_j + _ang_term(inv_i, ra, normal)
                   + _ang_term(inv_j, rb, normal))
            # velocity bias max(Baumgarte, restitution): their sum would
            # inject energy
            jn = ((-vn + torch.maximum(bias * mdepths[:, s], rest_pair[s]))
                  / torch.clamp(k_n, min=1e-6))
            jn = torch.where(cmask, torch.clamp(jn, min=0.0), 0.0)
            # Coulomb friction on the tangential relative velocity
            vt_rel = rel - vn[:, None] * normal
            vt_n = norm3(vt_rel)
            jt = torch.where(cmask,
                             torch.minimum(vt_n / torch.clamp(k_n, min=1e-6),
                                           scfg.friction * jn), 0.0)
            t_dir = -vt_rel / torch.clamp(vt_n, min=1e-6)[:, None]
            imp_all = jn[:, None] * normal + jt[:, None] * t_dir
            imp_sum = imp_sum + imp_all
            tau_a = tau_a + cross3(ra, -imp_all)
            tau_b = tau_b + cross3(rb, imp_all)
        dv = body_sum(j_idx, imp_sum) - body_sum(i_idx, imp_sum)
        dtau = body_sum(i_idx, tau_a) + body_sum(j_idx, tau_b)
        vel = vel + dv * inv_mass[:, None]
        angvel = angvel + _matvec(inv_iw, dtau)

        # ground contacts: a static plane, normal +z
        vg = vel + cross3(angvel, rg)
        jg = torch.where(g_hit, torch.clamp(
            -vg[:, 2] + torch.maximum(bias * g_pen, rest_ground), min=0.0)
            / torch.clamp(k_g, min=1e-6), 0.0)
        imp_g = jg[:, None] * zhat
        vel = vel + imp_g * inv_mass[:, None]
        angvel = angvel + _matvec(inv_iw, cross3(rg, imp_g))
        # ground friction, the tangential clamp
        vt = torch.where(zhat > 0, 0.0, vg)
        vt_norm = norm3(vt)
        jt = torch.where(g_hit,
                         torch.minimum(vt_norm / torch.clamp(k_g, min=1e-6),
                                       scfg.friction * jg), 0.0)
        imp_t = jt[:, None] * (-vt / torch.clamp(vt_norm, min=1e-6)[:, None])
        vel = vel + imp_t * inv_mass[:, None]
        angvel = angvel + _matvec(inv_iw, cross3(rg, imp_t))

    diag = {
        "n_candidates": n_cand,
        "candidate_overflow": bp_overflow,
        "manifold_overflow": n_hit > k_man,
        "n_contacts": contact.sum(dtype=torch.int32),
        "n_ground": g_hit.sum(dtype=torch.int32),
        "max_depth": torch.where(contact, depth, 0.0).amax(),
    }
    return SimState(state.pos + vel * dt, quat_integrate(state.quat, angvel, dt),
                    vel, angvel, state.half), diag
