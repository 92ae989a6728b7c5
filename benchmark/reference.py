"""Plain float64 references the benchmark judges the program by.

* :func:`hull_distance`: the closest distance between two convex vertex
  hulls, with witness points, lane by lane in float64 PyTorch.  GJK's
  distance loop (Gilbert, Johnson and Keerthi, 1988) with a brute-force
  sub-simplex solver: every non-empty subset of the current simplex is
  projected onto its affine hull and the valid projection nearest the origin
  wins, so no case analysis can go wrong.  A pair whose difference contains
  the origin reads distance 0 and ``intersecting``.
* :func:`oracle_rows`: the frozen float64 transliteration of the Fortran
  query (:mod:`benchmark.oracle`), run pair by pair over sampled lanes: hit,
  depth, normal, contact point and nearest points.
* :func:`to_bf16`: the control's rounding, a tensor's values rounded to
  bfloat16 and back.

Nothing here imports the program under test.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from . import oracle

DIST_MAX_ITERS = 128
DIST_REL_TOL = 1e-13     # stop once v.v - v.w <= DIST_REL_TOL * v.v ...
DIST_ROUND_TOL = 1e-13   # ... + DIST_ROUND_TOL * |v| |w|, its rounding
ZERO_SQ = 1e-26          # |v|^2 below this: the origin is on the hull

# every non-empty subset of the 4 simplex slots
_SUBSETS = [list(c) for k in range(1, 5)
            for c in itertools.combinations(range(4), k)]


def to_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and back to its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _support(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The first vertex of each hull ``p`` (L, N, 3) furthest along ``d``
    (L, 3)."""
    i = torch.argmax(torch.einsum("lnk,lk->ln", p, d), dim=1)
    return p[torch.arange(p.shape[0], device=p.device), i]


def _solve(g, r):
    """Solve the symmetric (L, m, m) systems ``g mu = r`` (m <= 3) by
    Cramer's rule.  Returns (mu (L, m), det (L,))."""
    m = g.shape[1]
    if m == 1:
        det = g[:, 0, 0]
        return r / det[:, None], det
    if m == 2:
        a, b, d = g[:, 0, 0], g[:, 0, 1], g[:, 1, 1]
        det = a * d - b * b
        return torch.stack([r[:, 0] * d - r[:, 1] * b,
                            a * r[:, 1] - b * r[:, 0]], 1) / det[:, None], det
    a, b, c = g[:, 0, 0], g[:, 0, 1], g[:, 0, 2]
    d, e, f = g[:, 1, 1], g[:, 1, 2], g[:, 2, 2]
    c00, c01, c02 = d * f - e * e, c * e - b * f, b * e - c * d
    c11, c12, c22 = a * f - c * c, b * c - a * e, a * d - b * b
    det = a * c00 + b * c01 + c * c02
    adj = torch.stack([torch.stack([c00, c01, c02], 1),
                       torch.stack([c01, c11, c12], 1),
                       torch.stack([c02, c12, c22], 1)], 1)
    return (adj @ r[:, :, None])[..., 0] / det[:, None], det


def _closest(w: torch.Tensor, used: torch.Tensor):
    """The point of conv(w[used]) nearest the origin, for each lane.

    ``w`` (L, 4, 3), ``used`` (L, 4) bool.  Every subset of the used points
    is projected onto its affine hull; a projection with positive weights
    lies in the hull, so the nearest of those is the answer (a badly
    conditioned subset can only give a point that is not nearer).  Returns
    the barycentric weights (L, 4), 0 outside the chosen subset."""
    lanes = w.shape[0]
    best = torch.full((lanes,), float("inf"), dtype=w.dtype, device=w.device)
    lam_best = torch.zeros(lanes, 4, dtype=w.dtype, device=w.device)
    for idx in _SUBSETS:
        k = len(idx)
        pts = w[:, idx]                                    # (L, k, 3)
        ok = used[:, idx].all(dim=1)
        if k == 1:
            lam = torch.ones(lanes, 1, dtype=w.dtype, device=w.device)
        else:
            d = pts[:, 1:] - pts[:, :1]                    # (L, k-1, 3)
            g = d @ d.transpose(1, 2)                      # (L, k-1, k-1)
            mu, det = _solve(g, -(d @ pts[:, 0, :, None])[..., 0])
            scale = torch.diagonal(g, dim1=1, dim2=2).amax(dim=1)
            ok &= det.abs() > 1e-24 * scale.clamp_min(1e-300) ** (k - 1)
            lam = torch.cat([1 - mu.sum(dim=1, keepdim=True), mu], dim=1)
            ok &= (lam > 0).all(dim=1)
        v = (lam[:, :, None] * pts).sum(dim=1)
        vv = (v * v).sum(dim=1)
        take = ok & (vv < best)
        best = torch.where(take, vv, best)
        full = torch.zeros(lanes, 4, dtype=w.dtype, device=w.device)
        full[:, idx] = lam
        lam_best = torch.where(take[:, None], full, lam_best)
    return lam_best


def hull_distance(p1: torch.Tensor, p2: torch.Tensor):
    """Closest distance between hulls ``p1`` (L, N1, 3) and ``p2`` (L, N2,
    3), in float64.  Returns a dict of float64/bool tensors on their device:
    ``distance`` (L,), ``point_a``, ``point_b`` (L, 3), ``intersecting``
    (L,) and ``converged`` (L,)."""
    p1, p2 = p1.double(), p2.double()
    lanes, dev = p1.shape[0], p1.device
    wa = torch.zeros(lanes, 4, 3, dtype=torch.float64, device=dev)
    wb = torch.zeros_like(wa)
    used = torch.zeros(lanes, 4, dtype=torch.bool, device=dev)
    wa[:, 0], wb[:, 0] = p1[:, 0], p2[:, 0]
    used[:, 0] = True
    lam = used.double()
    done = torch.zeros(lanes, dtype=torch.bool, device=dev)
    inside = torch.zeros_like(done)
    last = torch.full((lanes,), float("inf"), dtype=torch.float64, device=dev)
    for _ in range(DIST_MAX_ITERS):
        v = ((wa - wb) * lam[:, :, None]).sum(dim=1)
        vv = (v * v).sum(dim=1)
        # a tetrahedron all of whose weights are positive holds the origin
        now_in = (vv <= ZERO_SQ) | (lam > 0).all(dim=1)
        inside |= ~done & now_in
        done |= now_in
        # |v| no longer falls: rounding, not geometry, moves it now
        done |= vv >= last * (1 - DIST_REL_TOL)
        last = vv
        a, b = _support(p1, -v), _support(p2, v)
        w = a - b
        gap = vv - (v * w).sum(dim=1)
        done |= gap <= (DIST_REL_TOL * vv
                        + DIST_ROUND_TOL * vv.sqrt() * w.norm(dim=1))
        # w already in the simplex: no support point is left to add
        seen = ((wa - wb) - w[:, None]).abs().amax(dim=2) <= 1e-15
        done |= (seen & used & (lam > 0)).any(dim=1)
        if bool(done.all()):
            break
        # drop the slots the last solve left out, then add w to a free one
        used &= lam > 0
        free = torch.argmin(used.to(torch.int8), dim=1)
        live = ~done
        rows = torch.nonzero(live).flatten()
        wa[rows, free[rows]] = a[rows]
        wb[rows, free[rows]] = b[rows]
        used[rows, free[rows]] = True
        lam_new = _closest(wa - wb, used)
        lam = torch.where(live[:, None], lam_new, lam)
    pa = (wa * lam[:, :, None]).sum(dim=1)
    pb = (wb * lam[:, :, None]).sum(dim=1)
    dist = torch.where(inside, 0.0, (pa - pb).norm(dim=1))
    return {"distance": dist, "point_a": pa, "point_b": pb,
            "intersecting": inside, "converged": done}


def oracle_rows(p1: np.ndarray, p2: np.ndarray, version: int = 2,
                tol_ff: float = 1.0):
    """The float64 oracle pair by pair over (L, N, 3) arrays.  Returns a
    dict of numpy arrays: ``valid`` (the oracle gave a verdict and, on a
    hit, its EPA converged), ``hit``, ``depth``, ``normal``,
    ``contact_point`` and ``nearest_points`` (zeros on misses)."""
    n = p1.shape[0]
    rows = {"valid": np.zeros(n, bool), "hit": np.zeros(n, bool),
            "depth": np.zeros(n), "normal": np.zeros((n, 3)),
            "contact_point": np.zeros((n, 3)),
            "nearest_points": np.zeros((n, 2, 3))}
    for i in range(n):
        try:
            o = oracle.gjkepa_oracle(p1[i], p2[i], version=version,
                                     tol_ff=tol_ff)
        except oracle.OracleHalt:
            continue
        if o.epa_capped:
            continue
        rows["valid"][i] = True
        rows["hit"][i] = o.hit
        if o.hit:
            rows["depth"][i] = o.depth
            rows["normal"][i] = o.normal
            rows["contact_point"][i] = o.contact_point
            rows["nearest_points"][i] = o.nearest_points
    return rows
