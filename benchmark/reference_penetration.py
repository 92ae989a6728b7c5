"""The exact penetration depth and normal of two convex vertex clouds, by
brute-force separation, in plain float64 PyTorch.

For hulls A (``p1``) and B (``p2``) whose Minkowski difference A - B holds
the origin, the penetration depth is the origin's distance to the boundary
of A - B: the least h(n) = h_A(n) + h_B(-n) over unit vectors n, with
h_X(n) = max over X's vertices v of v . n.  Every facet of A - B is a face
of A, a face of -B, or spanned by an edge of A and an edge of B, so its
normal lies among these candidate axes, each taken with both signs:

* the unit normal of every vertex triple of A and of every one of B (a
  superset of the hulls' faces);
* the cross product of every vertex-pair segment of A with every one of B
  (a superset of the edge pairs).

At 24 vertices a hull that is 2 * C(24, 3) + C(24, 2)^2 = 80,224 axes a
lane.  Any unit vector n gives h(n) >= the depth, so the least h over the
candidates is the depth exactly, to float64 rounding, however a candidate
was rounded: no tolerance decides which triples count.  Only an axis of
length exactly 0 (three collinear vertices, parallel segments) is left
out.  The least h is <= 0 exactly when the origin lies outside A - B or on
its boundary (it then lies outside some facet's half-space): such a pair
is not penetrating and reads depth 0.

The normal is the port's convention: the outward normal of A - B's
nearest facet, so it points from A into B, and moving B by depth along it
(or A against it) separates the pair; h(normal) = depth.

Departures from the Fortran query (``SUBROUTINE GJKEPA``) and its EPA:

* no GJK and no EPA: no iteration counts and no status, and no contact
  type, contact point or nearest points;
* the depth is exact, where EPA stops once a probe gains less than its
  tolerance;
* where two facets tie for nearest, the normal is the first of them in
  the candidate order above (a sign pair's + side first), and EPA may give
  the other: a normal is judged by h(normal) - depth
  (:func:`minkowski_height`), which every tied facet meets.

Nothing here imports the program under test.
"""

from __future__ import annotations

from math import comb

import torch

CHUNK_BYTES = 1 << 28    # float64 vertex-axis products held at once


def _combinations(n: int, k: int, device) -> torch.Tensor:
    return torch.combinations(torch.arange(n, device=device), k)


def candidate_axes(p1: torch.Tensor, p2: torch.Tensor):
    """Unit candidate axes of hulls ``p1`` (L, N1, 3) and ``p2`` (L, N2, 3),
    float64: (L, M, 3) axes and an (L, M) mask of those of non-zero
    length, in the order A's triples, B's triples, A's segments crossed
    with B's."""
    def face_normals(p):
        t = p[:, _combinations(p.shape[1], 3, p.device)]      # (L, T, 3, 3)
        return torch.linalg.cross(t[:, :, 1] - t[:, :, 0],
                                  t[:, :, 2] - t[:, :, 0])

    def segments(p):
        e = _combinations(p.shape[1], 2, p.device)
        return p[:, e[:, 1]] - p[:, e[:, 0]]                   # (L, E, 3)

    e1, e2 = segments(p1), segments(p2)
    lanes = p1.shape[0]
    edges = torch.linalg.cross(e1[:, :, None], e2[:, None, :]).reshape(
        lanes, -1, 3)
    axes = torch.cat([face_normals(p1), face_normals(p2), edges], 1)
    length = axes.norm(dim=-1)
    ok = length > 0
    return axes / torch.where(ok, length, 1.0)[..., None], ok


def minkowski_height(p1: torch.Tensor, p2: torch.Tensor,
                     n: torch.Tensor) -> torch.Tensor:
    """h_A(n) + h_B(-n) of hulls ``p1``, ``p2`` (L, N, 3) along ``n`` (L, 3),
    in float64: the support height of A - B."""
    p1, p2, n = p1.double(), p2.double(), n.double()
    return (torch.einsum("lvk,lk->lv", p1, n).amax(1)
            - torch.einsum("lvk,lk->lv", p2, n).amin(1))


def _chunk(p1: torch.Tensor, p2: torch.Tensor):
    u, ok = candidate_axes(p1, p2)
    ut = u.transpose(1, 2)
    d1, d2 = torch.bmm(p1, ut), torch.bmm(p2, ut)              # (L, N, M)
    h = torch.cat([d1.amax(1) - d2.amin(1),                    # along +u
                   d2.amax(1) - d1.amin(1)], 1)                # along -u
    h = torch.where(torch.cat([ok, ok], 1), h, torch.inf)
    least, k = h.min(1)
    m = u.shape[1]
    rows = torch.arange(p1.shape[0], device=p1.device)
    normal = u[rows, k % m] * torch.where(k < m, 1.0, -1.0)[:, None]
    return least, normal


def penetration(p1: torch.Tensor, p2: torch.Tensor) -> dict:
    """The exact penetration of hulls ``p1`` (L, N1, 3) and ``p2`` (L, N2,
    3), computed in float64 in lane chunks of at most ``CHUNK_BYTES`` of
    vertex-axis products.  Returns float64/bool tensors on their device:
    ``penetrating`` (L,), ``depth`` (L,; 0 where not penetrating) and
    ``normal`` (L, 3; 0 where not penetrating)."""
    p1, p2 = p1.double(), p2.double()
    lanes, n1, n2 = p1.shape[0], p1.shape[1], p2.shape[1]
    axes = comb(n1, 3) + comb(n2, 3) + comb(n1, 2) * comb(n2, 2)
    step = max(1, CHUNK_BYTES // (axes * (n1 + n2 + 6) * 8))
    least, normal = zip(*(_chunk(p1[i:i + step], p2[i:i + step])
                          for i in range(0, lanes, step)))
    least, normal = torch.cat(least), torch.cat(normal)
    inside = least > 0
    return {"penetrating": inside,
            "depth": torch.where(inside, least, 0.0),
            "normal": torch.where(inside[:, None], normal, 0.0)}
