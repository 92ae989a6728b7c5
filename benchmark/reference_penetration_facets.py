"""The exact penetration depth and normal of two convex vertex clouds, from
their hulls' facets and edges, in plain float64 PyTorch: the quantity of
:mod:`benchmark.reference_penetration` at hull sizes whose every vertex
triple and segment pair it cannot hold (at 255 vertices, ~1.07e9 axes a
lane).

For hulls A (``p1``) and B (``p2``) whose Minkowski difference A - B holds
the origin, the penetration depth is the least h(n) = h_A(n) + h_B(-n)
over unit vectors n, h_X(n) the largest v . n over X's vertices.  Every
facet of A - B is a facet of A, a facet of -B, or spanned by an edge of A
and an edge of B, so the least h over these candidate axes, each taken
with both signs, is the depth:

* the unit normal of every facet of A and of every facet of B;
* the cross product of every edge of A with every edge of B.

A hull's facets and edges, per lane (:func:`hull_facets`):

1. the probe: the vertices furthest along :data:`PROBE_DIRECTIONS` fixed
   directions, and the triples of them whose plane leaves every probe
   vertex on one side.  A vertex strictly inside each such plane lies
   strictly inside the probe's hull, so inside the cloud's hull, and is
   no vertex of it: it is dropped.  The rest (the candidates) span the
   same hull;
2. the facets: the candidate triples whose plane leaves every candidate on
   one side;
3. the edges: the candidate pairs that lie on a kept triple.

"One side" is decided with a margin of :data:`SIDE_TOL` times |e1| |e2|
times the cloud's diameter bound, e1 and e2 the triple's two edges from
its first vertex: float64 rounding moves a vertex's computed side
n . (v - p) (n = e1 x e2, not normalised) by at most a few 1e-16 of that
product, so a true facet is never dropped, however thin its triangle, and
a vertex within the margin of the probe's boundary is kept.  A triple
kept for the margin only (near-coplanar vertices) adds an axis that is
still a unit vector, whose h bounds the depth from above, so extra axes
do not change the least h; in the probe, one more plane that a dropped
vertex must lie strictly inside, which drops no hull vertex.  A triple
that repeats a vertex (the probe repeats a vertex furthest along several
directions, the padding below repeats candidates) is left out by the
vertices' indices, since rounding (a fused multiply-add) can leave its
cross product a tiny normal, and so is a triple whose computed normal is
exactly 0, as a zero cross product of two edges is.  A probe with a
triple that has every probe vertex within the margin of its plane (a flat
probe) drops nothing.

The least h is <= 0 exactly when the origin lies outside A - B or on its
boundary: such a pair is not penetrating and reads depth 0.  The normal is
the port's convention: the outward normal of A - B's nearest facet, from A
into B; h(normal) = depth.

Departures from :mod:`benchmark.reference_penetration` (the brute-force
reference, which this one equals to float64 rounding where both run):

* the axes are the hulls' facet normals and edge crosses, found as above,
  in place of every vertex triple and every segment pair;
* the supports run over the candidate vertices, which hold every hull
  vertex, so each h is the same;
* where two facets tie for nearest, the normal is the first of them in
  this order: A's facets, B's facets, A's edges crossed with B's (each
  axis's + side first, the triples and pairs in lexicographic order of
  the candidates' indices); a normal is judged by h(normal) - depth
  (:func:`~benchmark.reference_penetration.minkowski_height`), which
  every tied facet meets.

Departures from the Fortran query (``SUBROUTINE GJKEPA``) are those of
the brute-force reference: no GJK, no EPA, no status or iteration counts,
no contact type, contact point or nearest points, and an exact depth where
EPA stops once a probe gains less than its tolerance.

Lanes are taken :data:`LANES` at a time, the triples and axes in chunks
of :data:`CHUNK_BYTES`.  Each lane's candidates are padded to the most a
lane of the chunk has by repeating its first one, which adds sides it
already has and no triple; its facets and edges are padded under a
mask.  Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference_penetration import minkowski_height  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LANES = 256              # lanes taken at once
CHUNK_BYTES = 1 << 28    # float64 vertex-axis products held at once
PROBE_DIRECTIONS = 64    # directions whose furthest vertices make the probe
SIDE_TOL = 1e-12         # side margin, relative to |e1| |e2| diameter


def _fibonacci(n: int, device) -> torch.Tensor:
    """``n`` unit directions spread over the sphere, float64."""
    k = torch.arange(n, dtype=torch.float64, device=device) + 0.5
    z = 1.0 - 2.0 * k / n
    phi = k * math.pi * (3.0 - math.sqrt(5.0))
    r = (1.0 - z * z).sqrt()
    return torch.stack([r * phi.cos(), r * phi.sin(), z], 1)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Entries ``idx`` (L, K) of each lane's rows of ``x`` (L, N, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _first(mask: torch.Tensor):
    """Each row's set positions of ``mask`` (L, N) in order, padded to the
    most a row has: (positions (L, K), which are set (L, K))."""
    count = mask.sum(1)
    k = max(int(count.max()), 1)
    idx = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)[:, :k]
    return idx, torch.arange(k, device=mask.device) < count[:, None]


def _planes(p: torch.Tensor, tri: torch.Tensor, tol: torch.Tensor):
    """Each lane's vertex triples ``tri`` (L, T, 3) of its points ``p`` (L,
    N, 3): the unnormalised normals n = e1 x e2 (L, T, 3), the offsets
    n . p[tri[..., 0]] and the side margins |e1| |e2| ``tol`` (L, T)."""
    c = _gather(p, tri.flatten(1)).view(*tri.shape, 3)        # (L, T, 3, 3)
    e1, e2 = c[:, :, 1] - c[:, :, 0], c[:, :, 2] - c[:, :, 0]
    n = torch.linalg.cross(e1, e2)
    return (n, (n * c[:, :, 0]).sum(-1),
            e1.norm(dim=-1) * e2.norm(dim=-1) * tol[:, None])


def _supporting(p: torch.Tensor, ids: torch.Tensor, tri: torch.Tensor,
                tol: torch.Tensor):
    """For the vertex triples ``tri`` (T, 3) of each lane's points ``p`` (L,
    N, 3), whose vertex indices are ``ids`` (L, N; -1 for padding), in
    chunks, (L, T) masks: which take three vertices that are distinct and
    no padding, have a non-zero normal and leave every point on one side of
    their plane within the margin; which have every point on the normal's
    negative side; which take three distinct vertices and have every point
    within the margin."""
    lanes, points = p.shape[:2]
    step = max(1, CHUNK_BYTES // (8 * lanes * (points + 16)))
    ok, below, flat = [], [], []
    for i in range(0, tri.shape[0], step):
        t = tri[i:i + step]
        n, off, margin = _planes(p, t.expand(lanes, -1, -1), tol)
        s = ((torch.einsum("lvk,ltk->ltv", p, n) - off[..., None])
             / torch.where(margin > 0, margin, 1.0)[..., None])  # (L, t, N)
        lo, hi = s.amin(-1) >= -1.0, s.amax(-1) <= 1.0
        v = ids[:, t]                                           # (L, t, 3)
        distinct = ((v[..., 0] != v[..., 1]) & (v[..., 0] != v[..., 2])
                    & (v[..., 1] != v[..., 2]) & (v >= 0).all(-1))
        ok.append(distinct & (n != 0).any(-1) & (lo | hi))
        below.append(hi)
        flat.append(distinct & lo & hi)
    return torch.cat(ok, 1), torch.cat(below, 1), torch.cat(flat, 1)


def hull_facets(p: torch.Tensor):
    """The facets and edges of the hulls of clouds ``p`` (L, N, 3)
    float64: (candidate vertices (L, C, 3), padded by repeating each lane's
    first; facet triples (L, F, 3) of candidate indices, their unit
    outward normals (L, F, 3) and which are facets (L, F); edges (L, E, 2)
    of candidate indices and which are edges (L, E)).  The facets may
    include near-coplanar extras (module docstring)."""
    dev = p.device
    tol = SIDE_TOL * 2.0 * (p - p.mean(1, keepdim=True)).norm(dim=-1).amax(1)
    # 1. the probe: drop the vertices strictly inside every supporting plane
    far = torch.argmax(p @ _fibonacci(PROBE_DIRECTIONS, dev).T, 1)
    q = _gather(p, far)
    tri = torch.combinations(torch.arange(q.shape[1], device=dev), 3)
    ok, below, flat = _supporting(q, far, tri, tol)
    solid = ok.any(1) & ~(ok & flat).any(1)
    idx, held = _first(ok)
    n, off, margin = _planes(q, tri[idx], tol)
    sign = torch.where(_gather(below, idx), 1.0, -1.0)
    s = ((torch.einsum("lvk,ltk->lvt", p, n * sign[..., None])
          - (off * sign)[:, None]) / margin[:, None])           # (L, N, K)
    inside = torch.where(held[:, None], s, -math.inf).amax(-1) < -1.0
    idx, real = _first(~(solid[:, None] & inside))
    cand = _gather(p, torch.where(real, idx, idx[:, :1]))
    # 2. the facets
    c = cand.shape[1]
    tri = torch.combinations(torch.arange(c, device=dev), 3)
    ok, below, _ = _supporting(cand, torch.where(real, idx, -1), tri, tol)
    idx, facet = _first(ok)
    n = _planes(cand, tri[idx], tol)[0]
    n = n * torch.where(_gather(below, idx), 1.0, -1.0)[..., None]
    n = n / torch.where(facet, n.norm(dim=-1), 1.0)[..., None]
    # 3. the edges: the pairs on a kept triple
    adj = torch.zeros(p.shape[0], c * c, dtype=torch.float64, device=dev)
    for a, b in ((0, 1), (0, 2), (1, 2)):
        adj.index_add_(1, tri[:, a] * c + tri[:, b], ok.to(adj.dtype))
    pair, edge = _first(adj > 0)
    return (cand, tri[idx], n, facet,
            torch.stack([pair // c, pair % c], -1), edge)


def _least(hull_a, hull_b):
    """(least h (L,), its normal (L, 3)) over the candidate axes of the
    lanes' hulls (:func:`hull_facets`), in chunks of axes."""
    (a, _, na, fa, ea, oka), (b, _, nb, fb, eb, okb) = hull_a, hull_b
    da = _gather(a, ea[..., 1]) - _gather(a, ea[..., 0])        # (L, Ea, 3)
    db = _gather(b, eb[..., 1]) - _gather(b, eb[..., 0])
    u = torch.cat([na, nb, torch.linalg.cross(
        da[:, :, None], db[:, None]).flatten(1, 2)], 1)         # (L, M, 3)
    ok = torch.cat([fa, fb, (oka[:, :, None] & okb[:, None]).flatten(1)], 1)
    length = u.norm(dim=-1)
    ok &= length > 0
    u = u / torch.where(ok, length, 1.0)[..., None]
    lanes = a.shape[0]
    best = torch.full((lanes,), math.inf, dtype=torch.float64, device=a.device)
    normal = torch.zeros((lanes, 3), dtype=torch.float64, device=a.device)
    step = max(1, CHUNK_BYTES // (8 * lanes * (a.shape[1] + b.shape[1] + 4)))
    for i in range(0, u.shape[1], step):
        w = u[:, i:i + step]
        d1 = torch.einsum("lvk,lmk->lmv", a, w)                 # (L, m, Ca)
        d2 = torch.einsum("lvk,lmk->lmv", b, w)
        h = torch.stack([d1.amax(-1) - d2.amin(-1),             # along +w
                         d2.amax(-1) - d1.amin(-1)], -1)        # along -w
        h = torch.where(ok[:, i:i + step, None], h, math.inf).flatten(1)
        least, k = h.min(1)
        n = _gather(w, k[:, None] // 2)[:, 0] * torch.where(
            k % 2 == 0, 1.0, -1.0)[:, None]
        better = least < best
        best = torch.where(better, least, best)
        normal = torch.where(better[:, None], n, normal)
    return best, normal


def penetration(p1: torch.Tensor, p2: torch.Tensor) -> dict:
    """The exact penetration of hulls ``p1`` (L, N1, 3) and ``p2`` (L, N2,
    3), in float64, :data:`LANES` lanes at a time.  Returns float64/bool
    tensors on their device: ``penetrating`` (L,), ``depth`` (L,; 0 where
    not penetrating) and ``normal`` (L, 3; 0 where not penetrating)."""
    p1, p2 = p1.double(), p2.double()
    least = torch.zeros(p1.shape[0], dtype=torch.float64, device=p1.device)
    normal = torch.zeros((p1.shape[0], 3), dtype=torch.float64,
                         device=p1.device)
    for i in range(0, p1.shape[0], LANES):
        least[i:i + LANES], normal[i:i + LANES] = _least(
            hull_facets(p1[i:i + LANES]), hull_facets(p2[i:i + LANES]))
    inside = least > 0
    return {"penetrating": inside,
            "depth": torch.where(inside, least, 0.0),
            "normal": torch.where(inside[:, None], normal, 0.0)}
