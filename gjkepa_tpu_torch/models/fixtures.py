"""Seeded numpy recipes of the JAX package's shape-pair workloads.

Each returns two batches as ``(kind, params, pos, rot)`` numpy tuples
(int32, float32), drawing from the generator in the JAX package's order,
so that ``ShapeBatch.from_numpy(*a)`` gives the port exactly the pairs the
JAX package builds from the same seed:

  * :func:`c3_pairs`: ``bench.py``'s config 3 (``mk3``, :200-212), a
    quarter each of spheres, boxes, capsules and cylinders, identity
    rotations, positions ~ N(0, 1.2^2); 65,536 pairs in the bench;
  * :func:`mixed16_pairs`: the 16 kind combinations with random rotations
    of ``tests/test_shapes.py:246-276``;
  * :func:`kind_batch`: one kind (``_batch_of_kind``), e.g. the dense
    all-cylinder batch of ``tests/test_shapes.py:317-319``;
  * :func:`random_hulls`: ``bench.py``'s hull generator (:112-116), and
    with it :func:`c2_hulls_4k` and :func:`c2_hulls` (config 2, 4,096 and
    65,536 pairs of 64-vertex hulls, :164-194) and :func:`c3b_pairs`
    (config 3b, 16,384 24-vertex hulls against the four analytic kinds,
    :252-275) and :func:`c4_pairs`
    (config 4, 16,384 deep pairs of 24-vertex hulls, :277-317, with
    :func:`deep_pairs` its recipe), drawn in the bench's order from its one
    generator so the arrays equal the bench's;
  * the large-hull path (n1 + n2 > 4096): :func:`big_pairs_8192` and
    :func:`big_subhull_pairs` (``tests/test_fused_tpu.py:248-273``),
    :func:`big_c2_pairs` (4,096 pairs of 2,600-vertex hulls),
    :func:`large_hulls` (``tests/test_large_hulls.py:30-35``) and
    :func:`tie_pairs`, hulls whose support probes tie.
"""

from __future__ import annotations

import numpy as np

__all__ = ["c3_pairs", "c3_shuffled", "mixed16_pairs", "kind_batch", "concat",
           "permute", "random_hulls", "c2_hulls_4k", "c2_hulls", "c3b_pairs",
           "deep_pairs",
           "c4_pairs",
           "hull_kind_pairs",
           "big_pairs_8192", "big_subhull_pairs", "big_c2_pairs",
           "large_hulls", "tie_pairs"]

_EYE = np.eye(3, dtype=np.float32)


def _shapes(kind, params, pos, rot=None):
    n = params.shape[0]
    rot = np.broadcast_to(_EYE, (n, 3, 3)) if rot is None else rot
    return (np.full(n, kind, np.int32), params.astype(np.float32),
            pos.astype(np.float32), np.ascontiguousarray(rot, np.float32))


def _col3(*cols):
    n = cols[0].shape[0]
    cols = cols + (np.zeros(n, np.float32),) * (3 - len(cols))
    return np.stack(cols, axis=1)


def concat(*batches):
    return tuple(np.concatenate(parts) for parts in zip(*batches))


def permute(batch, perm):
    return tuple(x[perm] for x in batch)


def _mk3(rng, q):
    def pos():
        return rng.normal(size=(q, 3)).astype(np.float32) * 1.2

    r = 0.4 + 0.4 * rng.random(q).astype(np.float32)
    sph = _shapes(0, _col3(r), pos())
    h = 0.3 + 0.4 * rng.random((q, 3)).astype(np.float32)
    box = _shapes(1, h, pos())
    r = 0.2 + 0.2 * rng.random(q).astype(np.float32)
    hl = 0.3 + 0.3 * rng.random(q).astype(np.float32)
    cap = _shapes(2, _col3(r, hl), pos())
    r = 0.2 + 0.3 * rng.random(q).astype(np.float32)
    hl = 0.3 + 0.3 * rng.random(q).astype(np.float32)
    cyl = _shapes(3, _col3(r, hl), pos())
    return concat(sph, box, cap, cyl)


def c3_pairs(seed: int = 0, n: int = 65536):
    """bench.py's config 3 pairs, natural order."""
    rng = np.random.default_rng(seed)
    return _mk3(rng, n // 4), _mk3(rng, n // 4)


def c3_shuffled(seed: int = 0, n: int = 65536):
    """The same pairs, both sides permuted by the next draw of the same
    generator, as the bench's shuffled-order run (bench.py:238-250).
    Returns (a, b, perm): pair i is natural pair perm[i]."""
    rng = np.random.default_rng(seed)
    a, b = _mk3(rng, n // 4), _mk3(rng, n // 4)
    perm = rng.permutation(n)
    return permute(a, perm), permute(b, perm), perm


def _rand_rots(k, rng):
    ms = []
    for _ in range(k):
        q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        ms.append(q)
    return np.stack(ms).astype(np.float32)


def kind_batch(kind: int, n: int, rng, spread: float = 0.9):
    """n shapes of one kind with random rotations (spheres keep identity)."""
    pos = rng.normal(size=(n, 3)).astype(np.float32) * spread
    rot = _rand_rots(n, rng)
    p0 = (0.3 + 0.4 * rng.random(n)).astype(np.float32)
    p1 = (0.2 + 0.4 * rng.random(n)).astype(np.float32)
    if kind == 0:
        return _shapes(0, _col3(p0), pos)
    if kind == 1:
        return _shapes(1, _col3(p0, p1, p0), pos, rot)
    return _shapes(kind, _col3(p0, p1), pos, rot)


def mixed16_pairs(n_per_combo: int, seed: int):
    """All 16 (kind A, kind B) combinations, n_per_combo pairs each, A
    kind-major."""
    rng = np.random.default_rng(seed)
    a = concat(*[kind_batch(ka, n_per_combo, rng) for ka in range(4)
                 for _ in range(4)])
    b = concat(*[kind_batch(kb, n_per_combo, rng) for _ in range(4)
                 for kb in range(4)])
    return a, b


def random_hulls(rng, b: int, n: int, spread: float = 0.8):
    """(b, n, 3) float32: n points on a unit sphere, each scaled by
    U(0.5, 1), the cloud moved by N(0, spread^2) (bench.py:112-116)."""
    v = rng.normal(size=(b, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= 0.5 + 0.5 * rng.random((b, n, 1))
    return (v + rng.normal(size=(b, 1, 3)) * spread).astype(np.float32)


def _hull4k(rng, verts: int):
    return random_hulls(rng, 4096, verts), random_hulls(rng, 4096, verts)


def _c2_draws(rng, n: int, verts: int):
    """Config 2's four hull draws: the 4096-pair cell, then the n-pair one
    (bench.py:171-174); returns the latter."""
    _hull4k(rng, verts)
    return random_hulls(rng, n, verts), random_hulls(rng, n, verts)


def c2_hulls_4k(seed: int = 0, verts: int = 64):
    """bench.py's config-2 hull4k pairs, the generator's first two draws:
    (p1, p2), 4,096 pairs each."""
    return _hull4k(np.random.default_rng(seed), verts)


def c2_hulls(seed: int = 0, n: int = 65536, verts: int = 64):
    """bench.py's config-2 hull64k pairs (boolean and distance), drawn
    after the hull4k pairs: (p1, p2)."""
    return _c2_draws(np.random.default_rng(seed), n, verts)


def _four_kinds(rng, q: int, spread: float):
    """A quarter each of spheres, boxes, capsules and cylinders (``q`` of
    each) at positions ~ N(0, spread^2), identity rotations, drawn as
    bench.py's config 3b draws them (:258-268)."""
    def pos():
        return rng.normal(size=(q, 3)).astype(np.float32) * spread

    def u(lo, width, shape=q):
        return lo + width * rng.random(shape).astype(np.float32)

    sph = _shapes(0, _col3(u(0.3, 0.4)), pos())
    box = _shapes(1, u(0.25, 0.3, (q, 3)), pos())
    r = u(0.2, 0.2)
    cap = _shapes(2, _col3(r, u(0.25, 0.25)), pos())
    r = u(0.2, 0.25)
    cyl = _shapes(3, _col3(r, u(0.25, 0.25)), pos())
    return concat(sph, box, cap, cyl)


def _c3b_draws(rng):
    """Config 2's draws, then config 3b's (the bench's order)."""
    _c2_draws(rng, 65536, 64)
    b = 16384
    hulls = random_hulls(rng, b, 24)
    return hulls, _four_kinds(rng, b // 4, 0.8)


def c3b_pairs(seed: int = 0):
    """bench.py's config 3b (:252-268): 16,384 24-vertex hulls and a quarter
    each of spheres, boxes, capsules and cylinders at positions ~ N(0,
    0.8^2), identity rotations.  Drawn after config 2's hulls from the same
    generator, as the bench does.  Returns (hulls, (kind, params, pos,
    rot))."""
    return _c3b_draws(np.random.default_rng(seed))


def deep_pairs(rng, b: int, n: int):
    """bench.py's config-4 recipe (:277-281): a small hull inside a big one,
    offset a little.  Returns (big, small), (b, n, 3) float32 each."""
    big = random_hulls(rng, b, n, spread=0.0) * 2.0
    small = random_hulls(rng, b, n, spread=0.0) * 0.5
    small += rng.normal(size=(b, 1, 3)).astype(np.float32) * 0.2
    return big, small


def c4_pairs(seed: int = 0):
    """bench.py's config 4 (and its manifolds): 16,384 deep pairs of
    24-vertex hulls, drawn as the bench draws them when every config runs,
    after config 2's and config 3b's draws from the same generator
    (:141, :172-173, :258-268, :277-281).  Returns (big, small)."""
    rng = np.random.default_rng(seed)
    _c3b_draws(rng)
    return deep_pairs(rng, 16384, 24)


def hull_kind_pairs(seed: int, b: int, n: int, spread: float = 0.8):
    """c3b's recipe at other sizes: ``b`` hulls of ``n`` vertices against a
    quarter each of the four kinds, hull centres and shape positions ~ N(0,
    spread^2) (c3b: 0.8; smaller, more hits).  Returns (hulls, (kind,
    params, pos, rot))."""
    rng = np.random.default_rng(seed)
    hulls = random_hulls(rng, b, n, spread)
    return hulls, _four_kinds(rng, b // 4, spread)


# -- large hulls --------------------------------------------------------------

def big_pairs_8192():
    """256 pairs of 8,192-vertex hulls, ``(big, big + 0.1)``, as
    ``tests/test_fused_tpu.py:257-261`` (seed 23, spread 0.4): 25.2 MB a
    side, nearly every pair a hit."""
    big = random_hulls(np.random.default_rng(23), 256, 8192, spread=0.4)
    return big, big + np.float32(0.1)


def big_subhull_pairs(n_sub: int = 2048):
    """The first ``n_sub`` vertices of :func:`big_pairs_8192`'s hulls, and
    the same padded back to 8,192 by repeating vertex 0
    (``tests/test_fused_tpu.py:263-269``): ((sub, sub + 0.1), (padded,
    padded + 0.1)).  The padded pairs take the large-hull path, the others
    (n1 + n2 = 4096) the resident one."""
    big, _ = big_pairs_8192()
    sub = np.ascontiguousarray(big[:, :n_sub])
    pad = np.concatenate(
        [sub, np.repeat(sub[:, :1], big.shape[1] - n_sub, axis=1)], axis=1)
    return (sub, sub + np.float32(0.1)), (pad, pad + np.float32(0.1))


def big_c2_pairs(seed: int = 0):
    """4,096 pairs of 2,600-vertex ``random_hulls`` at spread 0.8 (n1 + n2 =
    5,200, each hull padded to 3,072 in the broadphase): a mix of misses and
    hits, 128 MB a side."""
    rng = np.random.default_rng(seed)
    return (random_hulls(rng, 4096, 2600, 0.8),
            random_hulls(rng, 4096, 2600, 0.8))


def large_hulls(rng, b: int, n: int, radius: float = 1.0,
                spread: float = 0.5):
    """``tests/test_large_hulls.py``'s generator (:30-35)."""
    v = rng.normal(size=(b, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= radius * (0.6 + 0.4 * rng.random((b, n, 1)))
    v += rng.normal(size=(b, 1, 3)) * spread
    return v.astype(np.float32)


# (first slot, second slot, third slot) of each cube corner's three copies:
# i, i + 1 (two threads of a warp's scan) and i + 32 (j + 1) (one thread)
TIE_SLOTS = tuple((2 + 4 * j, 3 + 4 * j, 34 + 36 * j) for j in range(8))


def _tie_hulls(rng, b: int, n: int, centre_spread: float):
    """(b, n, 3) float32 hulls on a 1/8 grid whose support probes tie: the
    8 corners of a box, each three times at :data:`TIE_SLOTS` (once exact,
    twice moved by one ulp along an axis, in an order that turns with the
    corner), and the other vertices on grid points inside the box."""
    half = rng.integers(3, 9, size=(b, 1, 3))               # 3/8 .. 1
    centre = np.round(rng.normal(size=(b, 1, 3)) * centre_spread * 8)
    inner = rng.integers(-(half - 1), half, size=(b, n, 3))
    v = (inner + centre) / 8.0
    signs = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                      for z in (-1, 1)])
    for j, slots in enumerate(TIE_SLOTS):
        corner = ((signs[j] * half + centre) / 8.0)[:, 0].astype(np.float32)
        for k, slot in enumerate(slots):
            c = corner.copy()
            axis = (j + k) % 3 - 1               # -1: exact, else one ulp
            if axis >= 0:
                c[:, axis] = np.nextafter(c[:, axis], np.float32(np.inf))
            v[:, slot] = c
    return v.astype(np.float32)


def tie_pairs(b: int = 2048, n1: int = 2100, n2: int = 2100, seed: int = 31):
    """Box pairs on a 1/8 grid whose support probes tie between copies of
    a corner (:func:`_tie_hulls`), n1 + n2 > 4096 so that they take the
    large-hull path; the boxes' centres spread so that about half the
    pairs overlap."""
    rng = np.random.default_rng(seed)
    return _tie_hulls(rng, b, n1, 0.6), _tie_hulls(rng, b, n2, 0.6)
