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
    with it :func:`c2_hulls` (config 2, 65,536 pairs of 64-vertex hulls,
    :164-194) and :func:`c3b_pairs` (config 3b, 16,384 24-vertex hulls
    against the four analytic kinds, :252-275), drawn in the bench's order
    from its one generator so the arrays equal the bench's.
"""

from __future__ import annotations

import numpy as np

__all__ = ["c3_pairs", "c3_shuffled", "mixed16_pairs", "kind_batch", "concat",
           "permute", "random_hulls", "c2_hulls", "c3b_pairs"]

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


def _c2_draws(rng, n: int, verts: int):
    """Config 2's four hull draws: the 4096-pair cell, then the n-pair one
    (bench.py:171-174); returns the latter."""
    for _ in range(2):
        random_hulls(rng, 4096, verts)
    return random_hulls(rng, n, verts), random_hulls(rng, n, verts)


def c2_hulls(seed: int = 0, n: int = 65536, verts: int = 64):
    """bench.py's config-2 hull pairs (boolean and distance): (p1, p2)."""
    return _c2_draws(np.random.default_rng(seed), n, verts)


def c3b_pairs(seed: int = 0):
    """bench.py's config 3b (:252-268): 16,384 24-vertex hulls and a quarter
    each of spheres, boxes, capsules and cylinders at positions ~ N(0,
    0.8^2), identity rotations.  Drawn after config 2's hulls from the same
    generator, as the bench does.  Returns (hulls, (kind, params, pos,
    rot))."""
    rng = np.random.default_rng(seed)
    _c2_draws(rng, 65536, 64)
    b, q = 16384, 16384 // 4
    hulls = random_hulls(rng, b, 24)

    def pos():
        return rng.normal(size=(q, 3)).astype(np.float32) * 0.8

    def u(lo, width, shape=q):
        return lo + width * rng.random(shape).astype(np.float32)

    sph = _shapes(0, _col3(u(0.3, 0.4)), pos())
    box = _shapes(1, u(0.25, 0.3, (q, 3)), pos())
    r = u(0.2, 0.2)
    cap = _shapes(2, _col3(r, u(0.25, 0.25)), pos())
    r = u(0.2, 0.25)
    cyl = _shapes(3, _col3(r, u(0.25, 0.25)), pos())
    return hulls, concat(sph, box, cap, cyl)
