"""Contact manifolds: the port's ``manifold_batch``,
``manifold_shapes_batch`` and ``manifold_hull_shape_batch`` against the
JAX package's on the same numpy inputs: the fixtures of
``tests/test_manifold.py`` (stacked and offset boxes, a sphere pair, a
miss, the 12-gon prism on a slab) and random lanes (rotated boxes, the 16
kind pairs, random hulls, hulls against the four kinds).  The narrowphase
outputs that feed both come from the port (its plain fused versions on
the CPU, and the portable float64 query for the prism).

Tolerances against JAX:

  * mask and overflow exact on every lane;
  * depths within 1e-5 (float32) and 1e-9 (float64) on every kept point,
    the points within 1e-5 / 1e-9 row by row on the shape lanes;
  * on random hull lanes, the points as a set (each kept point within
    1e-5 of a kept point of the other side, both ways) on every lane, and
    row by row on >= 90% of them: the 4-point reduction takes first
    maxima of depths and areas that tie to rounding where the clip emits
    a vertex twice or a face lies flat on the reference plane, and XLA's
    fused multiply-adds move those ties (4 of these 64 lanes order their
    points differently; all keep the same points).
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.models.shapes import ShapeBatch as JaxShapes
from gjkepa_tpu.ops import manifold as jm
from gjkepa_tpu_torch import (GJKEPAConfig, ShapeBatch,
                              collide_shapes_batch_fused,
                              fused_gjkepa_hull_shapes, gjkepa_batch,
                              gjkepa_batch_fused, manifold_batch,
                              manifold_hull_shape_batch,
                              manifold_shapes_batch)
from gjkepa_tpu_torch.models import fixtures

torch.set_num_threads(1)

# one compiled program a call shape (a third of the eager vmap's time)
JAX_OPS = {name: jax.jit(getattr(jm, name),
                         static_argnames=("cfg", "tol", "poly_cap"))
           for name in ("manifold_batch", "manifold_shapes_batch",
                        "manifold_hull_shape_batch")}

F32 = 1e-5
F64 = 1e-9
EYE = np.eye(3, dtype=np.float32)


def _rots(rng, k):
    ms = []
    for _ in range(k):
        q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        ms.append(q)
    return np.stack(ms).astype(np.float32)


def _side(kind, params, pos, rot=None):
    n = len(params)
    rot = np.broadcast_to(EYE, (n, 3, 3)) if rot is None else rot
    return (np.full(n, kind, np.int32), np.asarray(params, np.float32),
            np.asarray(pos, np.float32), np.ascontiguousarray(rot, np.float32))


def _box_hull(center, half):
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float64)
    return np.asarray(center) + corners * np.asarray(half)


def _np(r):
    return {f: x.numpy() for f, x in zip(r._fields, r)}


def _jax(r):
    return {f: np.asarray(x) for f, x in zip(r._fields, r)}


def _check(ref, got, tol, rows=1.0):
    """mask and overflow exact; each lane's kept depths (sorted) within
    tol; points and depths row by row within tol on >= ``rows`` of the
    lanes, the kept points as sets on the rest."""
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_array_equal(got["overflow"], ref["overflow"])
    m = ref["mask"]
    np.testing.assert_allclose(np.sort(np.where(m, got["depths"], -1), 1),
                               np.sort(np.where(m, ref["depths"], -1), 1),
                               rtol=0, atol=tol)
    row_ok = (((np.abs(got["points"] - ref["points"]).max(2) <= tol)
               & (np.abs(got["depths"] - ref["depths"]) <= tol)) | ~m).all(1)
    assert row_ok.mean() >= rows, row_ok.mean()
    for i in np.nonzero(~row_ok)[0]:
        d = np.linalg.norm(got["points"][i][m[i]][:, None]
                           - ref["points"][i][m[i]][None], axis=2)
        assert max(d.min(0).max(), d.min(1).max()) <= tol, i


@pytest.fixture(scope="module")
def shape_lanes():
    """Lanes 0-3: the stacked boxes, the offset boxes, a sphere pair and a
    miss of test_manifold.py; then 32 random rotated box pairs
    (test_manifold.py's recipe) and the 16 kind pairs, 2 each."""
    rng = np.random.default_rng(0)
    n = 32
    fixed_a = [_side(1, [[0.5] * 3], [[0, 0, 0]]),
               _side(1, [[0.5] * 3], [[0, 0, 0]]),
               _side(0, [[0.6, 0, 0]], [[0, 0, 0]]),
               _side(0, [[0.3, 0, 0]], [[0, 0, 0]])]
    fixed_b = [_side(1, [[0.4, 0.4, 0.5]], [[0, 0, 0.9]]),
               _side(1, [[0.5] * 3], [[0.3, 0.15, 0.92]]),
               _side(0, [[0.6, 0, 0]], [[0.8, 0, 0]]),
               _side(0, [[0.3, 0, 0]], [[5.0, 0, 0]])]
    ra = _side(1, 0.3 + 0.4 * rng.random((n, 3)),
               rng.normal(size=(n, 3)) * 0.4, _rots(rng, n))
    rb = _side(1, 0.3 + 0.4 * rng.random((n, 3)),
               rng.normal(size=(n, 3)) * 0.4, _rots(rng, n))
    ma, mb = fixtures.mixed16_pairs(2, 3)
    a = fixtures.concat(*fixed_a, ra, ma)
    b = fixtures.concat(*fixed_b, rb, mb)
    ta, tb = (ShapeBatch.from_numpy(*s, device="cpu") for s in (a, b))
    r = collide_shapes_batch_fused(ta, tb)
    query = (r.normal, r.depth, r.hit, r.contact_point)
    ja, jb = (JaxShapes(*(jnp.asarray(x) for x in s)) for s in (a, b))
    jq = [jnp.asarray(x.numpy()) for x in query]
    out = {}
    for cap in (8, 4):
        out[cap] = (_jax(JAX_OPS["manifold_shapes_batch"](
            ja, jb, *jq, cfg=JaxConfig.for_f32(), poly_cap=cap)),
            _np(manifold_shapes_batch(ta, tb, *query, poly_cap=cap)))
    return r, out


@pytest.mark.parametrize("cap", [8, 4])
def test_shapes_match_jax(shape_lanes, cap):
    r, out = shape_lanes
    ref, got = out[cap]
    assert int(r.hit.sum()) >= 20
    _check(ref, got, F32)


def test_stacked_boxes_four_corners(shape_lanes):
    """Lane 0: 4 points at the overlap rectangle's corners, each at the face
    depth 0.1, not flagged."""
    _, out = shape_lanes
    m = out[8][1]
    assert m["mask"][0].all() and not m["overflow"][0]
    np.testing.assert_allclose(m["depths"][0], 0.1, atol=1e-5)
    for k in (0, 1):
        np.testing.assert_allclose(np.sort(m["points"][0][:, k]),
                                   [-0.4, -0.4, 0.4, 0.4], atol=1e-4)


def test_offset_boxes_cover_the_overlap(shape_lanes):
    """Lane 1: the points stay in the true overlap rectangle and span
    90-110% of its area."""
    off = 0.3
    _, out = shape_lanes
    m = out[8][1]
    pts = m["points"][1][m["mask"][1]]
    assert len(pts) == 4
    assert (pts[:, 0] >= off - 0.5 - 1e-4).all() and (pts[:, 0] <= 0.5 + 1e-4).all()
    assert (pts[:, 1] >= 0.15 - 0.5 - 1e-4).all() and (pts[:, 1] <= 0.5 + 1e-4).all()
    c = pts[:, :2].mean(0)
    q = pts[np.argsort(np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0]))][:, :2]
    area = 0.5 * abs(sum(q[i, 0] * q[(i + 1) % 4, 1] - q[(i + 1) % 4, 0] * q[i, 1]
                         for i in range(4)))
    true_area = (0.5 - (off - 0.5)) * (0.5 - (0.15 - 0.5))
    assert 0.9 * true_area < area < 1.1 * true_area


def test_sphere_pair_falls_back_and_miss_is_empty(shape_lanes):
    """Lane 2: spheres keep the query's single point and depth; lane 3, a
    miss, keeps no point."""
    r, out = shape_lanes
    m = out[8][1]
    assert m["mask"][2].tolist() == [True, False, False, False]
    np.testing.assert_array_equal(m["points"][2, 0], r.contact_point[2])
    assert m["depths"][2, 0] == float(r.depth[2])
    assert not bool(r.hit[3]) and not m["mask"][3].any()


def test_rotated_boxes_depths_bounded(shape_lanes):
    """The 32 rotated box lanes: depths >= 0 and at most the query depth
    plus 0.25 (the 0.1 clustering tol), a point on every hit."""
    r, out = shape_lanes
    m = out[8][1]
    sl = slice(4, 36)
    hit = r.hit[sl].numpy()
    assert hit.sum() >= 8
    mask = m["mask"][sl] & hit[:, None]
    dps = m["depths"][sl]
    qd = np.broadcast_to(r.depth[sl].numpy()[:, None], dps.shape)
    assert (dps[mask] >= 0).all() and (dps[mask] <= qd[mask] + 0.25).all()
    assert mask.any(1)[hit].all()


@pytest.fixture(scope="module")
def hull_lanes():
    """Float64: lane 0 the stacked boxes as 8-corner hulls, lane 1 the
    12-gon prism (24 vertices) on a slab, masked to its 8 corners."""
    ang = np.linspace(0.0, 2 * np.pi, 12, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    prism = np.concatenate([np.concatenate([ring, np.full((12, 1), z)], 1)
                            for z in (0.25, -0.25)])
    pad = np.zeros((16, 3))
    p1 = np.stack([np.concatenate([_box_hull([0, 0, 0], [0.5] * 3), pad]),
                   prism])
    p2 = np.stack([np.concatenate([_box_hull([0, 0, 0.9], [0.4, 0.4, 0.5]),
                                   pad]),
                   np.concatenate([_box_hull([0, 0, 0.65], [2.0, 2.0, 0.5]),
                                   pad])])
    mask1 = np.stack([np.arange(24) < 8, np.ones(24, bool)])
    mask2 = np.stack([np.arange(24) < 8] * 2)
    t = [torch.from_numpy(x) for x in (p1, p2, mask1, mask2)]
    r = gjkepa_batch(*t)
    query = (r.normal, r.depth, r.hit, r.contact_point)
    jq = [jnp.asarray(x) for x in (p1, p2)] + [
        jnp.asarray(x.numpy()) for x in query]
    out = {}
    for key, kw in (("tol", {}), ("cap8", dict(tol=1e-6)),
                    ("cap12", dict(tol=1e-6, poly_cap=12))):
        out[key] = (_jax(JAX_OPS["manifold_batch"](
            *jq, mask1=jnp.asarray(mask1), mask2=jnp.asarray(mask2),
            cfg=JaxConfig(), **kw)),
            _np(manifold_batch(*t[:2], *query, mask1=t[2], mask2=t[3],
                               cfg=GJKEPAConfig(), **kw)))
    return r, out


@pytest.mark.parametrize("key", ["tol", "cap8", "cap12"])
def test_hulls_f64_match_jax(hull_lanes, key):
    r, out = hull_lanes
    assert bool(r.hit.all())
    _check(*out[key], F64)


def test_hull_fixtures(hull_lanes):
    """The stacked boxes through the hull op: 4 points at |x| = |y| = 0.4,
    depth 0.1.  The prism's 12 coplanar vertices overflow 8 slots (tol
    1e-6) and fit 12, which give 4 points at depth 0.1."""
    _, out = hull_lanes
    m = out["tol"][1]
    assert m["mask"][0].all()
    np.testing.assert_allclose(m["depths"][0], 0.1, atol=1e-6)
    np.testing.assert_allclose(np.abs(m["points"][0][:, :2]), 0.4, atol=1e-5)
    assert out["cap8"][1]["overflow"][1]
    m12 = out["cap12"][1]
    assert not m12["overflow"][1] and m12["mask"][1].all()
    np.testing.assert_allclose(m12["depths"][1], 0.1, atol=1e-5)


def test_random_hulls_match_jax():
    """64 pairs of random 16-vertex hulls, float32, through K1/K2's plain
    versions and the hull manifold op."""
    rng = np.random.default_rng(1)
    p1, p2 = (fixtures.random_hulls(rng, 64, 16, 0.5) for _ in range(2))
    t1, t2 = torch.from_numpy(p1), torch.from_numpy(p2)
    r = gjkepa_batch_fused(t1, t2)
    query = (r.normal, r.depth, r.hit, r.contact_point)
    assert int(r.hit.sum()) >= 20
    ref = _jax(JAX_OPS["manifold_batch"](jnp.asarray(p1), jnp.asarray(p2),
                                 *(jnp.asarray(x.numpy()) for x in query),
                                 cfg=JaxConfig.for_f32()))
    _check(ref, _np(manifold_batch(t1, t2, *query)), F32, rows=0.9)


def test_hull_shape_matches_jax():
    """64 random hulls against the four kinds through K9/K10's plain
    versions; the fallback point is the default (the centroid of A's
    support polygon)."""
    hulls, shp = fixtures.hull_kind_pairs(5, 64, 16, 0.5)
    th = torch.from_numpy(hulls)
    ts = ShapeBatch.from_numpy(*shp, device="cpu")
    r = fused_gjkepa_hull_shapes(th, ts)
    query = (r.normal, r.depth, r.hit)
    assert int(r.hit.sum()) >= 20
    ref = _jax(JAX_OPS["manifold_hull_shape_batch"](
        jnp.asarray(hulls), JaxShapes(*(jnp.asarray(x) for x in shp)),
        *(jnp.asarray(x.numpy()) for x in query), cfg=JaxConfig.for_f32()))
    _check(ref, _np(manifold_hull_shape_batch(th, ts, *query)), F32)


def test_c4_pairs_take_the_bench_draw_order():
    """fixtures.c4_pairs: config 4's pairs as bench.py draws them after
    config 2's and config 3b's draws from its one generator (bench.py:141,
    :172-173, :258-268, :277-281), remade here with bench.py's own hull
    generator."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "bench_for_c4", Path(__file__).resolve().parents[1] / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    rng = np.random.default_rng(0)
    for b in (4096, 65536):                              # config 2
        bench.random_hulls(rng, b, 64)
        bench.random_hulls(rng, b, 64)
    bench.random_hulls(rng, 16384, 24)                   # config 3b: hulls,
    q = 4096                                             # then each kind's
    for params in ((q,), ((q, 3),), (q, q), (q, q)):     # parameters and
        for shape in params:                             # positions
            rng.random(shape)
        rng.normal(size=(q, 3))
    big = bench.random_hulls(rng, 16384, 24, spread=0.0) * 2.0
    small = bench.random_hulls(rng, 16384, 24, spread=0.0) * 0.5
    small += rng.normal(size=(16384, 1, 3)).astype(np.float32) * 0.2
    got = fixtures.c4_pairs()
    np.testing.assert_array_equal(got[0], big)
    np.testing.assert_array_equal(got[1], small)
