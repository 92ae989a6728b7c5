"""The fused hull-vs-shape query (K9, K10 and the dispatch): the port's
plain path against the JAX fused path in interpret mode, and port-only
checks of the dispatch and of the depth contract.

One JAX interpret-mode call (the module fixture:
``tests/test_mixed_fused.py``'s ``_mixed_fixture(rng, 128)``).  Tolerances
against JAX:

  * hit and status exact; ``gjk_iters`` equal on >= 95% of lanes (XLA:CPU
    fuses multiply-adds, the port rounds every op);
  * depth within 1e-4 on >= 95% of hits and 5e-3 on all (the capped EPA
    and the polish end on the same support descent; a last-bit difference
    can move it by one grid step), normals dot > 0.99 on every hit;
  * distance on the other lanes (GJK misses and retired lanes) within 1e-5
    on >= 95% and 5e-5 on all: on GJK-miss lanes it is the largest
    -<w, d> along the GJK path, which the same rounding differences move.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.models.shapes import ShapeBatch as JaxShapes
from gjkepa_tpu.ops import fused as jfused
from gjkepa_tpu_torch import GJKEPAConfig, ShapeBatch, Status, _build
from gjkepa_tpu_torch.models import fixtures
from gjkepa_tpu_torch.ops import fused_hull_shapes as fh
from gjkepa_tpu_torch.ops import shape_geom
from gjkepa_tpu_torch.ops.fused import fused_gjkepa_hull_shapes
from gjkepa_tpu_torch.ops.fused_shapes import shape_stages

torch.set_num_threads(1)

JAX_CFG = JaxConfig.for_f32()
CFG = GJKEPAConfig.from_reference(dataclasses.asdict(JAX_CFG))
EYE = np.eye(3, dtype=np.float32)


def _mixed_fixture(rng, b, n=16, spread=0.7):
    """tests/test_mixed_fused.py's ``_mixed_fixture`` in numpy: hulls, then
    a quarter each of spheres, boxes, capsules and cylinders."""
    p1 = fixtures.random_hulls(rng, b, n, spread=spread)
    q = b // 4

    def u(lo, width, shape=q):
        return (lo + width * rng.random(shape)).astype(np.float32)

    def pos():
        return rng.normal(size=(q, 3)).astype(np.float32) * 0.7

    def col3(*cols):
        return np.stack(cols + (np.zeros(q, np.float32),) * (3 - len(cols)),
                        axis=1)

    params, where = [], []
    params.append(col3(u(0.3, 0.4)))
    where.append(pos())
    params.append(u(0.25, 0.3, (q, 3)))
    where.append(pos())
    for r, h in ((0.2, 0.2), (0.2, 0.25)):
        rad, half = u(r, h), u(0.25, 0.25)
        params.append(col3(rad, half))
        where.append(pos())
    kind = np.repeat(np.arange(4, dtype=np.int32), q)
    return p1, (kind, np.concatenate(params), np.concatenate(where),
                np.stack([EYE] * b))


def _port(p1, shapes, **kw):
    return fused_gjkepa_hull_shapes(torch.from_numpy(p1),
                                    ShapeBatch.from_numpy(*shapes,
                                                          device="cpu"),
                                    **{"cfg": CFG, **kw})


@pytest.fixture(scope="module")
def mixed():
    p1, shapes = _mixed_fixture(np.random.default_rng(0), 128)
    ref = jfused.fused_gjkepa_hull_shapes(
        jnp.asarray(p1), JaxShapes(*(jnp.asarray(x) for x in shapes)),
        cfg=JAX_CFG, block=128, interpret=True)
    ref = {f: np.asarray(x) for f, x in zip(ref._fields, ref)}
    got = _port(p1, shapes)
    return p1, shapes, ref, {f: x.numpy() for f, x in zip(got._fields, got)}


def test_discrete_fields_match_jax(mixed):
    *_, ref, got = mixed
    for f in ("hit", "status"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    assert 10 <= got["hit"].sum() <= 100
    assert (got["gjk_iters"] == ref["gjk_iters"]).mean() >= 0.95
    assert (got["epa_iters"][got["hit"]] > 0).all()


def test_depth_and_normal_match_jax(mixed):
    *_, ref, got = mixed
    hit = got["hit"]
    err = np.abs(got["depth"] - ref["depth"])[hit]
    assert (err <= 1e-4).mean() >= 0.95 and err.max() <= 5e-3, err.max()
    dots = np.einsum("ij,ij->i", got["normal"], ref["normal"])[hit]
    assert dots.min() > 0.99, dots.min()
    assert not got["depth"][~hit].any() and not got["normal"][~hit].any()


def test_distance_and_retirement_match_jax(mixed):
    """Retired lanes (a certified sphere-envelope miss: MISS_BROADPHASE with
    a positive distance) are the same on both sides, and the miss distance
    agrees."""
    *_, ref, got = mixed

    def retired(r):
        return (r["status"] == Status.MISS_BROADPHASE) & (r["distance"] > 0)

    assert retired(got).sum() >= 10
    np.testing.assert_array_equal(retired(got), retired(ref))
    miss = ~got["hit"]
    err = np.abs(got["distance"] - ref["distance"])[miss]
    assert (err <= 1e-5).mean() >= 0.95 and err.max() <= 5e-5, err.max()


def test_retirement_gap_is_the_closed_form_gap():
    """``sphere_gap`` is ``closed_form_rows``' gap of a sphere against
    every kind, bit for bit, on the 16 kind combinations' side B."""
    _, b = fixtures.mixed16_pairs(8, 4)
    sb = shape_geom.shape_of(ShapeBatch.from_numpy(*b, device="cpu")
                             .packed())
    rng = np.random.default_rng(4)
    n = b[0].shape[0]
    virt = np.concatenate([np.zeros((n, 1)), rng.random((n, 1)) + 0.2,
                           np.zeros((n, 2)), rng.normal(size=(n, 3)),
                           np.tile(EYE.reshape(1, 9), (n, 1))], 1)
    sa = shape_geom.shape_of(torch.from_numpy(virt.astype(np.float32)))
    cf = shape_geom.closed_form_rows(sa, sb, CFG.broadphase_tol)
    assert bool(cf.final.all())
    assert torch.equal(shape_geom.sphere_gap(sa, sb), cf.gap)


@pytest.mark.parametrize("case", ["mixed", "c3b"])
def test_sort_hits_true_equals_false(case):
    if case == "mixed":
        p1, shapes = _mixed_fixture(np.random.default_rng(2), 256)
    else:
        hulls, shapes = fixtures.c3b_pairs()
        p1, shapes = hulls[::32], tuple(x[::32] for x in shapes)
    r1, r2 = _port(p1, shapes, sort_hits=True), _port(p1, shapes,
                                                      sort_hits=False)
    for f, x, y in zip(r1._fields, r1, r2):
        assert torch.equal(x, y), f
    assert int(r1.hit.sum()) >= 20


def test_masked_hull_equals_repeated_vertex_padding():
    rng = np.random.default_rng(5)
    p1, shapes = _mixed_fixture(rng, 64)
    keep = torch.arange(16)[None, :] < torch.from_numpy(
        rng.integers(4, 17, size=64))[:, None]
    t1 = torch.from_numpy(p1)
    padded = torch.where(keep[:, :, None], t1, t1[:, :1])
    sh = ShapeBatch.from_numpy(*shapes, device="cpu")
    r1 = fused_gjkepa_hull_shapes(t1, sh, mask1=keep, cfg=CFG)
    r2 = fused_gjkepa_hull_shapes(padded, sh, cfg=CFG)
    for f, x, y in zip(r1._fields, r1, r2):
        assert torch.equal(x, y), f
    assert int(r1.hit.sum()) >= 5


def test_hull_sphere_exact_depth():
    """Hull-vs-sphere depth against the exact answer by convex projection
    (scipy): r - dist(centre, hull) outside, r + clearance inside."""
    spatial = pytest.importorskip("scipy.spatial")
    from scipy.optimize import minimize

    rng = np.random.default_rng(0)
    b = 32
    p1 = fixtures.random_hulls(rng, b, 16, spread=0.5)
    radius = (0.4 + 0.4 * rng.random(b)).astype(np.float32)
    centre = rng.normal(size=(b, 3)).astype(np.float32) * 0.5
    shapes = (np.zeros(b, np.int32),
              np.stack([radius, 0 * radius, 0 * radius], 1), centre,
              np.stack([EYE] * b))
    r = _port(p1, shapes)

    def exact_depth(verts, c, rad):
        hull = spatial.ConvexHull(verts)
        a, off = hull.equations[:, :3], -hull.equations[:, 3]
        s = a @ c - off
        if (s <= 0).all():
            return rad + float(-s.max())
        res = minimize(lambda x: np.sum((x - c) ** 2), x0=verts.mean(0),
                       constraints=[{"type": "ineq",
                                     "fun": lambda x: off - a @ x}])
        return rad - float(np.linalg.norm(res.x - c))

    hits = np.nonzero(r.hit.numpy())[0]
    assert len(hits) >= 5
    for i in hits[:12]:
        want = exact_depth(p1[i].astype(np.float64),
                           centre[i].astype(np.float64), float(radius[i]))
        assert abs(float(r.depth[i]) - want) < 2e-3, (i, float(r.depth[i]),
                                                       want)


def test_separation_contract():
    """Translating the shape by depth * normal (+1e-3) separates every hit
    pair: the polished depth is realised along the reported normal."""
    p1, shapes = _mixed_fixture(np.random.default_rng(0), 64)
    r = _port(p1, shapes)
    idx = np.nonzero(r.hit.numpy())[0]
    assert len(idx) >= 8
    shift = r.normal.numpy()[idx] * (r.depth.numpy()[idx] + 1e-3)[:, None]
    moved = tuple(x[idx] for x in shapes)
    moved = moved[:2] + (moved[2] + shift,) + moved[3:]
    assert not bool(_port(np.ascontiguousarray(p1[idx]), moved).hit.any())


def test_boolean_mode():
    p1, shapes = _mixed_fixture(np.random.default_rng(0), 128)
    full = _port(p1, shapes)
    boolean = _port(p1, shapes, cfg=CFG.replace(epa_max_iters=0))
    assert torch.equal(boolean.hit, full.hit)
    assert torch.equal(boolean.distance, full.distance)
    assert not bool(boolean.depth.any()) and not bool(boolean.epa_iters.any())
    assert torch.equal(boolean.status[~full.hit], full.status[~full.hit])


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def no_build():
        raise AssertionError("kernel build attempted for CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    before = dict(fh.LAUNCHES)
    _port(*_mixed_fixture(np.random.default_rng(1), 32))
    assert fh.LAUNCHES == before


def _rows():
    p1, shapes = _mixed_fixture(np.random.default_rng(1), 8)
    p1 = torch.from_numpy(p1)
    sb = ShapeBatch.from_numpy(*shapes, device="cpu").packed()
    return p1, sb, fh.hull_shape_retirement(p1, sb, CFG).retired


@pytest.mark.parametrize("kernel", ["K9", "K10"])
def test_unsupported_device_raises(kernel):
    p1, sb, ret = (t.to("meta") for t in _rows())
    b = p1.shape[0]
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError,
                       match=f"no {kernel} kernel for device meta"):
        if kernel == "K9":
            fh.gjk_hull_shape(p1, sb, ret, torch.empty(b, **i32), CFG)
        else:
            fh.epa_hull_shape(p1, sb, torch.empty((b, 4, 3), device="meta"),
                              torch.empty(b, **i32), torch.empty(b, **i32),
                              torch.empty((), **i32), shape_stages(CFG))


def test_wrappers_reject_what_the_kernels_do_not_take():
    p1, sb, ret = _rows()
    order = torch.arange(p1.shape[0], dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        fh.gjk_hull_shape(p1.double(), sb, ret, order, CFG)
    with pytest.raises(ValueError, match="order"):
        fh.gjk_hull_shape(p1, sb, ret, order.long(), CFG)
    shifted = torch.zeros(sb.numel() + 1)[1:].view(sb.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fh.gjk_hull_shape(p1, shifted, ret, order, CFG)
    shapes = ShapeBatch.from_numpy(*_mixed_fixture(np.random.default_rng(1),
                                                   8)[1], device="cpu")
    with pytest.raises(ValueError, match="batch sizes differ"):
        fused_gjkepa_hull_shapes(p1[:4], shapes)
    with pytest.raises(ValueError, match="is on meta"):
        fused_gjkepa_hull_shapes(p1, ShapeBatch(shapes.kind, shapes.params,
                                                shapes.pos.to("meta"),
                                                shapes.rot))
