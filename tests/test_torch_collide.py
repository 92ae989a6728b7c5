"""The portable support-map queries: ``collide_supports``,
``collide_shapes_batch`` and ``collide_hull_shape_batch``, the port against
the JAX package's portable ones on the same numpy inputs (the 16 kind
pairs of ``fixtures.mixed16_pairs`` in float64; 16-vertex hulls against
the four kinds in float32; sphere pairs through a hand-written support).

Tolerances against JAX:

  * hit, status and contact type exact; GJK iterations exact on hits,
    EPA iterations on >= 95% of them (one float32 hit of 33 differs by
    one);
  * GJK iterations on misses within 3: on a curved pair the always-tetra
    GJK stops only when a vertex repeats within eps, and the iteration
    where that happens moves with the last bit (XLA:CPU fuses
    multiply-adds in the rotations where the port rounds each operation;
    measured on 15 of 256 lanes in float64, by 1-3); the miss distance, a
    lower bound from the probes made, within 1e-8 in float64 and 1e-3 in
    float32 on the lanes whose iterations agree;
  * depth within 1e-9 in float64 and 2e-5 in float32; the normal within
    1e-9 in float64 and 1e-2 in float32: on a sphere or a cylinder's side
    the polish's minimum is flat to second order, so a normal 1e-2 off
    moves the depth by less than the depth tolerance (measured on 2 of
    33 float32 hits);
  * nearest points (their support values) and the contact point (the
    witnesses' midpoint, its projection) along the normal, within the
    depth tolerance, where the two normals agree within it (>= 95% of
    lanes; a witness moves with the normal to first order): a hull or box
    face along the normal ties its corners, and which one the first
    maximum takes depends on rounding (6 of 33 float32 hits);
  * sphere pairs without a hint: EPA on a sphere runs to its cap along a
    path that rounding moves, and the polish lands within 1e-6 of the
    exact depth from where it starts: depth within 1e-6 of JAX's and of
    the exact answer, normals within 1e-5 of parallel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.api import collide_hull_shape_batch as jax_hull_shape
from gjkepa_tpu.api import collide_shapes_batch as jax_shapes
from gjkepa_tpu.api import collide_supports as jax_supports
from gjkepa_tpu.models.shapes import ShapeBatch as JaxShapes
from gjkepa_tpu.ops.support import SupportResult as JaxSupport
from gjkepa_tpu_torch import (GJKEPAConfig, ShapeBatch,
                              collide_hull_shape_batch, collide_shapes_batch,
                              collide_supports)
from gjkepa_tpu_torch.models import fixtures
from gjkepa_tpu_torch.ops.support import SupportResult

torch.set_num_threads(1)


def _port_cfg(jax_cfg):
    return GJKEPAConfig.from_reference(dataclasses.asdict(jax_cfg))


def _fields(r):
    return {f: np.asarray(x) for f, x in zip(r._fields, r)}


def _check(ref, got, tol, normal_tol, miss_tol):
    for f in ("hit", "status", "colli_type"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    hit = ref["hit"]
    assert hit.sum() >= 10 and (~hit).sum() >= 10
    np.testing.assert_array_equal(got["gjk_iters"][hit],
                                  ref["gjk_iters"][hit])
    assert (got["epa_iters"][hit] == ref["epa_iters"][hit]).mean() >= 0.95
    assert np.abs(got["gjk_iters"] - ref["gjk_iters"]).max() <= 3
    assert got["depth"].dtype == ref["depth"].dtype
    np.testing.assert_allclose(got["depth"], ref["depth"], rtol=0, atol=tol)
    np.testing.assert_allclose(got["normal"], ref["normal"], rtol=0,
                               atol=normal_tol)
    # the witnesses move with the normal to first order: where they agree
    agree = np.abs(got["normal"] - ref["normal"]).max(1) <= tol
    assert agree.mean() >= 0.95
    n = ref["normal"][agree]
    sides = n[:, None, :] * np.array([1.0, -1.0])[None, :, None]
    for f, w in (("nearest_points", sides), ("contact_point", n)):
        np.testing.assert_allclose((got[f][agree] * w).sum(-1),
                                   (ref[f][agree] * w).sum(-1), rtol=0,
                                   atol=tol, err_msg=f)
    same = got["gjk_iters"] == ref["gjk_iters"]
    assert same.mean() >= 0.9
    np.testing.assert_allclose(got["distance"][same], ref["distance"][same],
                               rtol=0, atol=miss_tol)


def test_collide_shapes_batch_matches_jax_f64():
    a, b = fixtures.mixed16_pairs(16, 3)
    jcfg = JaxConfig()
    ja, jb = (JaxShapes(jnp.asarray(x[0]),
                        *(jnp.asarray(np.asarray(y, np.float64))
                          for y in x[1:])) for x in (a, b))
    ref = _fields(jax_shapes(ja, jb, cfg=jcfg))
    ta, tb = (ShapeBatch.from_numpy(*x, device="cpu", dtype=torch.float64)
              for x in (a, b))
    got = collide_shapes_batch(ta, tb, cfg=_port_cfg(jcfg))
    _check(ref, _fields(got), 1e-9, 1e-9, 1e-8)
    # chunks give the same rows
    part = collide_shapes_batch(ta, tb, cfg=_port_cfg(jcfg), chunk_size=100)
    for x, y in zip(got, part):
        assert torch.equal(x, y)


def _hull_shape_inputs(rng, b=128):
    v = rng.normal(size=(b, 16, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= 0.5 + 0.5 * rng.random((b, 16, 1))
    hulls = (v + rng.normal(size=(b, 1, 3)) * 0.7).astype(np.float32)
    q = b // 4
    rr = rng.random((b, 3)).astype(np.float32)
    params = np.concatenate([
        np.stack([0.3 + 0.4 * rr[:q, 0], 0 * rr[:q, 0], 0 * rr[:q, 0]], 1),
        0.25 + 0.3 * rr[q:2 * q],
        np.stack([0.2 + 0.2 * rr[2 * q:, 0], 0.25 + 0.25 * rr[2 * q:, 1],
                  0 * rr[2 * q:, 0]], 1)]).astype(np.float32)
    kind = np.repeat(np.arange(4, dtype=np.int32), q)
    pos = (rng.normal(size=(b, 3)) * 0.7).astype(np.float32)
    rot = np.broadcast_to(np.eye(3, dtype=np.float32), (b, 3, 3)).copy()
    return hulls, (kind, params, pos, rot)


def test_collide_hull_shape_batch_matches_jax_f32():
    hulls, shp = _hull_shape_inputs(np.random.default_rng(4))
    mask = np.ones(hulls.shape[:2], bool)
    mask[::3, 12:] = False                      # some hulls of 12 vertices
    jcfg = JaxConfig.for_f32()
    ref = _fields(jax_hull_shape(jnp.asarray(hulls),
                                 JaxShapes(*(jnp.asarray(x) for x in shp)),
                                 jnp.asarray(mask), cfg=jcfg))
    got = collide_hull_shape_batch(torch.from_numpy(hulls),
                                   ShapeBatch.from_numpy(*shp, device="cpu"),
                                   torch.from_numpy(mask),
                                   cfg=_port_cfg(jcfg))
    _check(ref, _fields(got), 2e-5, 1e-2, 1e-3)


def test_collide_supports_spheres_match_jax():
    """Two spheres a pair through a hand-written support, no hint."""
    rng = np.random.default_rng(6)
    b = 64
    c1, c2 = rng.normal(size=(2, b, 3)) * 0.6
    r1, r2 = 0.3 + 0.5 * rng.random((2, b))

    def jax_one(c1, c2, r1, r2):
        def support(d):
            u = d / jnp.maximum(jnp.linalg.norm(d), 1e-300)
            a, bb = c1 + r1 * u, c2 - r2 * u
            return JaxSupport(a - bb, a, bb)
        return jax_supports(support, cfg=JaxConfig(), dtype=jnp.float64)
    ref = _fields(jax.jit(jax.vmap(jax_one))(
        *(jnp.asarray(x) for x in (c1, c2, r1, r2))))
    t1, t2, s1, s2 = (torch.from_numpy(x) for x in (c1, c2, r1, r2))

    def support(d):
        n = torch.sqrt((d * d).sum(1, keepdim=True))
        u = d / torch.clamp(n, min=1e-300)
        a, bb = t1 + s1[:, None] * u, t2 - s2[:, None] * u
        return SupportResult(a - bb, a, bb)
    got = _fields(collide_supports(support, GJKEPAConfig(), torch.float64,
                                   torch.ones(b, dtype=torch.bool)))
    for f in ("hit", "status", "colli_type"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    hit = ref["hit"]
    assert 10 <= hit.sum() < b
    # the exact answer: r1 + r2 - |c2 - c1| (the polish reaches it)
    exact = r1 + r2 - np.linalg.norm(c2 - c1, axis=1)
    np.testing.assert_allclose(got["depth"][hit], exact[hit], atol=1e-6)
    np.testing.assert_allclose(got["depth"], ref["depth"], rtol=0, atol=1e-6)
    align = (got["normal"][hit] * ref["normal"][hit]).sum(1)
    assert (align > 1.0 - 1e-5).all(), align.min()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_known_shape_depths(dtype):
    """Spheres at 1.5 give depth 0.5 exactly (the sphere-sphere closed
    form); a sphere on a box face and two boxes give their overlaps."""
    from gjkepa_tpu_torch import boxes, concat_shapes, spheres
    cfg = GJKEPAConfig() if dtype == torch.float64 else \
        GJKEPAConfig.for_f32()
    kw = dict(dtype=dtype, device="cpu")
    a = concat_shapes(spheres([1.0], pos=[[0, 0, 0]], **kw),
                      spheres([0.5], pos=[[0.9, 0.1, 0]], **kw),
                      boxes([[0.5, 0.5, 0.5]], pos=[[0, 0, 0]], **kw))
    b = concat_shapes(spheres([1.0], pos=[[1.5, 0, 0]], **kw),
                      boxes([[0.5, 0.5, 0.5]], pos=[[0, 0, 0]], **kw),
                      boxes([[0.5, 0.5, 0.5]], pos=[[0.7, 0.2, 0]], **kw))
    r = collide_shapes_batch(a, b, cfg=cfg)
    assert r.hit.all() and float(r.depth[0]) == 0.5
    np.testing.assert_allclose(r.depth.numpy(), [0.5, 0.1, 0.3], atol=2e-5)


def _shape_rows(side, dtype):
    return ShapeBatch.from_numpy(*side, device="cpu", dtype=dtype)


@pytest.mark.parametrize("entry", ["gjkepa_batch", "collide_shapes_batch",
                                   "collide_hull_shape_batch"])
def test_empty_batch_matches_jax(entry):
    """B = 0: every field at batch size 0 with JAX's trailing shape and
    dtype (float64)."""
    from gjkepa_tpu.api import gjkepa_batch as jax_gjkepa_batch
    from gjkepa_tpu_torch import gjkepa_batch
    hulls = np.zeros((0, 8, 3))
    side = (np.zeros(0, np.int32), np.zeros((0, 3)), np.zeros((0, 3)),
            np.zeros((0, 3, 3)))
    jshapes = JaxShapes(*(jnp.asarray(x) for x in side))
    tshapes = _shape_rows(side, torch.float64)
    ref, got = {
        "gjkepa_batch": lambda: (
            jax_gjkepa_batch(jnp.asarray(hulls), jnp.asarray(hulls)),
            gjkepa_batch(torch.from_numpy(hulls), torch.from_numpy(hulls))),
        "collide_shapes_batch": lambda: (
            jax_shapes(jshapes, jshapes),
            collide_shapes_batch(tshapes, tshapes)),
        "collide_hull_shape_batch": lambda: (
            jax_hull_shape(jnp.asarray(hulls), jshapes),
            collide_hull_shape_batch(torch.from_numpy(hulls), tshapes)),
    }[entry]()
    for f, r in _fields(ref).items():
        g = getattr(got, f)
        assert tuple(g.shape) == r.shape and r.shape[0] == 0, f
        assert str(g.dtype).removeprefix("torch.") == str(r.dtype), f


def test_collide_supports_without_active_on_cpu():
    """No ``active``: the batch size comes from a probe on the device the
    caller names, and the rows equal those of an explicit all-True mask;
    ``active=False`` retires every lane, as in the JAX package."""
    rng = np.random.default_rng(6)
    b = 32
    t1, t2 = (torch.from_numpy(x) for x in rng.normal(size=(2, b, 3)) * 0.6)
    s1, s2 = (torch.from_numpy(x) for x in 0.3 + 0.5 * rng.random((2, b)))

    def support(d):
        n = torch.sqrt((d * d).sum(1, keepdim=True))
        u = d / torch.clamp(n, min=1e-300)
        a, bb = t1 + s1[:, None] * u, t2 - s2[:, None] * u
        return SupportResult(a - bb, a, bb)

    cfg = GJKEPAConfig()
    want = collide_supports(support, cfg, torch.float64,
                            torch.ones(b, dtype=torch.bool))
    got = collide_supports(support, cfg, torch.float64, device="cpu")
    assert 0 < int(want.hit.sum()) < b
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    off = collide_supports(support, cfg, torch.float64, active=False,
                           device="cpu")
    assert not off.hit.any() and (off.status == 0).all()
    assert off.status.shape == (b,)
