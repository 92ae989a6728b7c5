"""The port's shape models, analytic supports and the plain K3/K4 device
functions against the JAX package (no interpret-mode calls here).

Tolerances: float results 1e-6 absolute (both sides are float32; XLA:CPU
fuses multiply-adds, the port rounds every op); discrete results (kind
masks, broadphase, closed-form status) exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.models import shapes as jshapes
from gjkepa_tpu.ops import fused as jfused
from gjkepa_tpu.ops import support as jsup
from gjkepa_tpu_torch import (ShapeBatch, boxes, capsules, concat_shapes,
                              cylinders, spheres)
from gjkepa_tpu_torch.models import fixtures, make_shape_pair_support
from gjkepa_tpu_torch.models import shape_support_world
from gjkepa_tpu_torch.ops import shape_geom, support
from gjkepa_tpu_torch.ops.lane_geom import P3
from tests.test_shapes import _batch_of_kind, _mixed_16combo_pair

torch.set_num_threads(1)

TOL = JaxConfig.for_f32().broadphase_tol


def _jax_batch(arrays):
    return jshapes.ShapeBatch(*(jnp.asarray(x) for x in arrays))


def _np(batch):
    return tuple(np.asarray(x) for x in batch)


def _dirs(rng, n):
    """Random directions with some exactly zero components (sign ties)."""
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::5, 0] = 0.0
    d[1::7, 2] = 0.0
    d[2::11, :2] = 0.0
    return d


def test_mixed16_recipe_equals_jax_fixture():
    a, b = fixtures.mixed16_pairs(3, 9)
    ja, jb = _mixed_16combo_pair(3, 9)
    for x, y in zip(a + b, _np(ja) + _np(jb)):
        np.testing.assert_array_equal(x, y)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(
        np.concatenate([x.reshape(len(x), -1).astype(np.float64) for x in
                        fixtures.kind_batch(3, 7, rng, spread=0.2)], 1),
        np.concatenate([np.asarray(x).reshape(7, -1).astype(np.float64)
                        for x in _batch_of_kind(3, 7, jrng, spread=0.2)], 1))


def test_c3_recipe_equals_bench_construction():
    """bench.py:203-212 through the JAX constructors, at 4 x 8 pairs."""
    a, b = fixtures.c3_pairs(0, 32)
    rng = np.random.default_rng(0)
    q = 8

    def mk3():
        def pos():
            return rng.normal(size=(q, 3)).astype(np.float32) * 1.2

        return jshapes.concat_shapes(
            jshapes.spheres(0.4 + 0.4 * rng.random(q).astype(np.float32),
                            pos=pos()),
            jshapes.boxes(0.3 + 0.4 * rng.random((q, 3)).astype(np.float32),
                          pos=pos()),
            jshapes.capsules(0.2 + 0.2 * rng.random(q).astype(np.float32),
                             0.3 + 0.3 * rng.random(q).astype(np.float32),
                             pos=pos()),
            jshapes.cylinders(0.2 + 0.3 * rng.random(q).astype(np.float32),
                              0.3 + 0.3 * rng.random(q).astype(np.float32),
                              pos=pos()))

    ja, jb = mk3(), mk3()
    perm = rng.permutation(32)
    for x, y in zip(a + b, _np(ja) + _np(jb)):
        np.testing.assert_array_equal(x, y)
    sa, sb, sperm = fixtures.c3_shuffled(0, 32)
    np.testing.assert_array_equal(sperm, perm)
    for x, y in zip(sa + sb, _np(ja) + _np(jb)):
        np.testing.assert_array_equal(x, y[perm])


def test_constructors_and_packing_match_jax():
    rng = np.random.default_rng(1)
    r = rng.random(4).astype(np.float32)
    h = rng.random((4, 3)).astype(np.float32)
    pos = rng.normal(size=(4, 3)).astype(np.float32)
    cpu = {"device": "cpu"}
    got = concat_shapes(spheres(r, pos=pos, **cpu), boxes(h, **cpu),
                        capsules(r, r * 2, **cpu),
                        cylinders(r, r, pos=pos, **cpu))
    ref = jshapes.concat_shapes(jshapes.spheres(r, pos=pos), jshapes.boxes(h),
                                jshapes.capsules(r, r * 2),
                                jshapes.cylinders(r, r, pos=pos))
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    carried = ShapeBatch.from_numpy(*_np(ref), device="cpu")
    np.testing.assert_array_equal(carried.packed().numpy(),
                                  np.asarray(jfused._pack_rows(ref))[:, :16])


@pytest.mark.parametrize("kind", ["sphere", "box", "capsule", "cylinder"])
def test_analytic_supports_match_jax(kind):
    rng = np.random.default_rng(2)
    d = _dirs(rng, 200)
    p = (0.2 + rng.random((200, 3))).astype(np.float32)
    td, tp = torch.from_numpy(d), torch.from_numpy(p)
    if kind == "sphere":
        got = support.sphere_support(td, tp[:, 0])
        ref = jax.vmap(jsup.sphere_support)(d, p[:, 0])
    elif kind == "box":
        got = support.box_support(td, tp)
        ref = jax.vmap(jsup.box_support)(d, p)
    elif kind == "capsule":
        got = support.capsule_support(td, tp[:, 0], tp[:, 1])
        ref = jax.vmap(jsup.capsule_support)(d, p[:, 0], p[:, 1])
    else:
        got = support.cylinder_support(td, tp[:, 0], tp[:, 1])
        ref = jax.vmap(jsup.cylinder_support)(d, p[:, 0], p[:, 1])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_shape_support_world_and_pair_support_match_jax():
    a, b = fixtures.mixed16_pairs(8, 4)
    d = _dirs(np.random.default_rng(4), 128)
    ref = jax.vmap(jshapes.shape_support_world)(*a, d)
    got = shape_support_world(*ShapeBatch.from_numpy(*a, device="cpu"),
                              torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    ref = jax.vmap(lambda *x: jshapes.make_shape_pair_support(*x[:8])(x[8]))(
        *a, *b, d)
    support = make_shape_pair_support(ShapeBatch.from_numpy(*a, device="cpu"),
                                      ShapeBatch.from_numpy(*b, device="cpu"))
    got = support(torch.from_numpy(d))
    for x, y in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-6)


def _packed_pair(a, b):
    """Both packings of a pair: the port's (B, 16) rows as Shapes, JAX's
    (16, B) kernel rows."""
    ta, tb = (ShapeBatch.from_numpy(*x, device="cpu") for x in (a, b))
    ja = jnp.asarray(np.asarray(jfused._pack_rows(_jax_batch(a))).T)
    jb = jnp.asarray(np.asarray(jfused._pack_rows(_jax_batch(b))).T)
    return (shape_geom.shape_of(ta.packed()), shape_geom.shape_of(tb.packed()),
            ja, jb)


def test_k3_support_radius_broadphase_match_jax():
    a, b = fixtures.mixed16_pairs(16, 6)
    sa, sb, ja, jb = _packed_pair(a, b)
    d = _dirs(np.random.default_rng(6), 256)
    jd = jfused.P3(*(jnp.asarray(d[None, :, k]) for k in range(3)))
    td = P3(*(torch.from_numpy(d[:, k].copy()) for k in range(3)))
    ref = jfused._make_shape_support(ja, jb)(jd)
    got = shape_geom.make_shape_support(sa, sb)(td)
    for x, y in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y)[0], rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(shape_geom.shape_radius(sa).numpy(),
                               np.asarray(jfused._shape_radius(ja))[0],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        shape_geom.shape_broadphase(sa, sb, TOL).numpy(),
        np.asarray(jfused._shape_broadphase(ja, jb, TOL))[0])
    np.testing.assert_array_equal(
        shape_geom.cf_kind_mask(sa.kind, sb.kind).numpy(),
        np.asarray(jfused._cf_kind_mask(ja, jb))[0])


@pytest.mark.parametrize("seed,spread", [(7, 0.9), (8, 0.3)],
                         ids=["spread", "deep"])
def test_k4_closed_forms_match_jax_rows_and_pairs(seed, spread):
    """Plain K4 against the JAX kernel's ``_closed_form_rows`` (packed rows,
    outside a kernel) and its XLA oracle ``_closed_form_shape_pairs``:
    closed-form kind and status exact, depth/normal/gap within 1e-6."""
    rng = np.random.default_rng(seed)
    a = fixtures.concat(*[fixtures.kind_batch(k, 16, rng, spread)
                          for k in range(4) for _ in range(4)])
    b = fixtures.concat(*[fixtures.kind_batch(k, 16, rng, spread)
                          for _ in range(4) for k in range(4)])
    sa, sb, ja, jb = _packed_pair(a, b)
    got = shape_geom.closed_form_rows(sa, sb, TOL)
    fin, depth, n, gap, status = jfused._closed_form_rows(ja, jb, TOL, 256)
    fin = np.asarray(fin)[0]
    np.testing.assert_array_equal(got.final.numpy(), fin)
    assert fin.sum() == 9 * 16
    np.testing.assert_array_equal(got.status.numpy()[fin],
                                  np.asarray(status)[0][fin])
    for x, y in ((got.depth, depth), (got.gap, gap), *zip(got.normal, n)):
        np.testing.assert_allclose(x.numpy()[fin], np.asarray(y)[0][fin],
                                   rtol=0, atol=1e-6)
    handled, hit, pdepth, pnormal, pgap, pstatus = (
        np.asarray(x) for x in jfused._closed_form_shape_pairs(
            _jax_batch(a), _jax_batch(b), TOL))
    np.testing.assert_array_equal(handled, fin)
    np.testing.assert_array_equal(got.status.numpy()[fin], pstatus[fin])
    np.testing.assert_allclose(got.depth.numpy()[fin], pdepth[fin], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.gap.numpy()[fin], pgap[fin], rtol=0,
                               atol=1e-6)
    gn = torch.stack(list(got.normal), 1).numpy()
    np.testing.assert_allclose(gn[fin], pnormal[fin], rtol=0, atol=1e-6)
    assert 0 < int(hit.sum()) < fin.sum()


@pytest.mark.parametrize("make", [
    lambda: ShapeBatch.from_numpy(*fixtures.mixed16_pairs(1, 0)[0]),
    lambda: spheres([1.0]),
    lambda: boxes([[0.5, 0.5, 0.5]]),
    lambda: capsules([0.3], [0.5]),
    lambda: cylinders([0.3], [0.5]),
], ids=["from_numpy", "spheres", "boxes", "capsules", "cylinders"])
def test_constructors_default_to_the_card(make):
    """Shapes land on the card unless the caller names another device;
    without a card the constructor raises rather than fall back."""
    if torch.cuda.is_available():
        assert make().kind.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            make()


def test_hull_support_matches_jax():
    """The hull support with its witnesses, masked rows excluded, against
    ``ops/support.py``'s ``minkowski_support_hulls``."""
    rng = np.random.default_rng(6)
    p1 = rng.normal(size=(64, 9, 3)).astype(np.float32)
    p2 = rng.normal(size=(64, 7, 3)).astype(np.float32)
    m1 = np.arange(9)[None, :] < rng.integers(1, 10, size=64)[:, None]
    d = _dirs(rng, 64)
    ref = jax.vmap(jsup.minkowski_support_hulls)(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(d), jnp.asarray(m1),
        None)
    got = support.make_hull_support(torch.from_numpy(p1),
                                    torch.from_numpy(p2),
                                    torch.from_numpy(m1))(torch.from_numpy(d))
    for f, x, y in zip(got._fields, got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f)
