"""Contact derivation on analytic shapes and ``collide_shapes_batch_fused``
against the JAX package.

One JAX interpret-mode call (the end-to-end module fixture, 128 pairs).
Tolerances: with the same normals given to both sides, nearest points,
contact points and normals within 1e-6 and the contact type exact (only
last-bit differences of XLA:CPU's fused multiply-adds remain).  End to
end, the closed-form lanes carry the same normals to 1e-6 and are held the
same way, except that nearest points are compared by their support value
<p, n>: a box face along its own normal ties on all four corners, and a
last-bit difference in the normal picks another corner (7 of 17 lanes).
On polished EPA lanes the two normals differ by up to ~1e-3
(test_torch_fused_shapes.py), which moves a curved surface's support point
by about that angle times its radius: support values and contact points
within 1e-3 there (measured 3.1e-4 and 6.0e-4), the contact type exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu import collide_shapes_batch_fused as jax_collide
from gjkepa_tpu.models.shapes import ShapeBatch as JaxShapes
from gjkepa_tpu.ops.contact_shapes import (
    derive_contact_shapes_batch as jax_derive_contact_shapes_batch)
from gjkepa_tpu.ops.manifold import _first_k, _shape_support_polygon
from gjkepa_tpu_torch import (GJKEPAConfig, ShapeBatch,
                              collide_shapes_batch_fused)
from gjkepa_tpu_torch.models import fixtures
from gjkepa_tpu_torch.ops.contact_shapes import derive_contact_shapes_batch
from gjkepa_tpu_torch.ops.manifold import first_k, shape_support_polygon
from gjkepa_tpu_torch.ops.shape_geom import cf_kind_mask

torch.set_num_threads(1)

JAX_CFG = JaxConfig.for_f32()
CFG = GJKEPAConfig.from_reference(dataclasses.asdict(JAX_CFG))


def _jax(pairs):
    return tuple(JaxShapes(*(jnp.asarray(x) for x in p)) for p in pairs)


def _normals(pairs, n):
    """Even rows: the dominant axis of the centre offset (face contacts on
    the axis-aligned c3 boxes); odd rows: random unit vectors."""
    a, b = pairs
    d = (b[2] - a[2]).astype(np.float32)
    rows = np.arange(n)
    ax = np.argmax(np.abs(d), axis=1)
    axis = np.zeros_like(d)
    axis[rows, ax] = np.sign(d[rows, ax])
    rnd = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    rnd /= np.linalg.norm(rnd, axis=1, keepdims=True)
    return np.where((rows % 2 == 0)[:, None], axis, rnd).astype(np.float32)


def test_first_k_matches_jax():
    rng = np.random.default_rng(1)
    sel = rng.random((32, 21)) < 0.3
    pts = rng.normal(size=(32, 21, 3)).astype(np.float32)
    ref = jax.vmap(lambda s, p: _first_k(s, p, 8))(sel, pts)
    got = first_k(torch.from_numpy(sel), torch.from_numpy(pts), 8)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert bool(got[2].any()) and not bool(got[2].all())


@pytest.mark.parametrize("tol", [0.1, 1.0], ids=["support_set", "face_tol"])
def test_support_polygon_matches_jax(tol):
    pairs = fixtures.c3_pairs(2, 256)
    normal = _normals(pairs, 256)
    a = pairs[0]
    ref = jax.vmap(lambda k, p, x, r, n: _shape_support_polygon(
        k, p, x, r, n, tol, k=8))(*a, normal)
    got = shape_support_polygon(*ShapeBatch.from_numpy(*a, device="cpu"),
                                torch.from_numpy(normal), tol, 8)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-6)
    for x, y in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    sizes = set(got[1].sum(dim=1).tolist())
    assert {1, 2, 4, 8} <= sizes, sizes


@pytest.mark.parametrize("version", [1, 2, 3])
def test_derive_contact_shapes_matches_jax(version):
    """Both sides from the same normals (c3 pairs, identity rotations)."""
    pairs = fixtures.c3_pairs(2, 256)
    normal = _normals(pairs, 256)
    ref = jax_derive_contact_shapes_batch(*_jax(pairs), jnp.asarray(normal),
                                          JAX_CFG.replace(version=version))
    got = derive_contact_shapes_batch(
        *(ShapeBatch.from_numpy(*p, device="cpu") for p in pairs),
        torch.from_numpy(normal), CFG.replace(version=version))
    for name, x, y in zip(("nearest_points", "contact_point", "normal"),
                          got, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert set(got[3].tolist()) == {1, 2}
    if version == 2:
        # the fixture reaches every branch of the case tree
        ta, tb = (ShapeBatch.from_numpy(*p, device="cpu") for p in pairs)
        tn = torch.from_numpy(normal)
        n1 = shape_support_polygon(*ta, tn, CFG.support_set_tol)[1].sum(1)
        n2 = shape_support_polygon(*tb, -tn, CFG.support_set_tol)[1].sum(1)
        cases = torch.where(
            (n1 == 1) & (n2 == 1), 1, torch.where(
                (n1 == 1) | (n2 == 1), 2, torch.where(
                    (n1 == 2) & (n2 == 2), 3, torch.where(
                        (n1 == 2) | (n2 == 2), 4, 5))))
        assert set(cases.tolist()) == {1, 2, 3, 4, 5}


@pytest.fixture(scope="module")
def end_to_end():
    pairs = fixtures.mixed16_pairs(8, 0)
    ref = jax_collide(*_jax(pairs), cfg=JAX_CFG, interpret=True)
    ref = {f: np.asarray(x) for f, x in zip(ref._fields, ref)}
    got = collide_shapes_batch_fused(
        *(ShapeBatch.from_numpy(*p, device="cpu") for p in pairs), cfg=CFG)
    got = {f: x.numpy() for f, x in zip(got._fields, got)}
    cf = cf_kind_mask(*(torch.from_numpy(p[0]).float() for p in pairs))
    return ref, got, cf.numpy()


def test_collide_discrete_fields_match_jax(end_to_end):
    ref, got, _ = end_to_end
    for f in ("hit", "status"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    hit = got["hit"]
    assert 20 <= hit.sum() and not got["colli_type"][~hit].any()
    assert (got["colli_type"] == ref["colli_type"]).mean() >= 0.95
    assert not got["contact_point"][~hit].any()


def _support_values(r, lanes):
    """<nearest point, n> on A and <nearest point, -n> on B."""
    n = r["normal"][lanes]
    npts = r["nearest_points"][lanes]
    return np.stack([np.einsum("ij,ij->i", npts[:, 0], n),
                     -np.einsum("ij,ij->i", npts[:, 1], n)], 1)


@pytest.mark.parametrize("kind,atol", [("closed_form", 1e-6),
                                       ("polished", 1e-3)])
def test_collide_contact_rows_match_jax(end_to_end, kind, atol):
    ref, got, cf = end_to_end
    lanes = got["hit"] & (cf if kind == "closed_form" else ~cf)
    assert lanes.sum() >= 8
    np.testing.assert_array_equal(got["colli_type"][lanes],
                                  ref["colli_type"][lanes])
    np.testing.assert_allclose(got["contact_point"][lanes],
                               ref["contact_point"][lanes], rtol=0, atol=atol)
    np.testing.assert_allclose(_support_values(got, lanes),
                               _support_values(ref, lanes), rtol=0, atol=atol)
    if kind == "closed_form":
        for f in ("normal", "depth"):
            np.testing.assert_allclose(got[f][lanes], ref[f][lanes], rtol=0,
                                       atol=1e-6, err_msg=f)


def test_collide_known_geometry_and_devices():
    a = ShapeBatch.from_numpy(
        np.array([0, 1], np.int32),
        np.array([[1, 0, 0], [0.5, 0.5, 0.5]], np.float32),
        np.zeros((2, 3), np.float32),
        np.stack([np.eye(3, dtype=np.float32)] * 2), device="cpu")
    b = ShapeBatch(a.kind, a.params,
                   torch.tensor([[1.5, 0, 0], [0.7, 0.0, 0.0]]), a.rot)
    r = collide_shapes_batch_fused(a, b)
    assert bool(r.hit.all()) and float(r.depth[0]) == 0.5
    # spheres: midpoint of the two support points; box faces: type 2
    np.testing.assert_allclose(r.contact_point[0].numpy(), [0.75, 0, 0],
                               atol=1e-6)
    assert r.colli_type.tolist() == [1, 2]
    with pytest.raises(ValueError, match="is on meta"):
        collide_shapes_batch_fused(a, ShapeBatch(b.kind, b.params,
                                                 b.pos.to("meta"), b.rot))
