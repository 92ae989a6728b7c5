"""The portable path's geometry primitives (M1-M12, ``ops/geom.py``): the
port's batched functions against the JAX package's, vmapped, on seeded
float64 inputs, within 1e-12 (discrete results exactly), plus the JAX
suite's known-value cases through the port.

Each input set mixes generic values with the degenerate ones the
functions guard against: zero and tiny vectors, collinear triangles,
parallel lines, points on polygon edges, clockwise polygons, padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu.ops import geom as jg
from gjkepa_tpu_torch.ops import geom as tg

TOL = 1e-12
B = 64


def _rng(name):
    return np.random.default_rng(sum(map(ord, name)))


def _both(jfn, tfn, *arrays, in_axes=0):
    ref = jax.vmap(jfn, in_axes=in_axes)(*(jnp.asarray(a) for a in arrays))
    got = tfn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))
    return np.asarray(ref), got.numpy()


def _close(ref, got):
    assert ref.shape == got.shape and ref.dtype == got.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def _vectors(rng):
    v = rng.normal(size=(B, 3))
    v[:4] = [[0, 0, 0], [1e-13, 0, 0], [3, 0, 4], [0, 0, -2]]
    return v


def _triangles(rng):
    t = rng.normal(size=(B, 3, 3))
    t[:3] = [[[0, 0, 0], [1, 0, 0], [2, 0, 0]],        # collinear
             [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
             [[1, 1, 1], [1, 1, 1], [1, 1, 1]]]        # one point
    return t


def test_cross3_utzvec_match_jax():
    rng = _rng("cross")
    a, b = _vectors(rng), rng.normal(size=(B, 3))
    _close(*_both(jg.cross3, tg.cross3, a, b))
    _close(*_both(jg.utzvec, tg.utzvec, a))


def test_uninml_and_dist_pf_sign_match_jax():
    rng = _rng("plane")
    tri, p = _triangles(rng), rng.normal(size=(B, 3))
    _close(*_both(jg.uninml, tg.uninml, tri))
    _close(*_both(jg.dist_pf_sign, tg.dist_pf_sign, p, tri))


def test_vec_pl_and_foot_pl_match_jax():
    rng = _rng("line")
    line, p = rng.normal(size=(B, 2, 3)), rng.normal(size=(B, 3))
    line[0] = [[1, 1, 1], [1, 1, 1]]                   # degenerate line
    p[1] = line[1, 0]                                  # point on the line
    _close(*_both(jg.vec_pl, tg.vec_pl, p, line))
    _close(*_both(jg.foot_pl, tg.foot_pl, p, line))


def test_foot_ll_matches_jax():
    rng = _rng("foot_ll")
    l1, l2 = rng.normal(size=(B, 2, 3)), rng.normal(size=(B, 2, 3))
    l2[0] = l1[0] + [0, 2, 0]                          # parallel
    l2[1] = [[0, 1, 1], [0, -1, 1]]
    l1[1] = [[0, 0, 0], [1, 0, 0]]
    _close(*_both(jg.foot_ll, tg.foot_ll, l1, l2))


def _polygons(rng, k=6):
    """Convex planar polygons in order, some clockwise, some in the XZ
    plane, with a point inside, outside or on an edge, and a valid count."""
    ang = np.sort(rng.random((B, k)) * 2 * np.pi, 1)
    poly = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
    poly[1::4] = poly[1::4, ::-1]                      # clockwise
    poly[2::4] = poly[2::4][..., [0, 2, 1]]            # XZ plane
    basis = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    poly[3::4] = poly[3::4] @ basis.T                  # tilted
    n = rng.integers(3, k + 1, size=B)
    w = rng.random((B, 3))
    p = (w[:, :, None] * poly[:, :3]).sum(1) / w.sum(1)[:, None]
    p[::3] *= 3.0                                      # outside
    p[5] = (poly[5, 0] + poly[5, 1]) / 2               # on an edge
    return poly, p, n


def test_is_inside_pf_matches_jax():
    poly, p, n = _polygons(_rng("inside"))
    ref = jax.vmap(jg.is_inside_pf)(jnp.asarray(poly), jnp.asarray(p),
                                    jnp.asarray(n))
    got = tg.is_inside_pf(torch.from_numpy(poly), torch.from_numpy(p),
                          torch.from_numpy(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.sum() < B


def test_point_in_simplex_matches_jax():
    rng = _rng("simplex")
    s, p = rng.normal(size=(B, 4, 3)), rng.normal(size=(B, 3)) * 0.5
    s[0] = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]
    p[0] = [0.2, 0.2, 0.0]                             # on a face
    s[1], p[1] = s[0], [2.0, 2.0, 0.0]                 # in its plane, outside
    s[2, 3] = s[2, 0]                                  # flat tetrahedron
    ref, got = _both(jg.point_in_simplex, tg.point_in_simplex, p, s)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < B and got[0] and not got[1]


def test_overlap_matches_jax():
    rng = _rng("overlap")
    pts = np.repeat(rng.normal(size=(B, 1, 3)), 4, 1)
    pts[::2, 2, 1] += 1e-6
    valid = rng.random((B, 4)) < 0.7
    valid[:, 0] = True
    ref = jax.vmap(jg.overlap)(jnp.asarray(pts), jnp.asarray(valid))
    got = tg.overlap(torch.from_numpy(pts), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jax.vmap(jg.overlap)(jnp.asarray(pts))
    np.testing.assert_array_equal(tg.overlap(torch.from_numpy(pts)).numpy(),
                                  np.asarray(ref))


def test_counting_argsort_matches_jax():
    x = _rng("argsort").integers(0, 5, size=(B, 12)).astype(np.float64)
    x[0] = np.inf
    ref, got = _both(jg.counting_argsort, tg.counting_argsort, x)
    np.testing.assert_array_equal(got, ref)


def test_sort_clock_indices_matches_jax():
    rng = _rng("clock")
    poly, _, n = _polygons(rng, k=8)
    perm = np.argsort(rng.random((B, 8)), 1)
    pts = np.take_along_axis(poly, perm[..., None], 1)
    pts[0] = 1.5                                       # all coincident
    ref = jax.vmap(jg.sort_clock_indices)(jnp.asarray(pts), jnp.asarray(n))
    got = tg.sort_clock_indices(torch.from_numpy(pts), torch.from_numpy(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- the JAX suite's known values, through the port ---------------------------

def _t(x):
    return torch.tensor(x, dtype=torch.float64)


def test_known_values():
    np.testing.assert_allclose(tg.utzvec(_t([3.0, 0, 4])), [0.6, 0, 0.8],
                               atol=TOL)
    assert not tg.utzvec(_t([1e-13] * 3)).any()
    tri = _t([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    np.testing.assert_allclose(tg.uninml(tri), [0, 0, 1], atol=TOL)
    assert float(tg.dist_pf_sign(_t([0.0, 0, 2.5]), tri)) == \
        pytest.approx(2.5)
    np.testing.assert_allclose(
        tg.vec_pl(_t([0.0, 0, 0]), _t([[0.0, 1, 0], [1.0, 1, 0]])),
        [0, 1, 0], atol=TOL)
    feet = tg.foot_ll(_t([[0.0, 0, 0], [1.0, 0, 0]]),
                      _t([[0.0, 2, 0], [1.0, 2, 0]]))
    np.testing.assert_allclose(feet, [[0.5, 0, 0], [0.5, 2, 0]], atol=TOL)
    sq_cw = _t([[0.0, 1, 0], [1, 1, 0], [1, 0, 0], [0, 0, 0]])
    assert bool(tg.is_inside_pf(sq_cw, _t([0.5, 0.5, 0.0])))
    pad = _t([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [99.0, 99, 99]])
    assert not bool(tg.is_inside_pf(pad, _t([0.9, 0.9, 0.0]), n_valid=3))
    order = tg.sort_clock_indices(
        _t([[1.0, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0], [50.0, 50, 50]]),
        4)
    assert set(order[:4].tolist()) == {0, 1, 2, 3} and order[0] == 0
