"""The port's hull utilities (``gjkepa_tpu_torch.utils.hull``): the JAX
suite's ``tests/test_hull.py`` through the port's own loader of the C++
QuickHull, and the port against the JAX package's functions on the same
clouds (the same library, so the same faces and vertices)."""

import numpy as np
import pytest

from gjkepa_tpu.utils import hull as JH
from gjkepa_tpu_torch.utils import hull as H


def test_cube_hull_is_corners(rng):
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], float)
    pts = np.vstack([corners, rng.uniform(-0.9, 0.9, size=(50, 3))])
    rng.shuffle(pts)
    faces, vidx = H.convex_hull(pts)
    assert len(vidx) == 8
    np.testing.assert_allclose(np.sort(np.abs(pts[vidx]).ravel()), 1.0)
    assert len(faces) == 2 * len(vidx) - 4


def test_native_matches_scipy_and_jax(rng):
    assert H.native_available()
    for _ in range(10):
        pts = rng.normal(size=(40, 3))
        f_nat, v_nat = H.convex_hull(pts, backend="native")
        _, v_sci = H.convex_hull(pts, backend="scipy")
        assert set(v_nat.tolist()) == set(v_sci.tolist())
        f_jax, v_jax = JH.convex_hull(pts, backend="native")
        np.testing.assert_array_equal(f_nat, f_jax)
        np.testing.assert_array_equal(v_nat, v_jax)


def test_convex_hull_batch(rng):
    pts = rng.normal(size=(8, 24, 3))
    res = H.convex_hull_batch(pts)
    ref = JH.convex_hull_batch(pts)
    assert len(res) == 8
    for (faces, vidx), (rf, rv) in zip(res, ref):
        assert len(faces) == 2 * len(vidx) - 4 and faces.max() < 24
        np.testing.assert_array_equal(faces, rf)
        np.testing.assert_array_equal(vidx, rv)
    sci = H.convex_hull_batch(pts, backend="scipy")
    for (_, vidx), (_, sv) in zip(res, sci):
        assert set(vidx.tolist()) == set(sv.tolist())


def test_hull_vertices_strips_interior(rng):
    sphere = rng.normal(size=(20, 3))
    sphere /= np.linalg.norm(sphere, axis=1, keepdims=True)
    pts = np.vstack([sphere, rng.uniform(-0.3, 0.3, size=(30, 3))])
    hv = H.hull_vertices(pts)
    assert len(hv) <= 20
    np.testing.assert_allclose(np.linalg.norm(hv, axis=1), 1.0, atol=1e-9)
    np.testing.assert_array_equal(hv, JH.hull_vertices(pts))


def test_degenerate_input_raises():
    flat = np.zeros((10, 3))
    flat[:, 0] = np.arange(10)  # collinear
    with pytest.raises(ValueError):
        H.convex_hull(flat)
    with pytest.raises(ValueError, match="backend"):
        H.convex_hull(np.eye(4, 3), backend="qhull")


def test_dedup_vertices():
    soup = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                     [[1, 0, 0], [0, 1, 0], [0, 0, 1]]], float)
    assert H.dedup_vertices(soup).shape == (4, 3)
    soup2 = soup.copy()
    soup2[1, 0, 0] += 1e-9
    assert H.dedup_vertices(soup2, tol=1e-6).shape == (4, 3)
    np.testing.assert_array_equal(H.dedup_vertices(soup2, tol=1e-6),
                                  JH.dedup_vertices(soup2, tol=1e-6))


def test_pad_hulls_repeats_first_vertex(rng):
    hs = [rng.normal(size=(k, 3)) for k in (5, 9, 3)]
    padded, mask = H.pad_hulls(hs, pad_to=10)
    assert padded.shape == (3, 10, 3) and mask.shape == (3, 10)
    np.testing.assert_array_equal(mask.sum(axis=1), [5, 9, 3])
    np.testing.assert_allclose(padded[2, 3:], np.tile(hs[2][0], (7, 1)),
                               rtol=1e-6)
    ref = JH.pad_hulls(hs, pad_to=10)
    np.testing.assert_array_equal(padded, ref[0])
    np.testing.assert_array_equal(mask, ref[1])
    with pytest.raises(ValueError):
        H.pad_hulls(hs, pad_to=4)
