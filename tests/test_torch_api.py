"""The port's full-surface query: contact rows (versions 1, 2, 3, masks)
and gjkepa_batch_fused end to end, against the JAX package on the same
numpy inputs.

Tolerances: contact rows in float64 agree to 1e-12 (nearest points and
contact type exactly); end to end in float32: hit, status, gjk_iters exact,
epa_iters on >= 97% of lanes (XLA:CPU fuses multiply-adds, see
test_torch_epa.py), depth and distance atol 1e-6, normal dot > 1-1e-5 on
>= 90% of hit lanes, and on those lanes contact type exact and contact
point atol 1e-5 (contact outputs are functions of the normal).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.api import gjkepa_batch_fused as jax_batch_fused
from gjkepa_tpu.ops.contact_rows import derive_contact_rows as jax_rows
from gjkepa_tpu_torch import GJKEPAConfig, gjkepa_batch_fused
from gjkepa_tpu_torch.ops.contact_rows import derive_contact_rows
from tests.conftest import cube, random_hull

torch.set_num_threads(1)


def _fixture(rng, b=48, n=14):
    """test_contact_rows.py's fixture: random hulls and unit normals."""
    p1 = np.stack([random_hull(rng, n, center=rng.normal(size=3) * 0.4)
                   for _ in range(b)])
    p2 = np.stack([random_hull(rng, n, center=rng.normal(size=3) * 0.4)
                   for _ in range(b)])
    nrm = rng.normal(size=(b, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return p1, p2, nrm


def _compare_rows(p1, p2, nrm, jax_cfg, m1=None, m2=None, atol=1e-12):
    cfg = GJKEPAConfig.from_reference(dataclasses.asdict(jax_cfg))
    as_j = (lambda a: None if a is None else jnp.asarray(a))  # noqa: E731
    as_t = (lambda a: None if a is None else torch.from_numpy(a))  # noqa: E731
    ref = jax_rows(as_j(p1), as_j(p2), as_j(nrm), jax_cfg, as_j(m1), as_j(m2))
    got = derive_contact_rows(as_t(p1), as_t(p2), as_t(nrm), cfg, as_t(m1),
                              as_t(m2))
    for name, a, b in zip(("nearest_points", "contact_point", "normal",
                           "colli_type"), got, ref):
        b = np.asarray(b)
        assert str(a.dtype) == f"torch.{b.dtype}", name
        if name in ("nearest_points", "colli_type"):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, atol=atol, err_msg=name)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("version", [1, 2, 3])
def test_contact_rows_match_jax(rng, version, masked):
    p1, p2, nrm = _fixture(rng)
    m1 = m2 = None
    if masked:
        m1 = rng.random(p1.shape[:2]) > 0.25
        m2 = rng.random(p2.shape[:2]) > 0.25
        m1[:, 0] = m2[:, 0] = True     # every lane keeps one vertex
    _compare_rows(p1, p2, nrm, JaxConfig(version=version), m1, m2)


def test_contact_rows_degenerate_configurations():
    """Axis-aligned and rotated cube pairs reach every (n1, n2) branch of
    the version-2 case tree (test_contact_rows.py's fixtures)."""
    c = cube([0, 0, 0])
    th = np.deg2rad(45)
    rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                   [0, 0, 1]])
    ry = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                   [-np.sin(th), 0, np.cos(th)]])
    q = rz @ ry
    d = np.array([1.0, 1.0, 1.0]) / np.sqrt(3)
    fixtures = [(c, cube([0.9, 0, 0]), [1.0, 0, 0]),
                (c, c @ rz.T + [1.1, 0, 0], [1.0, 0, 0]),
                (c @ rz.T, c @ ry.T + [1.1, 0, 0], [1.0, 0, 0]),
                (c @ q.T, cube([1.2, 0, 0]), [1.0, 0, 0]),
                (c @ q.T, c @ q.T + [1.4, 0, 0], [1.0, 0, 0]),
                (c, cube([0.5, 0.5, 0.5]), d),
                (np.full((8, 3), 0.25), c, [0, 0, 1.0])]
    p1 = np.stack([f[0] for f in fixtures])
    p2 = np.stack([f[1] for f in fixtures])
    nrm = np.stack([np.asarray(f[2], float) for f in fixtures])
    for version in (1, 2, 3):
        _compare_rows(p1, p2, nrm, JaxConfig(version=version))


def test_contact_rows_float32_match_jax(rng):
    p1, p2, nrm = (a.astype(np.float32) for a in _fixture(rng))
    _compare_rows(p1, p2, nrm, JaxConfig.for_f32(), atol=1e-6)


@pytest.fixture(scope="module")
def ragged_pair():
    """B=100 (not a multiple of the JAX lane block) with ragged masks."""
    rng = np.random.default_rng(11)
    b, n = 100, 16
    p1 = np.stack([random_hull(rng, n, center=rng.normal(size=3) * 0.6)
                   for _ in range(b)]).astype(np.float32)
    p2 = np.stack([random_hull(rng, n, center=rng.normal(size=3) * 0.6)
                   for _ in range(b)]).astype(np.float32)
    m1 = np.arange(n)[None, :] < rng.integers(4, n + 1, size=b)[:, None]
    m2 = np.arange(n)[None, :] < rng.integers(4, n + 1, size=b)[:, None]
    jax_cfg = JaxConfig.for_f32()
    ref = jax_batch_fused(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(m1),
                          jnp.asarray(m2), cfg=jax_cfg, interpret=True)
    got = gjkepa_batch_fused(
        torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(m1),
        torch.from_numpy(m2),
        cfg=GJKEPAConfig.from_reference(dataclasses.asdict(jax_cfg)))
    return ref, got


def test_batch_fused_fields_match_jax_layout(ragged_pair):
    ref, got = ragged_pair
    assert got._fields == ref._fields
    for name in ref._fields:
        a, b = getattr(got, name), np.asarray(getattr(ref, name))
        assert tuple(a.shape) == b.shape, name
        assert str(a.dtype) == f"torch.{b.dtype}", name


def test_batch_fused_discrete_outputs_match_jax(ragged_pair):
    ref, got = ragged_pair
    hit = got.hit.numpy()
    assert 10 <= hit.sum() < len(hit)
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.gjk_iters.numpy(),
                                  np.asarray(ref.gjk_iters))
    it, it_ref = got.epa_iters.numpy(), np.asarray(ref.epa_iters)
    assert (it == it_ref).mean() >= 0.97, np.nonzero(it != it_ref)


def test_batch_fused_geometry_matches_jax(ragged_pair):
    ref, got = ragged_pair
    hit = got.hit.numpy()
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               atol=1e-6)
    np.testing.assert_allclose(got.distance.numpy(), np.asarray(ref.distance),
                               atol=1e-6)
    dots = np.einsum("ij,ij->i", got.normal.numpy(), np.asarray(ref.normal))
    agree = hit & (dots > 1.0 - 1e-5)
    assert agree.sum() >= 0.9 * hit.sum()
    np.testing.assert_array_equal(got.colli_type.numpy()[agree],
                                  np.asarray(ref.colli_type)[agree])
    np.testing.assert_allclose(got.contact_point.numpy()[agree],
                               np.asarray(ref.contact_point)[agree], atol=1e-5)
    # nearest points are support vertices of the normal: on face contacts
    # several vertices tie, so hold their support values, not their index
    n_ref = np.asarray(ref.normal)[agree]
    for side, sign in ((0, 1.0), (1, -1.0)):
        h_got = np.einsum("ij,ij->i", got.nearest_points.numpy()[agree, side],
                          sign * n_ref)
        h_ref = np.einsum("ij,ij->i",
                          np.asarray(ref.nearest_points)[agree, side],
                          sign * n_ref)
        np.testing.assert_allclose(h_got, h_ref, atol=1e-5)
    miss = ~hit
    assert not got.colli_type.numpy()[miss].any()
    assert not got.contact_point.numpy()[miss].any()
