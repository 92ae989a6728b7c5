"""The portable hull query, ``gjkepa`` and ``gjkepa_batch``: the port
against the JAX package's portable path (never the fused one: they differ
on purpose in the init retries, the EPA mechanism and the float32 caps).

Inputs: ``tests/test_gjkepa.py``'s random hull pairs (64 x 12, centres
~ N(0, 0.6^2)), made with numpy from a seed and handed to both packages.
Tolerances against JAX:

  * hit, status and contact type exact;
  * GJK and EPA iterations equal on >= 95% of lanes, GJK's on every hit:
    XLA:CPU fuses multiply-adds where the port rounds every operation, and
    a last-bit difference can move a stall or convergence test by one
    iteration;
  * depth, normal and contact point within 1e-9 in float64 and 1e-5 in
    float32 (``tests/test_torch_distance.py``'s portable tolerances), the
    miss distance likewise;
  * nearest points by their support values along the normal, within the
    same tolerance: the EPA normal is a face normal, so two vertices of a
    face can tie to the last bit, and which one the argmax takes depends
    on how the dot product is rounded (``tests/test_oracle_diff.py``
    compares support values for the same reason); not in version 3, which
    rewrites the normal the points were taken along.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu import gjkepa as jax_gjkepa
from gjkepa_tpu import gjkepa_batch as jax_gjkepa_batch
from gjkepa_tpu_torch import GJKEPAConfig, Status, gjkepa, gjkepa_batch
from tests.conftest import cube, random_hull

torch.set_num_threads(1)

TOL = {np.float64: 1e-9, np.float32: 1e-5}
CONTINUOUS = ("depth", "normal", "contact_point", "distance")


def _port_cfg(jax_cfg):
    return GJKEPAConfig.from_reference(dataclasses.asdict(jax_cfg))


def _pairs(seed, b=64, n=12, spread=0.6):
    rng = np.random.default_rng(seed)
    return tuple(np.stack([random_hull(rng, n, center=rng.normal(size=3)
                                       * spread) for _ in range(b)])
                 for _ in range(2))


def _run(p1, p2, jax_cfg, mask1=None, mask2=None, **kw):
    """Both packages on the same numpy inputs: (jax fields, port fields)."""
    def j(x):
        return None if x is None else jnp.asarray(x)

    def t(x):
        return None if x is None else torch.from_numpy(x)
    ref = jax_gjkepa_batch(j(p1), j(p2), j(mask1), j(mask2), cfg=jax_cfg)
    got = gjkepa_batch(t(p1), t(p2), t(mask1), t(mask2),
                       cfg=_port_cfg(jax_cfg), **kw)
    return ({f: np.asarray(x) for f, x in zip(ref._fields, ref)},
            {f: x.numpy() for f, x in zip(got._fields, got)})


def _check(ref, got, tol, version=2):
    for f in ("hit", "status", "colli_type"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    hit = ref["hit"]
    assert (got["gjk_iters"] == ref["gjk_iters"]).mean() >= 0.95
    np.testing.assert_array_equal(got["gjk_iters"][hit], ref["gjk_iters"][hit])
    assert (got["epa_iters"] == ref["epa_iters"]).mean() >= 0.95
    for f in CONTINUOUS:
        assert got[f].dtype == ref[f].dtype, f
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=tol,
                                   err_msg=f)
    if version == 3:
        return
    n = ref["normal"][:, None, :] * np.array([1.0, -1.0])[None, :, None]
    np.testing.assert_allclose((got["nearest_points"] * n).sum(-1),
                               (ref["nearest_points"] * n).sum(-1), rtol=0,
                               atol=tol, err_msg="nearest-point supports")


@pytest.fixture(scope="module")
def runs():
    """One JAX call per (dtype, version) and for the masked batch."""
    p1, p2 = _pairs(0)
    out = {}
    for v in (1, 2, 3):
        out[("f64", v)] = _run(p1, p2, JaxConfig(version=v))
    for v in (2, 3):
        out[("f32", v)] = _run(p1.astype(np.float32), p2.astype(np.float32),
                               JaxConfig.for_f32().replace(version=v))
    # 12-vertex hulls padded to 16 with junk rows, masked out
    rng = np.random.default_rng(1)
    pad = rng.normal(size=(2, 64, 4, 3)) * 50.0
    m = np.arange(16) < 12
    mask = np.broadcast_to(m, (64, 16)).copy()
    out["masked"] = _run(np.concatenate([p1, pad[0]], 1),
                         np.concatenate([p2, pad[1]], 1), JaxConfig(),
                         mask, mask)
    return out


@pytest.mark.parametrize("version", [1, 2, 3])
def test_batch_matches_jax_f64(runs, version):
    ref, got = runs[("f64", version)]
    assert 10 <= ref["hit"].sum() < 64
    _check(ref, got, TOL[np.float64], version)


@pytest.mark.parametrize("version", [2, 3])
def test_batch_matches_jax_f32(runs, version):
    ref, got = runs[("f32", version)]
    assert got["depth"].dtype == np.float32
    _check(ref, got, TOL[np.float32], version)


def test_masked_batch_matches_jax_and_unpadded(runs):
    ref, got = runs["masked"]
    _check(ref, got, TOL[np.float64])
    unpadded = runs[("f64", 2)][1]
    for f in ("hit", "status", "depth", "contact_point"):
        np.testing.assert_allclose(got[f], unpadded[f], rtol=0, atol=1e-12)


def test_chunks_equal_one_batch(runs):
    p1, p2 = _pairs(0)
    whole = runs[("f64", 2)][1]
    got = gjkepa_batch(torch.from_numpy(p1), torch.from_numpy(p2),
                       chunk_size=24)
    for f, x in zip(got._fields, got):
        np.testing.assert_array_equal(x.numpy(), whole[f], err_msg=f)


def test_single_pair_matches_jax_and_its_batch_row(runs):
    p1, p2 = _pairs(0)
    whole = runs[("f64", 2)][1]
    for i in (0, 5, 17):
        ref = jax_gjkepa(jnp.asarray(p1[i]), jnp.asarray(p2[i]))
        got = gjkepa(torch.from_numpy(p1[i]), torch.from_numpy(p2[i]))
        for f, x in zip(got._fields, got):
            assert tuple(x.shape) == np.shape(ref._asdict()[f]), f
            if f != "nearest_points":
                np.testing.assert_allclose(
                    x.numpy(), np.asarray(ref._asdict()[f]), rtol=0,
                    atol=1e-9, err_msg=f)
            np.testing.assert_array_equal(x.numpy(), whole[f][i], err_msg=f)


def _q(a, b, **kw):
    return gjkepa(torch.from_numpy(a), torch.from_numpy(b), **kw)


def test_known_cube_geometry():
    r = _q(cube([0, 0, 0]), cube([0.5, 0, 0]))
    assert bool(r.hit) and int(r.status) == Status.HIT
    assert float(r.depth) == pytest.approx(0.5, abs=1e-9)
    np.testing.assert_allclose(np.abs(r.normal.numpy()), [1, 0, 0], atol=1e-9)
    assert int(r.colli_type) == 2
    for dx in (0.05, 0.3, 0.7, 0.95):
        r = _q(cube([0, 0, 0]), cube([dx, 0, 0]))
        assert float(r.depth) == pytest.approx(1.0 - dx, abs=1e-8)
    r = _q(cube([0, 0, 0]), cube([0, 0, 0]))
    assert bool(r.hit) and float(r.depth) == pytest.approx(1.0, abs=1e-9)


def test_misses_are_zeroed():
    r = _q(cube([0, 0, 0]), cube([2.0, 0, 0]))
    assert not bool(r.hit) and int(r.status) == Status.MISS_GJK
    assert float(r.depth) == 0.0 and not r.normal.any()
    assert not r.contact_point.any() and int(r.colli_type) == 0
    assert 0.0 < float(r.distance) <= 1.0 + 1e-9
    r = _q(cube([0, 0, 0]), cube([100.0, 0, 0]))
    assert int(r.status) == Status.MISS_BROADPHASE
    assert int(r.gjk_iters) == 0 and int(r.epa_iters) == 0


def test_f32_cube_and_bad_version():
    r = _q(cube([0, 0, 0]).astype(np.float32),
           cube([0.5, 0, 0]).astype(np.float32), cfg=GJKEPAConfig.for_f32())
    assert bool(r.hit) and r.depth.dtype == torch.float32
    assert float(r.depth) == pytest.approx(0.5, abs=1e-4)
    with pytest.raises(ValueError, match="version 7"):
        _q(cube([0, 0, 0]), cube([0.6, 0, 0]),
           cfg=GJKEPAConfig().replace(version=7))


def test_version3_normal_in_xy_plane():
    r = _q(cube([0, 0, 0.3]), cube([0.4, 0.2, 0.0]),
           cfg=GJKEPAConfig().replace(version=3))
    assert bool(r.hit)
    assert float(r.normal[2]) == 0.0
    assert float(torch.linalg.norm(r.normal)) == pytest.approx(1.0, rel=1e-9)


def test_separation_property():
    """Translating B by depth * normal (plus slack) separates the pair."""
    p1, p2 = _pairs(2, b=40, n=16, spread=0.5)
    r = gjkepa_batch(torch.from_numpy(p1), torch.from_numpy(p2))
    deep = (r.hit & (r.depth > 1e-6)).numpy()
    assert deep.sum() >= 5
    moved = p2 + (r.depth.numpy() + 1e-3)[:, None, None] * \
        r.normal.numpy()[:, None, :]
    r2 = gjkepa_batch(torch.from_numpy(p1[deep]),
                      torch.from_numpy(moved[deep]))
    assert (~r2.hit | (r2.depth < 5e-3)).all()
