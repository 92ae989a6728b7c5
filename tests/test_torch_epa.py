"""K2 (the EPA capacity cascade over hit lanes): the port's plain version
against the JAX fused kernels in interpret mode and the float64 oracle.

Tolerances: hit and status exact; depth atol 1e-6; normal dot > 1-1e-5 on
>= 90% of hit lanes; epa_iters exact on >= 97% of lanes (XLA:CPU contracts
a*b+c into fused multiply-adds, the plain version rounds every op, and a
last-bit difference can move one EPA iteration: 1 of 128 lanes here);
depth within 1e-5 of the float64 oracle (the BASELINE accuracy budget).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.ops.fused import fused_gjkepa_hulls as jax_fused
from gjkepa_tpu_torch import GJKEPAConfig, Status, fused_gjkepa_hulls
from gjkepa_tpu_torch.ops.fused import cascade_plan, hit_first_order
from gjkepa_tpu_torch.ops.fused_epa import epa_cascade, epa_phase
from gjkepa_tpu_torch.ops.fused_gjk import gjk_hulls, make_hull_support
from tests.oracle_np import OracleHalt, gjkepa_oracle

torch.set_num_threads(1)

JAX_CFG = JaxConfig.for_f32()
CFG = GJKEPAConfig.from_reference(dataclasses.asdict(JAX_CFG))


def _deep_fixture():
    """test_fused.py::test_fused_cascade_capacity_path's deep pairs."""
    rng = np.random.default_rng(3)
    b, n = 128, 24
    big = rng.normal(size=(b, n, 3)).astype(np.float32)
    big /= np.linalg.norm(big, axis=-1, keepdims=True)
    big *= 2.0
    small = rng.normal(size=(b, n, 3)).astype(np.float32)
    small /= np.linalg.norm(small, axis=-1, keepdims=True)
    small = small * 0.5 + rng.normal(size=(b, 1, 3)).astype(np.float32) * 0.2
    return big, small


@pytest.fixture(scope="module")
def deep_pair():
    big, small = _deep_fixture()
    ref = jax_fused(jnp.asarray(big), jnp.asarray(small), cfg=JAX_CFG,
                    block=128, interpret=True)
    got = fused_gjkepa_hulls(torch.from_numpy(big), torch.from_numpy(small),
                             cfg=CFG)
    return ref, got


def test_cascade_tiers_of_for_f32():
    plan = [(c.epa_max_faces, k) for c, k in cascade_plan(CFG)]
    assert plan == [(48, 8), (88, 8), (208, 16)]


def test_cascade_hit_status_depth_match_jax(deep_pair):
    ref, got = deep_pair
    hit = got.hit.numpy()
    assert hit.mean() > 0.9
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(got.depth.numpy()[hit],
                               np.asarray(ref.depth)[hit], atol=1e-6)
    np.testing.assert_array_equal(got.gjk_iters.numpy(),
                                  np.asarray(ref.gjk_iters))


def test_cascade_normals_and_iterations_match_jax(deep_pair):
    ref, got = deep_pair
    hit = got.hit.numpy()
    dots = np.einsum("ij,ij->i", got.normal.numpy()[hit],
                     np.asarray(ref.normal)[hit])
    assert (dots > 1.0 - 1e-5).mean() >= 0.9
    it, it_ref = got.epa_iters.numpy(), np.asarray(ref.epa_iters)
    assert (it == it_ref).mean() >= 0.97, np.nonzero(it != it_ref)


def test_capacity_lanes_are_rerun_by_the_next_tier():
    """A tiny first tier overflows on the deep pairs; the cascade re-runs
    exactly those lanes, so its result equals the final tier run alone."""
    big, small = (torch.from_numpy(a) for a in _deep_fixture())
    g = gjk_hulls(big, small, CFG)
    final = cascade_plan(CFG)[-1]
    tiny = (CFG.replace(epa_max_faces=12), 2)
    _, _, _, st = epa_phase(make_hull_support(big, small), g.simplex, g.hit,
                            tiny[0], 12, 2)
    assert int((st == Status.HIT_EPA_CAPACITY).sum()) > 20
    order, n_act = hit_first_order(g.hit)
    two = epa_cascade(big, small, g.simplex, g.status, order, n_act,
                      [tiny, final])
    one = epa_cascade(big, small, g.simplex, g.status, order, n_act, [final])
    for a, b in zip(two, one):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not bool((two.status == Status.HIT_EPA_CAPACITY).any())


def test_depth_matches_f64_oracle():
    """test_fused_tpu.py's deep fixture (16 pairs): every converged oracle
    hit is a hit, depth within the 1e-5 budget."""
    rng = np.random.default_rng(7)
    n_pairs, n_verts = 16, 16
    p1 = np.empty((n_pairs, n_verts, 3))
    p2 = np.empty((n_pairs, n_verts, 3))
    depth = np.zeros(n_pairs)
    valid = np.zeros(n_pairs, dtype=bool)
    for i in range(n_pairs):
        v = rng.normal(size=(n_verts, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        p1[i] = v * (1.0 + rng.random((n_verts, 1)))
        w = rng.normal(size=(n_verts, 3))
        w /= np.linalg.norm(w, axis=1, keepdims=True)
        p2[i] = w * 0.5 * (0.5 + 0.5 * rng.random((n_verts, 1)))
        p2[i] += rng.normal(size=3) * 0.15
        try:
            o = gjkepa_oracle(p1[i], p2[i])
        except OracleHalt:
            continue
        if o.hit and not o.epa_capped:
            depth[i] = o.depth
            valid[i] = True
    assert valid.sum() >= 12
    r = fused_gjkepa_hulls(torch.from_numpy(p1.astype(np.float32)),
                           torch.from_numpy(p2.astype(np.float32)), cfg=CFG)
    assert bool(r.hit.numpy()[valid].all())
    err = np.abs(r.depth.numpy()[valid] - depth[valid])
    assert float(err.max()) < 1e-5, err.max()
