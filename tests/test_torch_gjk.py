"""K1 (GJK over hull pairs): the port's plain version against the JAX fused
kernel in interpret mode, on the same numpy inputs.

Tolerances: hit and status exact; separation distance atol 1e-6;
gjk_iters exact on every hit lane and on >= 95% of all lanes.  XLA:CPU
contracts a*b+c into one fused multiply-add, which the plain version
(every op rounded on its own, as the CUDA kernel built with --fmad=false)
does not; on lanes where GJK oscillates before a MISS_GJK verdict a
last-bit difference can add or remove one loop iteration (4 of 128 lanes
on this fixture), never change the verdict.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.ops.fused import fused_gjkepa_hulls as jax_fused
from gjkepa_tpu_torch import GJKEPAConfig, Status, fused_gjkepa_hulls
from gjkepa_tpu_torch.api import gjkepa_batch_fused
from gjkepa_tpu_torch.ops.fused import mask_to_padding
from gjkepa_tpu_torch.ops.fused_gjk import gjk_hulls
from tests.conftest import cube, random_hull

torch.set_num_threads(1)

JAX_BOOL = JaxConfig.for_f32().replace(epa_max_iters=0)
BOOL = GJKEPAConfig.from_reference(dataclasses.asdict(JAX_BOOL))


def _batch(rng, b, n, spread=0.8):
    p1 = np.stack([random_hull(rng, n, center=rng.normal(size=3) * spread)
                   for _ in range(b)]).astype(np.float32)
    p2 = np.stack([random_hull(rng, n, center=rng.normal(size=3) * spread)
                   for _ in range(b)]).astype(np.float32)
    return p1, p2


@pytest.fixture(scope="module")
def k1_pair():
    """(JAX result, port K1 rows) on test_fused.py's 128 x 12 fixture."""
    p1, p2 = _batch(np.random.default_rng(0), 128, 12)
    ref = jax_fused(jnp.asarray(p1), jnp.asarray(p2), cfg=JAX_BOOL, block=128,
                    interpret=True)
    got = gjk_hulls(torch.from_numpy(p1), torch.from_numpy(p2), BOOL)
    return ref, got


def test_k1_hit_and_status_match_jax(k1_pair):
    ref, got = k1_pair
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    # the fixture reaches every K1 verdict of the hull path
    assert {Status.MISS_BROADPHASE, Status.MISS_GJK, Status.HIT} <= set(
        got.status.tolist())


def test_k1_iterations_match_jax(k1_pair):
    ref, got = k1_pair
    it_ref = np.asarray(ref.gjk_iters)
    it = got.iters.numpy()
    hit = got.hit.numpy()
    np.testing.assert_array_equal(it[hit], it_ref[hit])
    assert (it == it_ref).mean() >= 0.95, np.nonzero(it != it_ref)


def test_k1_distance_matches_jax(k1_pair):
    ref, got = k1_pair
    np.testing.assert_allclose(got.sep.numpy(), np.asarray(ref.distance),
                               atol=1e-6)
    assert got.sep.dtype == torch.float32


def test_known_cube_geometry():
    """Axis-aligned unit cubes at offset dx: depth 1-dx along x, face-face
    contact type 2, misses for dx >= 1."""
    offsets = [0.3, 0.7, 1.2, 2.5] * 8
    p1 = torch.from_numpy(np.stack([cube([0, 0, 0])] * len(offsets))
                          .astype(np.float32))
    p2 = torch.from_numpy(np.stack([cube([dx, 0, 0]) for dx in offsets])
                          .astype(np.float32))
    r = gjkepa_batch_fused(p1, p2)
    for i, dx in enumerate(offsets):
        if dx < 1.0:
            assert bool(r.hit[i]) and int(r.status[i]) == Status.HIT
            assert abs(float(r.depth[i]) - (1.0 - dx)) < 1e-5, (dx, r.depth[i])
            np.testing.assert_allclose(np.abs(r.normal[i].numpy()), [1, 0, 0],
                                       atol=1e-6)
            assert int(r.colli_type[i]) == 2
        else:
            assert not bool(r.hit[i]) and int(r.colli_type[i]) == 0
            assert float(r.distance[i]) > 0.0


def test_masks_equal_repeated_vertex_padding():
    """Masked-out rows behave exactly like rows repeating the hull's first
    valid vertex (the JAX package's utils.hull.pad_hulls convention)."""
    rng = np.random.default_rng(5)
    b, n = 32, 10
    p1, p2 = (torch.from_numpy(a) for a in _batch(rng, b, n, spread=0.5))
    n1 = torch.from_numpy(rng.integers(4, n + 1, size=b))
    m1 = torch.arange(n)[None, :] < n1[:, None]
    m1[:3] = torch.roll(m1[:3], 2, dims=1)     # first valid row not row 0
    padded = p1.clone()
    for i in range(b):
        first = int(torch.nonzero(m1[i])[0])
        padded[i, ~m1[i]] = p1[i, first]
    np.testing.assert_array_equal(mask_to_padding(p1, m1).numpy(),
                                  padded.numpy())
    cfg = GJKEPAConfig.for_f32()
    rm = fused_gjkepa_hulls(p1, p2, m1, None, cfg=cfg)
    rp = fused_gjkepa_hulls(padded, p2, cfg=cfg)
    for a, c in zip(rm, rp):
        np.testing.assert_array_equal(a.numpy(), c.numpy())
