"""Large hulls on the port's resident path (K1/K2's plain versions) against
the JAX package's fused path, on the same numpy inputs (port of
tests/test_large_hulls.py).

N = 1024 a hull (n1 + n2 = 2048, under the 4096 threshold of the
large-hull path) through the whole fused pipeline, and a 700-vertex hull
padded to 1024 rows under a mask against the unpadded call.

Not ported: ``test_auto_block_policy``.  ``_auto_block`` shrinks the TPU
kernels' lane block so both hull buffers fit a VMEM budget; a CUDA kernel
reads its hulls from global memory at any N and has no lane block to
shrink, so the port has no such policy to test.

Tolerances: hit and status exact, gjk_iters exact on hit lanes, depth and
distance atol 1e-6 (fused against fused; the JAX test holds fused against
the portable path at 5e-5).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.ops.fused import fused_gjkepa_hulls as jax_fused_hulls
from gjkepa_tpu_torch import GJKEPAConfig, fused_gjkepa_hulls
from gjkepa_tpu_torch.models.fixtures import large_hulls

torch.set_num_threads(1)

JAX_CFG = JaxConfig.for_f32()
CFG = GJKEPAConfig.from_reference(dataclasses.asdict(JAX_CFG))


def _assert_match(got, ref):
    hit = got.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.gjk_iters.numpy()[hit],
                                  np.asarray(ref.gjk_iters)[hit])
    for name in ("depth", "distance"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-6,
                                   err_msg=name)


def test_n1024_fused_matches_jax():
    rng = np.random.default_rng(11)
    p1, p2 = large_hulls(rng, 8, 1024), large_hulls(rng, 8, 1024)
    ref = jax_fused_hulls(jnp.asarray(p1), jnp.asarray(p2), cfg=JAX_CFG,
                          block=512, interpret=True)
    got = fused_gjkepa_hulls(torch.from_numpy(p1), torch.from_numpy(p2),
                             cfg=CFG)
    assert got.hit.any()
    _assert_match(got, ref)


@pytest.fixture(scope="module")
def masked_pair():
    """4 pairs of 700-vertex hulls, and the same padded to 1024 rows with
    far-away junk that a mask drops."""
    rng = np.random.default_rng(3)
    b, n_real, n_pad = 4, 700, 1024
    p1, p2 = large_hulls(rng, b, n_real), large_hulls(rng, b, n_real)
    pad1 = np.concatenate(
        [p1, np.full((b, n_pad - n_real, 3), 7e3, np.float32)], axis=1)
    pad2 = np.concatenate(
        [p2, np.full((b, n_pad - n_real, 3), -7e3, np.float32)], axis=1)
    m = np.zeros((b, n_pad), bool)
    m[:, :n_real] = True
    ref = jax_fused_hulls(jnp.asarray(pad1), jnp.asarray(pad2),
                          mask1=jnp.asarray(m), mask2=jnp.asarray(m),
                          cfg=JAX_CFG, interpret=True)
    t = torch.from_numpy
    masked = fused_gjkepa_hulls(t(pad1), t(pad2), mask1=t(m), mask2=t(m),
                                cfg=CFG)
    unpadded = fused_gjkepa_hulls(t(p1), t(p2), cfg=CFG)
    return ref, masked, unpadded


def test_n1024_masked_equals_unpadded(masked_pair):
    _, masked, unpadded = masked_pair
    assert torch.equal(masked.hit, unpadded.hit)
    np.testing.assert_allclose(masked.depth.numpy(), unpadded.depth.numpy(),
                               atol=1e-6)


def test_n1024_masked_matches_jax(masked_pair):
    ref, masked, _ = masked_pair
    _assert_match(masked, ref)
