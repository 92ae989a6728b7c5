"""The float32 ladder's scale on the port's portable path:
``tests/test_f32_scale.py``'s cases but the sanitizer's (which comes with
the sanitizer).  Hull pairs near |x| ~ 1e3 under ``for_f32(scale=10)``
against the float64 ladder, translation invariance at +1e3, and identical
shapes hitting under both ladders, with the JAX suite's tolerances."""

import numpy as np
import pytest
import torch

from gjkepa_tpu_torch import GJKEPAConfig, Status, gjkepa_batch
from tests.conftest import cube, random_hull

torch.set_num_threads(1)


def _t(x, dtype=np.float64):
    return torch.from_numpy(np.asarray(x, dtype))


def test_large_coordinate_differential_vs_f64(rng):
    b = 48
    far = np.array([1000.0, -750.0, 500.0])
    p1 = np.stack([random_hull(rng, 12, center=far + rng.normal(size=3) * 0.8)
                   for _ in range(b)])
    p2 = np.stack([random_hull(rng, 12, center=far + rng.normal(size=3) * 0.8)
                   for _ in range(b)])
    r64 = gjkepa_batch(_t(p1), _t(p2), cfg=GJKEPAConfig())
    r32 = gjkepa_batch(_t(p1, np.float32), _t(p2, np.float32),
                       cfg=GJKEPAConfig.for_f32(scale=10.0))
    h64, h32 = r64.hit.numpy(), r32.hit.numpy()
    assert (h64 != h32).sum() <= 1, np.nonzero(h64 != h32)
    m = h64 & h32
    assert m.sum() >= 5
    np.testing.assert_allclose(r32.depth.numpy()[m], r64.depth.numpy()[m],
                               atol=5e-4)


def test_translation_invariance_at_large_offset(rng):
    b = 32
    p1 = np.stack([random_hull(rng, 12, center=rng.normal(size=3) * 0.6)
                   for _ in range(b)]).astype(np.float32)
    p2 = np.stack([random_hull(rng, 12, center=rng.normal(size=3) * 0.6)
                   for _ in range(b)]).astype(np.float32)
    off = np.array([1000.0, 1000.0, 1000.0], np.float32)
    cfg32 = GJKEPAConfig.for_f32(scale=10.0)
    r0 = gjkepa_batch(_t(p1, np.float32), _t(p2, np.float32), cfg=cfg32)
    r1 = gjkepa_batch(_t(p1 + off, np.float32), _t(p2 + off, np.float32),
                      cfg=cfg32)
    h0, h1 = r0.hit.numpy(), r1.hit.numpy()
    assert (h0 != h1).sum() <= 1
    m = h0 & h1
    assert m.sum() >= 5
    np.testing.assert_allclose(r1.depth.numpy()[m], r0.depth.numpy()[m],
                               atol=5e-4)


@pytest.mark.parametrize("f32", [False, True])
def test_identical_geometry_hits(f32):
    """Identical coincident cubes hit with full depth under both ladders
    (the origin on the v1-v2 segment takes the perpendicular fallback)."""
    dt, cfg = ((np.float32, GJKEPAConfig.for_f32()) if f32
               else (np.float64, GJKEPAConfig()))
    c = cube([0.0, 0.0, 0.0])[None]
    r = gjkepa_batch(_t(c, dt), _t(c, dt), cfg=cfg)
    assert bool(r.hit[0]) and int(r.status[0]) == Status.HIT
    assert float(r.depth[0]) == pytest.approx(1.0, abs=1e-5)
