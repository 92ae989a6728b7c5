"""Init retries on the port's portable path: all 99 rows of the direction
table, against the fused path's 8 (``tests/test_init_retry_equivalence.py``
holds the JAX package's proof that 8 decide as 99 do, up to a shell of
width ~eps_coincide around exact degeneracy).

Inside that shell: clouds ~1e-8 across whose v1/v2 probes coincide along
the first 8 or more table directions and not along a later one.  The port
must run exactly as many retries as the table says (counted through its
support calls) and report what the JAX package's portable path reports.
Outside it, the JAX suite's cases through the port: single-point
differences miss on both of the port's paths, and collinear clouds get
the same verdict from both.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu import gjkepa_batch as jax_gjkepa_batch
from gjkepa_tpu_torch import (GJKEPAConfig, Status, fused_gjkepa_hulls,
                              gjkepa_batch)
from gjkepa_tpu_torch.ops.directions import DIRECTION_TABLE
from gjkepa_tpu_torch.ops.gjk import run_gjk
from gjkepa_tpu_torch.ops.support import make_hull_support

torch.set_num_threads(1)

F32 = GJKEPAConfig.for_f32()
EPS = GJKEPAConfig().eps_coincide


def _leading_coincident(a):
    """How many leading table directions give coincident v1/v2 probes for
    the cloud ``a`` against the origin (first-max supports)."""
    dots = a @ DIRECTION_TABLE.T
    hi, lo = a[np.argmax(dots, 0)], a[np.argmax(-dots, 0)]
    co = (np.abs(hi - lo) < EPS).all(1)
    return int(np.argmin(co)) if not co.all() else len(co)


def _shell_clouds():
    """Clouds of 6 points ~1e-8 across that need 9 to 98 retries."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(20000):
        a = rng.normal(size=(6, 3)) * rng.uniform(0.3, 1.0) * 1e-8
        n = _leading_coincident(a)
        if 8 <= n < 98:
            out.append((a, n))
    return out


def test_first8_span_r3():
    sigma = np.linalg.svd(DIRECTION_TABLE[:8], compute_uv=False)
    assert DIRECTION_TABLE.shape == (100, 3) and sigma[-1] > 0.8


def test_port_runs_every_retry_the_table_needs():
    clouds = _shell_clouds()
    assert len(clouds) >= 5 and max(n for _, n in clouds) > 16
    for a, n in clouds:
        p1 = torch.from_numpy(a)[None]
        p2 = torch.zeros_like(p1)
        calls = []
        support = make_hull_support(p1, p2)

        def counted(d, support=support, calls=calls):
            calls.append(d)
            return support(d)
        g = run_gjk(counted, GJKEPAConfig(),
                    torch.ones(1, dtype=torch.bool), dtype=torch.float64)
        # n coincident probes, one that is not: n + 1 retries of two
        # probes, then v3, v4 and the early-EPA seed's two
        assert int(g.status[0]) == Status.MISS_INIT
        assert len(calls) == 2 * (n + 1) + 4, (n, len(calls))


def test_shell_lanes_match_jax():
    clouds = _shell_clouds()
    a = np.stack([c for c, _ in clouds])
    z = np.zeros_like(a)
    ref = jax_gjkepa_batch(jnp.asarray(a), jnp.asarray(z), cfg=JaxConfig())
    got = gjkepa_batch(torch.from_numpy(a), torch.from_numpy(z))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_allclose(got.distance.numpy(), np.asarray(ref.distance),
                               rtol=1e-9, atol=0)


def _point_cloud_pair(offset):
    """Hull buffers whose Minkowski difference is a single point."""
    a = np.full((1, 8, 3), 0.0, np.float32) + np.array([0.2, -0.1, 0.3],
                                                       np.float32)
    return a, a + np.asarray(offset, np.float32)


def test_point_pairs_on_both_port_paths():
    for offset, status in (([0.05, 0.0, 0.0], Status.MISS_INIT),
                           ([0.0, 0.0, 0.0], None)):
        a, b = _point_cloud_pair(offset)
        rx = gjkepa_batch(torch.from_numpy(a.astype(np.float64)),
                          torch.from_numpy(b.astype(np.float64)))
        rf = fused_gjkepa_hulls(torch.from_numpy(a), torch.from_numpy(b),
                                cfg=F32)
        assert bool(rx.hit[0]) == bool(rf.hit[0])
        assert int(rx.status[0]) == int(rf.status[0])
        if status is not None:
            assert int(rx.status[0]) == status and not bool(rx.hit[0])


def test_flat_segment_pairs_agree(rng):
    """Collinear clouds stress the retry ladder without exhausting it: the
    portable path's verdict equals the fused path's on every lane."""
    b = 32
    axis = rng.normal(size=(b, 1, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    seg1 = (rng.random((b, 8, 1)) - 0.5) * axis
    seg2 = ((rng.random((b, 8, 1)) - 0.5) * axis
            + rng.normal(size=(b, 1, 3)) * 0.05)
    a1 = torch.from_numpy(seg1.astype(np.float32))
    a2 = torch.from_numpy(seg2.astype(np.float32))
    rx = gjkepa_batch(a1, a2, cfg=F32)
    rf = fused_gjkepa_hulls(a1, a2, cfg=F32)
    assert torch.equal(rx.hit, rf.hit)
