"""``tests/test_golden_degenerate.py`` through the port: constructed contact
configurations (touching, near-touching, the five support-set cases of
get_collisionPoint_02, deep containment) asserted per fixture on the
port's portable path in float64 against the reference-semantics oracle
(``tests/oracle_np.py``) and the independent Minkowski-hull depth, and on
the port's fused hull query (its plain versions on the CPU, float32)
against the same oracle, with the JAX suite's tolerances.
"""

import numpy as np
import pytest
import torch

from gjkepa_tpu_torch import GJKEPAConfig, fused_gjkepa_hulls, gjkepa
from tests.conftest import cube, random_hull
from tests.oracle_np import OracleHalt, gjkepa_oracle
from tests.test_golden_degenerate import minkowski_hull_depth, rot

torch.set_num_threads(1)

F32 = GJKEPAConfig.for_f32()


def _port(p1, p2):
    return gjkepa(torch.from_numpy(np.asarray(p1, np.float64)),
                  torch.from_numpy(np.asarray(p2, np.float64)))


def _fused(p1, p2):
    return fused_gjkepa_hulls(
        torch.from_numpy(np.asarray(p1, np.float32)[None]),
        torch.from_numpy(np.asarray(p2, np.float32)[None]), cfg=F32)


def check_exact(p1, p2, expect_depth=None, expect_normal_axis=None,
                depth_tol=1e-9, f32_tol=2e-5):
    """The JAX suite's ``check_exact`` on the port's two paths."""
    try:
        o = gjkepa_oracle(p1, p2)
    except OracleHalt:
        # the reference would STOP: finite outputs, ~0 depth if a hit
        r = _port(p1, p2)
        for t in (r.depth, r.normal, r.contact_point):
            assert torch.isfinite(t).all()
        if bool(r.hit):
            assert float(r.depth) == pytest.approx(0.0, abs=1e-6)
        rf = _fused(p1, p2)
        assert torch.isfinite(rf.depth).all()
        if bool(rf.hit[0]):
            assert float(rf.depth[0]) == pytest.approx(0.0, abs=1e-5)
        return None, r
    r = _port(p1, p2)
    assert bool(r.hit) == o.hit
    if o.hit and not o.epa_capped:
        assert float(r.depth) == pytest.approx(o.depth, abs=depth_tol)
        if o.depth > 1e-7:
            inside, d_true = minkowski_hull_depth(p1, p2)
            assert inside
            assert float(r.depth) == pytest.approx(d_true, abs=depth_tol)
        if expect_depth is not None:
            assert float(r.depth) == pytest.approx(expect_depth, abs=1e-9)
        n = r.normal.numpy()
        if expect_normal_axis is not None:
            assert abs(abs(float(n @ expect_normal_axis)) - 1.0) < 1e-7, n
        ndot = float(n @ o.normal)
        if ndot > 1.0 - 1e-7:
            assert int(r.colli_type) == o.colli_type
            np.testing.assert_allclose(r.contact_point.numpy(),
                                       o.contact_point, atol=1e-7)
        else:           # touching: the normal's sign may flip
            assert o.depth < 1e-7 or ndot < -(1.0 - 1e-7), ndot
    rf = _fused(p1, p2)
    assert bool(rf.hit[0]) == o.hit, "fused hit verdict diverged"
    if o.hit and not o.epa_capped:
        assert float(rf.depth[0]) == pytest.approx(o.depth, abs=f32_tol)
    return o, r


S = np.sqrt(2.0) / 2.0
_CORNER = (rot([1, 0, 0], np.rad2deg(np.arctan(np.sqrt(2.0))))
           @ rot([0, 0, 1], 45))
FIXTURES = {   # name: (p1, p2, expected depth, normal axis, must hit)
    "touching_faces": (cube(), cube([1.0, 0, 0]), None, None, None),
    "barely_overlapping": (cube(), cube([1.0 - 1e-6, 0, 0]), 1e-6,
                           [1, 0, 0], True),
    "barely_separated": (cube(), cube([1.0 + 1e-6, 0, 0]), None, None,
                         False),
    "touching_corner": (cube(), cube([1.0, 1.0, 1.0]), None, None, None),
    "vertex_vertex": (cube(), cube([0.9, 0.84, 0.78]), 0.10, [1, 0, 0],
                      True),
    "face_face": (cube(), cube([0.75, 0, 0]), 0.25, [1, 0, 0], True),
    "edge_face": (cube(), cube() @ rot([1, 0, 0], 45).T
                  + np.array([0.1, 0, 0.5 + S - 0.11]), 0.11, [0, 0, 1],
                  True),
    "edge_edge": (cube() @ rot([0, 1, 0], 45).T,
                  cube() @ rot([1, 0, 0], 45).T + np.array([0, 0,
                                                            2 * S - 0.07]),
                  0.07, [0, 0, 1], True),
    "vertex_face": (cube(), cube() @ _CORNER.T
                    + np.array([0.05, 0.1, 0.5 + np.sqrt(3.0) / 2 - 0.09]),
                    0.09, [0, 0, 1], True),
    "deep_inside": (cube(half=1.0), cube([0.1, 0, 0], half=0.2), None, None,
                    True),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_golden_fixture(name):
    p1, p2, depth, axis, must_hit = FIXTURES[name]
    o, r = check_exact(p1, p2, depth, axis)
    if must_hit is not None:
        assert o is not None and o.hit == must_hit and bool(r.hit) == must_hit
    if name == "face_face":
        assert o.colli_type == 2
    if name == "touching_faces" and o is not None and o.hit:
        assert float(r.depth) == pytest.approx(0.0, abs=1e-9)


def test_random_hulls_vs_minkowski(rng):
    """Every hit's depth equals the Minkowski-hull depth; no clear hit is
    missed (the JAX suite's independent sweep, in one batch)."""
    pairs = [(random_hull(rng, 14, center=rng.normal(size=3) * 0.6),
              random_hull(rng, 14, center=rng.normal(size=3) * 0.6))
             for _ in range(60)]
    from gjkepa_tpu_torch import gjkepa_batch
    r = gjkepa_batch(torch.from_numpy(np.stack([a for a, _ in pairs])),
                     torch.from_numpy(np.stack([b for _, b in pairs])))
    checked = 0
    for i, (a, b) in enumerate(pairs):
        inside, d_true = minkowski_hull_depth(a, b)
        if bool(r.hit[i]) and float(r.depth[i]) > 1e-7:
            assert inside
            assert float(r.depth[i]) == pytest.approx(d_true, abs=1e-7)
            checked += 1
        elif not bool(r.hit[i]) and int(r.status[i]) != 0:
            assert not (inside and d_true > 1e-3), d_true
    assert checked >= 15, checked
