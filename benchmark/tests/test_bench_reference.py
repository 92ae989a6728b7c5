"""The plain float64 references on known geometry, against an independent
solver, and against the program's CPU outputs on a small sample."""

import numpy as np
import pytest
import torch
from scipy.optimize import minimize

from benchmark import check, oracle, reference, traffic

import gjkepa_tpu_torch as port

CFG = port.GJKEPAConfig.for_f32()


def cube(center, half=0.5):
    c = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], float) * half
    return c + np.asarray(center, float)


def test_distance_cubes():
    p1 = torch.tensor(np.stack([cube([0, 0, 0])] * 3))
    p2 = torch.tensor(np.stack([cube([2, 0, 0]), cube([0.5, 0, 0]),
                                cube([1.0, 1.5, 0])]))
    d = reference.hull_distance(p1, p2)
    assert d["converged"].all()
    assert d["intersecting"].tolist() == [False, True, False]
    assert d["distance"][0].item() == pytest.approx(1.0, abs=1e-14)
    assert d["point_a"][0, 0].item() == pytest.approx(0.5, abs=1e-14)
    assert d["point_b"][0, 0].item() == pytest.approx(1.5, abs=1e-14)
    assert d["distance"][2].item() == pytest.approx(0.5, abs=1e-14)


def test_distance_against_a_quadratic_program():
    gen = torch.Generator().manual_seed(4)
    p1 = traffic.draw_side(gen, 6, 16, 1.0, 0.8, "cpu").double()
    p2 = traffic.draw_side(gen, 6, 16, 1.0, 0.8, "cpu").double()
    d = reference.hull_distance(p1, p2)
    for i in range(6):
        a, b = p1[i].numpy(), p2[i].numpy()

        def f(x):
            v = x[:16] @ a - x[16:] @ b
            return v @ v
        cons = [{"type": "eq", "fun": lambda x: x[:16].sum() - 1},
                {"type": "eq", "fun": lambda x: x[16:].sum() - 1}]
        r = minimize(f, np.full(32, 1 / 16), bounds=[(0, 1)] * 32,
                     constraints=cons, method="SLSQP",
                     options={"ftol": 1e-16, "maxiter": 1000})
        assert d["distance"][i].item() == pytest.approx(
            np.sqrt(max(r.fun, 0.0)), abs=1e-6)


def test_oracle_cubes():
    rows = reference.oracle_rows(np.stack([cube([0, 0, 0])] * 2),
                                 np.stack([cube([0.5, 0, 0]), cube([3, 0, 0])]))
    assert rows["valid"].all() and rows["hit"].tolist() == [True, False]
    assert rows["depth"][0] == pytest.approx(0.5, abs=1e-12)
    assert abs(rows["normal"][0, 0]) == pytest.approx(1.0, abs=1e-12)


def test_oracle_table_is_the_reference_one():
    assert oracle.DIRECTION_TABLE.shape == (100, 3)
    assert np.allclose(np.linalg.norm(oracle.DIRECTION_TABLE, axis=1), 1.0)


def _pairs(seed, n, verts, sides):
    gen = torch.Generator().manual_seed(seed)
    return tuple(traffic.draw_side(gen, n, verts, *s, "cpu") for s in sides)


def test_port_agrees_with_the_oracle():
    p1, p2 = _pairs(8, 48, 24, [(2.0, 0.0), (0.5, 0.2)])
    out = port.gjkepa_batch_fused(p1, p2, cfg=CFG)
    ref = reference.oracle_rows(p1.double().numpy(), p2.double().numpy())
    got = {f: getattr(out, f).numpy() for f in
           ("hit", "depth", "normal", "contact_point", "nearest_points")}
    n = check.contact_numbers(got, ref)
    assert ref["valid"].sum() >= 40
    assert n["depth_err"] < 1e-5
    assert n["normal_off_share"] == n["contact_point_off_share"] == 0
    assert n["nearest_off_share"] == 0


def test_port_agrees_with_the_distance():
    p1, p2 = _pairs(9, 1024, 32, [(1.0, 0.8)] * 2)
    ref = reference.hull_distance(p1, p2)
    b = port.fused_gjkepa_hulls(p1, p2, cfg=CFG.replace(epa_max_iters=0))
    n = check.hit_numbers([(ref, b.hit, b.distance)])
    assert n["hit_mismatches"] == 0 and n["separation_excess"] < 1e-5
    d = port.fused_gjk_distance_hulls(p1, p2, cfg=CFG)
    far = ref["distance"] >= 1e-2
    assert (d.distance.double() - ref["distance"])[far].abs().max() < 1e-4
