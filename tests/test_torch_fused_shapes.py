"""The analytic-shape query (K5, K6a, K6b, K7 and the dispatch): the port's
plain path against the JAX fused path in interpret mode, and port-only
checks of the dispatch.

One JAX interpret-mode call (the module fixture, 128 pairs: at B <= 128 the
JAX dispatch takes its grouped K6b + K7 branch, whose per-lane results the
JAX package pins equal to its split branch).  Tolerances against JAX:

  * hit and status exact; retired lanes identical;
  * gjk_iters equal on >= 95% of lanes (XLA:CPU fuses multiply-adds, the
    port rounds every op; a last-bit difference can move a GJK iteration:
    1 of 128 lanes here);
  * closed-form lanes: depth, normal and distance within 1e-6;
  * polished EPA lanes: depth within 1e-5, normal dot > 1-1e-4 on >= 95%;
  * distance within 1e-6 on >= 95% of lanes and 5e-5 on all: on GJK-miss
    lanes it is the largest -<w, d> over the probes, so the same last-bit
    differences move it along the GJK path (measured 1.04e-5 on 1 lane).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.models.shapes import ShapeBatch as JaxShapes
from gjkepa_tpu.ops import fused as jfused
from gjkepa_tpu_torch import (GJKEPAConfig, ShapeBatch, Status, _build,
                              fused_gjkepa_shapes)
from gjkepa_tpu_torch.models import fixtures
from gjkepa_tpu_torch.ops import fused_shapes as fs
from gjkepa_tpu_torch.ops.fused import hit_first_order
from gjkepa_tpu_torch.ops.lane_geom import P3
from gjkepa_tpu_torch.ops.shape_geom import (cf_kind_mask, make_shape_support,
                                             shape_of)

torch.set_num_threads(1)

JAX_CFG = JaxConfig.for_f32()
CFG = GJKEPAConfig.from_reference(dataclasses.asdict(JAX_CFG))


def _port(pairs, cfg=CFG, **kw):
    return fused_gjkepa_shapes(*(ShapeBatch.from_numpy(*p, device="cpu")
                                 for p in pairs), cfg=cfg, **kw)


@pytest.fixture(scope="module")
def mixed():
    pairs = fixtures.mixed16_pairs(8, 0)
    ref = jfused.fused_gjkepa_shapes(
        *(JaxShapes(*(jnp.asarray(x) for x in p)) for p in pairs),
        cfg=JAX_CFG, interpret=True)
    ref = {f: np.asarray(x) for f, x in zip(ref._fields, ref)}
    r = _port(pairs)
    got = {f: x.numpy() for f, x in zip(r._fields, r)}
    cf = cf_kind_mask(*(torch.from_numpy(p[0]).float() for p in pairs))
    return pairs, ref, got, cf.numpy()


def test_discrete_fields_match_jax(mixed):
    _, ref, got, _ = mixed
    for f in ("hit", "status"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    assert 10 <= got["hit"].sum() <= 118
    assert (got["gjk_iters"] == ref["gjk_iters"]).mean() >= 0.95
    assert (got["epa_iters"] == ref["epa_iters"]).mean() >= 0.95


def test_closed_form_lanes_match_jax(mixed):
    _, ref, got, cf = mixed
    assert cf.sum() == 9 * 8 and got["hit"][cf].sum() >= 10
    for f in ("depth", "normal", "distance"):
        np.testing.assert_allclose(got[f][cf], ref[f][cf], rtol=0, atol=1e-6,
                                   err_msg=f)


def test_polished_lanes_match_jax(mixed):
    _, ref, got, cf = mixed
    lanes = got["hit"] & ~cf
    assert lanes.sum() >= 8 and (got["epa_iters"][lanes] > 0).all()
    np.testing.assert_allclose(got["depth"][lanes], ref["depth"][lanes],
                               rtol=0, atol=1e-5)
    dots = np.einsum("ij,ij->i", got["normal"][lanes], ref["normal"][lanes])
    assert (dots > 1.0 - 1e-4).mean() >= 0.95, dots


def test_distance_and_retirement_match_jax(mixed):
    """Retired lanes (a certified envelope miss: MISS_BROADPHASE with a
    positive distance on a {capsule, cylinder}^2 pair without a closed
    form) are the same lanes
    on both sides; every difference would be counted here."""
    pairs, ref, got, cf = mixed
    swept = np.isin(pairs[0][0], (2, 3)) & np.isin(pairs[1][0], (2, 3)) & ~cf

    def retired(r):
        return (swept & (r["status"] == Status.MISS_BROADPHASE)
                & (r["distance"] > 0))

    assert retired(got).sum() >= 4
    assert int((retired(got) != retired(ref)).sum()) == 0
    a, b = (ShapeBatch.from_numpy(*p, device="cpu") for p in pairs)
    np.testing.assert_array_equal(fs.retirement(a, b)[0].numpy(), retired(got))
    err = np.abs(got["distance"] - ref["distance"])
    assert (err <= 1e-6).mean() >= 0.95 and err.max() <= 5e-5, err.max()


@pytest.mark.parametrize("case", ["mixed512", "dense_cyl", "padded400"])
def test_sort_hits_true_equals_false(case):
    """The split pipeline (K5, K6a, K7) and the single-kernel one (K6b, K7)
    give the same result on every field (tests/test_shapes.py:314-321)."""
    if case == "mixed512":
        pairs = fixtures.mixed16_pairs(32, 7)
    elif case == "dense_cyl":
        rng = np.random.default_rng(3)
        pairs = (fixtures.kind_batch(3, 512, rng, spread=0.2),
                 fixtures.kind_batch(3, 512, rng, spread=0.2))
    else:
        pairs = fixtures.mixed16_pairs(25, 9)
    r1, r2 = _port(pairs, sort_hits=True), _port(pairs, sort_hits=False)
    for f, x, y in zip(r1._fields, r1, r2):
        assert torch.equal(x, y), f
    if case == "dense_cyl":
        assert int(r1.hit.sum()) > 256


def test_shuffled_order_gives_shuffled_results():
    *shuf, perm = fixtures.c3_shuffled(0, 1024)
    r, rs = _port(fixtures.c3_pairs(0, 1024)), _port(shuf)
    assert int(r.hit.sum()) > 20 and int((r.epa_iters > 0).sum()) > 0
    for f, x, y in zip(r._fields, r, rs):
        assert torch.equal(y, x[torch.from_numpy(perm)]), f


def test_boolean_mode_keeps_closed_form_depth():
    pairs = fixtures.mixed16_pairs(8, 0)
    full = _port(pairs)
    boolean = _port(pairs, cfg=CFG.replace(epa_max_iters=0))
    cf = cf_kind_mask(*(torch.from_numpy(p[0]).float() for p in pairs))
    assert torch.equal(boolean.hit, full.hit)
    assert torch.equal(boolean.depth[cf], full.depth[cf])
    assert torch.equal(boolean.normal[cf], full.normal[cf])
    assert not bool(boolean.depth[~cf].any())
    assert not bool(boolean.epa_iters.any())
    assert int((full.hit & cf).sum()) >= 10


def test_known_geometry():
    """Two unit spheres at 1.5 give depth 0.5 exactly; sphere-box and
    offset box-box pairs give their closed-form depths."""
    eye = np.eye(3, dtype=np.float32)
    a = (np.array([0, 0, 1], np.int32),
         np.array([[1, 0, 0], [0.5, 0, 0], [0.5, 0.5, 0.5]], np.float32),
         np.array([[0, 0, 0], [0.9, 0.1, 0], [0, 0, 0]], np.float32),
         np.stack([eye] * 3))
    b = (np.array([0, 1, 1], np.int32),
         np.array([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, 0.5, 0.5]], np.float32),
         np.array([[1.5, 0, 0], [0, 0, 0], [0.7, 0.2, 0]], np.float32),
         np.stack([eye] * 3))
    r = _port((a, b))
    assert bool(r.hit.all()) and float(r.depth[0]) == 0.5
    np.testing.assert_allclose(r.depth.numpy(), [0.5, 0.1, 0.3], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(r.normal.numpy(), [[1, 0, 0], [-1, 0, 0],
                                                  [1, 0, 0]], atol=1e-6)


def test_split_membership_on_razor_edge_lanes():
    """JAX compacts on a predicate with a relative margin (a superset of the
    in-kernel activity); the port compacts on K5's in-kernel ``act``.  A
    lane in the margin but inactive in the kernel gets K6a's inactive row,
    which is K5's row: both routes give the same result."""
    n = 64
    eye = np.eye(3, dtype=np.float32)
    ra = np.sqrt(np.float32(3 * 0.25)).astype(np.float32)   # box 0.5^3
    rb = np.float32(0.3 + 0.4)                                # cylinder
    rr = ra + rb + np.float32(CFG.broadphase_tol)
    off = np.linspace(-2e-6, 2e-4, n).astype(np.float32)
    a = (np.full(n, 1, np.int32), np.full((n, 3), 0.5, np.float32),
         np.zeros((n, 3), np.float32), np.stack([eye] * n))
    b = (np.full(n, 3, np.int32),
         np.tile(np.float32([0.3, 0.4, 0]), (n, 1)),
         np.stack([rr + off, 0 * off, 0 * off], 1).astype(np.float32),
         np.stack([eye] * n))
    A, B = (ShapeBatch.from_numpy(*x, device="cpu") for x in (a, b))
    sa, sb = A.packed(), B.packed()
    retired, _ = fs.retirement(A, B)
    c = fs.cf_shapes(sa, sb, retired, CFG)
    gap = np.linalg.norm(b[2] - a[2], axis=1)
    g0 = gap <= rr + 1e-4 + 1e-4 * abs(rr)                   # JAX's margin
    razor = g0 & ~c.act.numpy()
    assert razor.sum() >= 10 and c.act.any()
    everything = torch.arange(n, dtype=torch.int32)
    g = fs.gjk_sub_shapes(sa, sb, retired, everything,
                          torch.tensor(n, dtype=torch.int32), CFG)
    lanes = torch.from_numpy(razor)
    assert torch.equal(g.status[lanes], c.status[lanes])
    assert torch.equal(g.hit[lanes], c.hit[lanes])
    assert torch.equal(g.sep[lanes], c.distance[lanes])
    assert not bool(g.iters[lanes].any())


def test_polish_matches_jax():
    """The polish alone, both sides from the same normals: exact-ish depth
    and normal, promote to HIT, degenerate (zero) normals pass through."""
    rng = np.random.default_rng(5)
    n = 48
    a = fixtures.concat(fixtures.kind_batch(3, n // 2, rng, 0.3),
                        fixtures.kind_batch(2, n // 2, rng, 0.3))
    b = fixtures.concat(fixtures.kind_batch(1, n // 2, rng, 0.3),
                        fixtures.kind_batch(3, n // 2, rng, 0.3))
    nrm = (b[2] - a[2]) + rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    nrm[::9] = 0.0
    depth = rng.random(n).astype(np.float32)
    status = np.where(np.arange(n) % 3 == 0, Status.HIT_EPA_CAPACITY,
                      Status.HIT_EPA_CAP).astype(np.int32)
    ok = np.arange(n) % 7 != 3
    A, B = (ShapeBatch.from_numpy(*x, device="cpu") for x in (a, b))
    sa, sb = A.packed(), B.packed()
    d, nn, st = fs.polish_direction(
        make_shape_support(shape_of(sa), shape_of(sb)), torch.from_numpy(depth),
        P3(*(torch.from_numpy(nrm[:, k].copy()) for k in range(3))),
        torch.from_numpy(status), torch.from_numpy(ok))
    row = lambda x: jnp.asarray(x[None, :])  # noqa: E731
    jd, jn, jst = jfused._polish_direction(
        jfused._make_shape_support(jnp.asarray(sa.numpy().T),
                                   jnp.asarray(sb.numpy().T)),
        row(depth), jfused.P3(*(row(nrm[:, k]) for k in range(3))),
        row(status), row(ok), n, promote_capacity=True)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst)[0])
    np.testing.assert_allclose(d.numpy(), np.asarray(jd)[0], rtol=0,
                               atol=1e-5)
    jn = np.stack([np.asarray(c)[0] for c in jn], 1)
    dots = np.einsum("ij,ij->i", torch.stack(list(nn), 1).numpy(), jn)
    moved = ok & (np.linalg.norm(nrm, axis=1) > 0.5)
    assert moved.sum() >= 30 and (dots[moved] > 1 - 1e-4).mean() >= 0.95
    assert (st.numpy()[moved] == Status.HIT).all()
    np.testing.assert_array_equal(d.numpy()[~moved], depth[~moved])


def test_shape_stage_plan():
    plan = [(c.epa_max_faces, c.epa_max_iters, k)
            for c, k in fs.shape_stages(CFG)]
    assert plan == [(48, 16, 8), (48, 16, 16)]
    assert fs.shape_stages(CFG.replace(epa_max_iters=0)) == []


def _rows():
    pairs = fixtures.mixed16_pairs(1, 2)
    A, B = (ShapeBatch.from_numpy(*p, device="cpu") for p in pairs)
    return A.packed(), B.packed(), fs.retirement(A, B)[0]


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors the shape wrappers never build or launch a kernel."""
    def no_build():
        raise AssertionError("kernel build attempted for CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    before = dict(fs.LAUNCHES)
    pairs = fixtures.mixed16_pairs(4, 1)
    _port(pairs, sort_hits=True)
    _port(pairs, sort_hits=False)
    assert fs.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["K5", "K6a", "K6b", "K7"])
def test_unsupported_device_raises(kernel):
    """A tensor on a device with no kernel is refused, not moved."""
    sa, sb, ret = (t.to("meta") for t in _rows())
    b = sa.shape[0]
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match=f"no {kernel} kernel for device meta"):
        if kernel == "K5":
            fs.cf_shapes(sa, sb, ret, CFG)
        elif kernel == "K6a":
            fs.gjk_sub_shapes(sa, sb, ret, torch.empty(b, **i32),
                              torch.empty((), **i32), CFG)
        elif kernel == "K6b":
            fs.gjk_shapes(sa, sb, ret, CFG)
        else:
            f32 = dict(dtype=torch.float32, device="meta")
            fs.epa_shapes(sa, sb, torch.empty((b, 4, 3), **f32),
                          torch.empty(b, **i32), torch.empty(b, **f32),
                          torch.empty((b, 3), **f32), torch.empty(b, **i32),
                          torch.empty((), **i32), fs.shape_stages(CFG))


def test_wrappers_reject_what_the_kernels_do_not_take():
    sa, sb, ret = _rows()
    with pytest.raises(ValueError, match="float32"):
        fs.cf_shapes(sa.double(), sb, ret, CFG)
    with pytest.raises(ValueError, match="contiguous"):
        fs.gjk_shapes(sa.T.contiguous().T, sb, ret, CFG)
    with pytest.raises(ValueError, match="retired"):
        fs.cf_shapes(sa, sb, ret.int(), CFG)
    shifted = torch.zeros(sa.numel() + 1)[1:].view(sa.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fs.cf_shapes(shifted, sb, ret, CFG)
    order, n_act = hit_first_order(ret)
    with pytest.raises(ValueError, match="n_act"):
        fs.gjk_sub_shapes(sa, sb, ret, order, n_act.long(), CFG)
    a, b = (ShapeBatch.from_numpy(*p, device="cpu")
            for p in fixtures.mixed16_pairs(1, 2))
    with pytest.raises(ValueError, match="batch sizes differ"):
        fused_gjkepa_shapes(a, ShapeBatch(*(t[:3] for t in b)))
    with pytest.raises(ValueError, match="is on meta"):
        fused_gjkepa_shapes(a, ShapeBatch(b.kind, b.params, b.pos.to("meta"),
                                          b.rot))
