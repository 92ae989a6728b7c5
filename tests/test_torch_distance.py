"""The distance queries: the fused hull query (K8 and its two-phase
dispatch) and the portable ``gjk_distance_batch`` /
``gjk_distance_shapes_batch``, the port against the JAX package.

One JAX interpret-mode call (the module fixture: ``tests/test_fused.py``'s
128 x 12 hull pairs at spread 2.0).  Tolerances against JAX:

  * ``intersecting`` exact;
  * ``iters`` equal on >= 95% of lanes (XLA:CPU fuses multiply-adds, the
    port rounds every op, and a last-bit difference can move the duality
    gap test by one iteration);
  * ``distance`` within 1e-5 (float32), and the witnesses realise it:
    |point_a - point_b| = distance within 1e-5;
  * the portable hull query: 1e-9 in float64, 1e-5 in float32;
  * the portable shape query: 1e-8 in float64; in float32 1e-5 on >= 95%
    of lanes and 1e-3 on all: on a curved pair the float32 duality gap
    stalls near the tolerance, and one side may stop at iteration 14 where
    the other runs to the cap of 64 (measured 5.2e-5 on 1 of 64 lanes at
    seed 3, 3.2e-4 at seed 5; float64 agrees within 7e-10).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.api import gjk_distance_batch as jax_distance
from gjkepa_tpu.api import gjk_distance_shapes_batch as jax_distance_shapes
from gjkepa_tpu.models.shapes import ShapeBatch as JaxShapes
from gjkepa_tpu.ops import fused as jfused
from gjkepa_tpu_torch import GJKEPAConfig, ShapeBatch, _build
from gjkepa_tpu_torch.api import gjk_distance_batch, gjk_distance_shapes_batch
from gjkepa_tpu_torch.models import fixtures
from gjkepa_tpu_torch.ops import fused_distance as fd
from gjkepa_tpu_torch.ops.fused import fused_gjk_distance_hulls
from tests.conftest import cube, random_hull

torch.set_num_threads(1)

JAX_CFG = JaxConfig.for_f32()
CFG = GJKEPAConfig.from_reference(dataclasses.asdict(JAX_CFG))


def _hull_pairs(rng, b, n, spread):
    """tests/test_fused.py's ``_batch``."""
    return tuple(np.stack([random_hull(rng, n, center=rng.normal(size=3)
                                       * spread)
                           for _ in range(b)]).astype(np.float32)
                 for _ in range(2))


@pytest.fixture(scope="module")
def fused():
    p1, p2 = _hull_pairs(np.random.default_rng(0), 128, 12, spread=2.0)
    ref = jfused.fused_gjk_distance_hulls(jnp.asarray(p1), jnp.asarray(p2),
                                          cfg=JAX_CFG, interpret=True)
    ref = {f: np.asarray(x) for f, x in zip(ref._fields, ref)}
    got = fused_gjk_distance_hulls(torch.from_numpy(p1), torch.from_numpy(p2),
                                   cfg=CFG)
    return ref, {f: x.numpy() for f, x in zip(got._fields, got)}


def test_fused_distance_discrete_fields_match_jax(fused):
    ref, got = fused
    np.testing.assert_array_equal(got["intersecting"], ref["intersecting"])
    assert (~got["intersecting"]).sum() > 50
    assert (got["iters"] == ref["iters"]).mean() >= 0.95


def test_fused_distance_matches_jax(fused):
    ref, got = fused
    np.testing.assert_allclose(got["distance"], ref["distance"], rtol=0,
                               atol=1e-5)
    assert not got["distance"][got["intersecting"]].any()


def test_fused_witnesses_realise_the_distance(fused):
    _, got = fused
    sep = ~got["intersecting"]
    gap = np.linalg.norm(got["point_a"] - got["point_b"], axis=1)
    np.testing.assert_allclose(gap[sep], got["distance"][sep], rtol=0,
                               atol=1e-5)


def _two_phase_batch(rng, b, n, spread):
    """tests/test_distance_two_phase.py's ``_batch``."""
    v = rng.normal(size=(b, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= 0.5 + 0.5 * rng.random((b, n, 1))
    c = rng.normal(size=(b, 1, 3)) * spread
    return (torch.from_numpy((v + c).astype(np.float32)),
            torch.from_numpy((v[::-1] + c[::-1] * -0.5).astype(np.float32)))


@pytest.mark.parametrize("phase1_iters", [2, 12])
def test_two_phase_equals_single_phase(phase1_iters):
    """The restart retraces the single pass: every field bit-identical,
    with phase 1 leaving most lanes unconverged (2) or few (12)."""
    p1, p2 = _two_phase_batch(np.random.default_rng(0), 512, 12, 2.0)
    two = fused_gjk_distance_hulls(p1, p2, cfg=CFG, two_phase=True,
                                   phase1_iters=phase1_iters)
    one = fused_gjk_distance_hulls(p1, p2, cfg=CFG, two_phase=False)
    for name, x, y in zip(one._fields, two, one):
        assert torch.equal(x, y), name
    stragglers = int((one.iters > phase1_iters).sum())
    assert stragglers > (64 if phase1_iters == 2 else 0)


def test_masks_equal_repeated_vertex_padding():
    rng = np.random.default_rng(4)
    p1, p2 = (torch.from_numpy(x) for x in _hull_pairs(rng, 64, 10, 1.5))
    n1 = torch.from_numpy(rng.integers(4, 11, size=64))
    mask = torch.arange(10)[None, :] < n1[:, None]
    padded = torch.where(mask[:, :, None], p1, p1[:, :1])
    r1 = fused_gjk_distance_hulls(p1, p2, mask1=mask, cfg=CFG)
    r2 = fused_gjk_distance_hulls(padded, p2, cfg=CFG)
    for name, x, y in zip(r1._fields, r1, r2):
        assert torch.equal(x, y), name


def _known_pairs():
    """test_distance.py's known geometry, padded to 8 vertices by repeating
    a vertex: cube gap 1, overlapping cubes, a tetrahedron apex 1 from a
    cube face, two segments crossing at height 0.3."""
    def pad(v):
        return np.concatenate([v, np.repeat(v[:1], 8 - len(v), 0)])

    tet = np.array([[1.0, 0, 0], [0, 0.6, 0.1], [0, -0.5, 0.4],
                    [0, -0.1, -0.6]])
    seg1 = np.array([[-1.0, 0, 0], [1.0, 0, 0]])
    seg2 = np.array([[0.0, -1, 0.3], [0.0, 1, 0.3]])
    p1 = np.stack([cube([0, 0, 0]), cube([0, 0, 0]), pad(tet), pad(seg1)])
    p2 = np.stack([cube([2.0, 0, 0]), cube([0.5, 0, 0]), cube([2.5, 0, 0]),
                   pad(seg2)])
    return p1, p2, np.array([1.0, 0.0, 1.0, 0.3])


def _random_pairs():
    """test_distance.py's witnesses-realise-distance batch."""
    rng = np.random.default_rng(0)
    p1 = np.stack([random_hull(rng, 12, center=rng.normal(size=3) * 2.0)
                   for _ in range(32)])
    p2 = np.stack([random_hull(rng, 12, center=rng.normal(size=3) * 2.0)
                   for _ in range(32)])
    return p1, p2


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["known", "random"])
def test_distance_batch_matches_jax(dtype, case):
    if case == "known":
        p1, p2, want = _known_pairs()
    else:
        p1, p2 = _random_pairs()
    p1, p2 = p1.astype(dtype), p2.astype(dtype)
    tol = 1e-9 if dtype == "float64" else 1e-5
    jax_cfg, cfg = ((JaxConfig(), GJKEPAConfig()) if dtype == "float64"
                    else (JAX_CFG, CFG))
    ref = jax_distance(jnp.asarray(p1), jnp.asarray(p2), cfg=jax_cfg)
    got = gjk_distance_batch(torch.from_numpy(p1), torch.from_numpy(p2),
                             cfg=cfg)
    assert got.distance.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.intersecting.numpy(),
                                  np.asarray(ref.intersecting))
    for f in ("distance", "point_a", "point_b"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=tol, err_msg=f)
    sep = ~got.intersecting.numpy()
    gap = np.linalg.norm(got.point_a.numpy() - got.point_b.numpy(), axis=1)
    np.testing.assert_allclose(gap[sep], got.distance.numpy()[sep], rtol=0,
                               atol=tol)
    if case == "known":
        np.testing.assert_allclose(got.distance.numpy(), want, rtol=0,
                                   atol=tol)
        assert got.point_a[0, 0] == pytest.approx(0.5, abs=tol)
        assert got.point_b[0, 0] == pytest.approx(1.5, abs=tol)
    else:
        assert sep.sum() >= 16


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_distance_shapes_batch_matches_jax(dtype):
    pairs = [tuple(x.astype(dtype) if x.dtype == np.float32 else x
                   for x in p) for p in fixtures.mixed16_pairs(4, 3)]
    jax_cfg, cfg = ((JaxConfig(), GJKEPAConfig()) if dtype == "float64"
                    else (JAX_CFG, CFG))
    ref = jax_distance_shapes(*(JaxShapes(*(jnp.asarray(x) for x in p))
                                for p in pairs), cfg=jax_cfg)
    got = gjk_distance_shapes_batch(
        *(ShapeBatch.from_numpy(*p, device="cpu", dtype=getattr(torch, dtype))
          for p in pairs), cfg=cfg)
    assert got.distance.dtype == getattr(torch, dtype)
    inter = np.asarray(ref.intersecting)
    np.testing.assert_array_equal(got.intersecting.numpy(), inter)
    assert 8 <= (~inter).sum() <= 60
    err = np.abs(got.distance.numpy() - np.asarray(ref.distance))
    if dtype == "float64":
        assert err.max() <= 1e-8, err.max()
    else:
        assert (err <= 1e-5).mean() >= 0.95 and err.max() <= 1e-3, err.max()


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_build():
        raise AssertionError("kernel build attempted for CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    before = dict(fd.LAUNCHES)
    p1, p2, _ = _known_pairs()
    r = fused_gjk_distance_hulls(torch.from_numpy(p1.astype(np.float32)),
                                 torch.from_numpy(p2.astype(np.float32)))
    np.testing.assert_allclose(r.distance.numpy(), [1.0, 0.0, 1.0, 0.3],
                               rtol=0, atol=1e-6)
    assert fd.LAUNCHES == before


@pytest.mark.parametrize("n", [12, 24, 64, 65, 256, 512, 513, 2048])
def test_k8_team_size_rule_by_phase(n):
    """K8's team: a launch over every pair (phase 1, one pass) takes K1's
    rule by hull size (4 at c2's 64 vertices); a restart of the
    unconverged pairs (phase 2) takes RESTART_TEAM; each is a team the
    kernel instantiates."""
    from gjkepa_tpu_torch.ops import fused_gjk
    every = fd.team_size(n, n, restart=False)
    assert every == fused_gjk.team_size(n, n) in fused_gjk.TEAMS
    assert fd.team_size(n, 8, restart=False) == fused_gjk.team_size(n, 8)
    assert fd.team_size(n, n, restart=True) == fd.RESTART_TEAM
    assert fd.RESTART_TEAM in fused_gjk.TEAMS
    if n == 64:
        assert every == 4


def test_k8_wrapper_passes_each_phase_its_team(monkeypatch):
    """On a card, fused_gjk_distance_hulls launches phase 1 at K1's team and
    phase 2 at RESTART_TEAM, and one pass at K1's team (the launch
    recorded, the rows from the plain version)."""
    teams = []

    def fake_launch(name, dev, counts, *args, explain=None):
        teams.append((args[2].value is not None, args[13]))
        counts[name] += 1

    monkeypatch.setattr(_build, "on_card", lambda t, k: True)
    monkeypatch.setattr(_build, "launch", fake_launch)
    p1, p2 = _two_phase_batch(np.random.default_rng(0), 64, 12, 2.0)
    fused_gjk_distance_hulls(p1, p2, cfg=CFG)
    fused_gjk_distance_hulls(p1, p2, cfg=CFG, two_phase=False)
    assert teams == [(False, 4), (True, fd.RESTART_TEAM), (False, 4)]


def test_unsupported_device_and_bad_inputs_raise():
    p1, p2, _ = _known_pairs()
    p1, p2 = (torch.from_numpy(x.astype(np.float32)) for x in (p1, p2))
    with pytest.raises(ValueError, match="no K8 kernel for device meta"):
        fd.distance_hulls(p1.to("meta"), p2.to("meta"), CFG, 64)
    with pytest.raises(TypeError, match="float32"):
        fd.distance_hulls(p1.double(), p2.double(), CFG, 64)
    with pytest.raises(ValueError, match="order and n_act"):
        fd.distance_hulls(p1, p2, CFG, 64,
                          order=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="n_act"):
        fd.distance_hulls(p1, p2, CFG, 64,
                          order=torch.zeros(4, dtype=torch.int32),
                          n_act=torch.tensor(1))
