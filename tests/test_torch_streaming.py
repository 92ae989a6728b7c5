"""The port's large-hull path (n1 + n2 > 4096) against the JAX package's
HBM-streamed pipeline, on the same numpy inputs (port of
tests/test_streaming.py).

The JAX package routes hulls with n1 + n2 > 4096 to
``_fused_hulls_streamed``, which decides the bounding-sphere broadphase on
the hulls padded to a tile multiple by repeating vertex 0, so that the
centroid counts the repeats; the port's ``fused_hulls_streamed`` does the
same, and this file shows a lane where that verdict differs from the
resident path's.  The CUDA kernels (K12, K13) are held against their plain
versions in tests/test_torch_cuda.py; here the plain versions run.

Tolerances: hit and status exact; gjk_iters exact on hit lanes and on >= 95%
of all lanes, epa_iters on >= 97% (XLA:CPU fuses multiply-adds, the port
does not: on miss lanes the GJK loop can stop one step apart, as on the
resident path, see test_torch_api.py); depth and distance atol 1e-6;
contact rows as in test_torch_api.py.  K11's reduction rule is held to
torch.argmax (the first maximum) on tie-heavy dots.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.api import derive_contact_batch as jax_contact
from gjkepa_tpu.ops.fused import (_AUTO_BLOCK_BUDGET, _fused_hulls_streamed,
                                  fused_gjkepa_hulls as jax_fused_hulls)
from gjkepa_tpu_torch import GJKEPAConfig, fused_gjkepa_hulls
from gjkepa_tpu_torch import gjkepa_batch_fused
from gjkepa_tpu_torch.ops import fused as fused_mod
from gjkepa_tpu_torch.ops import fused_streamed as fst

torch.set_num_threads(1)

JAX_CFG = JaxConfig.for_f32()
CFG = GJKEPAConfig.from_reference(dataclasses.asdict(JAX_CFG))


def _hulls(rng, b, n, spread=0.6):
    """test_streaming.py's generator."""
    v = rng.normal(size=(b, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= 0.5 + 0.5 * rng.random((b, n, 1))
    return (v + rng.normal(size=(b, 1, 3)) * spread).astype(np.float32)


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _assert_iters(got, ref):
    """gjk_iters exact on hits and on >= 95% of lanes; epa_iters on >=
    97%."""
    hit = got.hit.numpy()
    it, it_ref = got.gjk_iters.numpy(), np.asarray(ref.gjk_iters)
    np.testing.assert_array_equal(it[hit], it_ref[hit])
    assert (it == it_ref).mean() >= 0.95, np.nonzero(it != it_ref)
    it, it_ref = got.epa_iters.numpy(), np.asarray(ref.epa_iters)
    assert (it == it_ref).mean() >= 0.97, np.nonzero(it != it_ref)


# -- (a) the streamed pipeline equals the resident one at a tile multiple ----

def test_streamed_bitwise_matches_resident(rng):
    """N = 64 is a multiple of the tile, so the padded broadphase is the
    resident one and every field agrees bit for bit."""
    p1, p2 = _torch(_hulls(rng, 128, 64), _hulls(rng, 128, 64))
    rs = fst.fused_hulls_streamed(p1, p2, CFG, tile=16)
    rr = fused_gjkepa_hulls(p1, p2, cfg=CFG)
    for name, a, b in zip(rr._fields, rs, rr):
        assert torch.equal(a, b), name
    assert int(rr.hit.sum()) > 20


# -- (b) tile padding: the port against the JAX streamed pipeline ------------

@pytest.fixture(scope="module")
def padded_pair():
    """b=128 hulls of 40 vertices, padded to 48 at tile 16, spread 1.2 so
    that some lanes miss on the broadphase; the JAX streamed pipeline, the
    port's and the port's resident path."""
    rng = np.random.default_rng(0)
    p1, p2 = _hulls(rng, 128, 40, 1.2), _hulls(rng, 128, 40, 1.2)
    ref = _fused_hulls_streamed(jnp.asarray(p1), jnp.asarray(p2), 128,
                                JAX_CFG, True, True, True, block=128, tile=16)
    t1, t2 = _torch(p1, p2)
    got = fst.fused_hulls_streamed(t1, t2, CFG, tile=16)
    resident = fused_gjkepa_hulls(t1, t2, cfg=CFG)
    return p1, p2, ref, got, resident


def test_streamed_padding_matches_jax(padded_pair):
    _, _, ref, got, _ = padded_pair
    hit = got.hit.numpy()
    assert 10 <= hit.sum() < len(hit)
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert (got.status.numpy() == 0).any()          # broadphase misses
    _assert_iters(got, ref)
    for name in ("depth", "distance"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-6,
                                   err_msg=name)


def test_padded_centroid_decides_the_broadphase(padded_pair):
    """The fault the large-hull path repairs: the padded centroid changes
    the broadphase verdict of some lane against the resident path, and no
    lane's verdict is within rounding of the boundary (so the exact
    agreement above is not luck)."""
    p1, p2, _, got, resident = padded_pair
    differ = got.status != resident.status
    assert bool(differ.any())
    assert bool(((got.status == 0) ^ (resident.status == 0))[differ].all())

    def padded(p):
        k = (-p.shape[1]) % 16
        return np.concatenate([p, np.repeat(p[:, :1], k, 1)], 1)

    q1, q2 = (padded(p).astype(np.float64) for p in (p1, p2))
    c1, c2 = q1.mean(1), q2.mean(1)
    r1 = np.linalg.norm(q1 - c1[:, None], axis=2).max(1)
    r2 = np.linalg.norm(q2 - c2[:, None], axis=2).max(1)
    margin = np.linalg.norm(c1 - c2, axis=1) - (r1 + r2 + CFG.broadphase_tol)
    assert np.abs(margin).min() > 1e-5


# -- (c) the threshold and the route ------------------------------------------

def test_threshold_and_tile_are_the_jax_packages():
    assert fst.STREAM_THRESHOLD == _AUTO_BLOCK_BUDGET // (3 * 4 * 128) == 4096
    tile = inspect.signature(_fused_hulls_streamed).parameters["tile"]
    assert fst.TILE == tile.default == 1024
    assert not fst.streams(2048, 2048) and fst.streams(2048, 2049)


@pytest.mark.parametrize("n2,streamed", [(2048, False), (2049, True)])
def test_fused_gjkepa_hulls_routes_on_the_threshold(monkeypatch, n2, streamed):
    """n1 + n2 = 4096 takes K1/K2's plain versions, 4097 the large-hull
    path (counted by spies on the two entry points)."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fused_mod, "gjk_hulls",
                        spy("resident", fused_mod.gjk_hulls))
    monkeypatch.setattr(fused_mod, "fused_hulls_streamed",
                        spy("streamed", fused_mod.fused_hulls_streamed))
    rng = np.random.default_rng(5)
    p1, p2 = _torch(_hulls(rng, 2, 2048, 0.3), _hulls(rng, 2, n2, 0.3))
    r = fused_gjkepa_hulls(p1, p2, cfg=CFG)
    assert calls == ["streamed" if streamed else "resident"]
    assert bool(r.hit.any())


# -- (d) the public entry points at n1 + n2 = 4112 ----------------------------

@pytest.fixture(scope="module")
def big_pair():
    """b=16 hulls of 2056 vertices (padded to 3072 in the broadphase):
    the JAX package streams them, and so does the port.  The JAX side is
    its ``gjkepa_batch_fused`` in two calls (the query, then the contact
    rows): under one jit the interpret-mode kernels take minutes to
    compile."""
    rng = np.random.default_rng(2)
    p1, p2 = _hulls(rng, 16, 2056, 0.5), _hulls(rng, 16, 2056, 0.5)
    j1, j2 = jnp.asarray(p1), jnp.asarray(p2)
    ref = jax_contact(j1, j2, jax_fused_hulls(j1, j2, cfg=JAX_CFG,
                                              interpret=True), JAX_CFG)
    got = gjkepa_batch_fused(*_torch(p1, p2), cfg=CFG)
    return ref, got


def test_public_path_streams_and_matches_jax(big_pair):
    ref, got = big_pair
    assert fst.streams(2056, 2056)
    hit = got.hit.numpy()
    assert 4 <= hit.sum() < len(hit)
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    _assert_iters(got, ref)
    for name in ("depth", "distance"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-6,
                                   err_msg=name)


def test_public_path_contact_rows_match_jax(big_pair):
    ref, got = big_pair
    hit = got.hit.numpy()
    dots = np.einsum("ij,ij->i", got.normal.numpy(), np.asarray(ref.normal))
    agree = hit & (dots > 1.0 - 1e-5)
    assert agree.sum() >= 0.9 * hit.sum()
    np.testing.assert_array_equal(got.colli_type.numpy()[agree],
                                  np.asarray(ref.colli_type)[agree])
    np.testing.assert_allclose(got.contact_point.numpy()[agree],
                               np.asarray(ref.contact_point)[agree], atol=1e-5)
    assert not got.contact_point.numpy()[~hit].any()


# -- (e) K11's reduction: the first maximum under ties ------------------------

def _tie_dots(case):
    rng = np.random.default_rng(9)
    if case == "all_equal":
        return np.full((4, 100), 0.25, np.float32)
    if case == "short":                 # n < 32: threads that own nothing
        d = rng.integers(-3, 3, size=(64, 7)).astype(np.float32)
        d[:, 4] = d[:, 2] = 5.0
        return d
    d = rng.integers(-20, 20, size=(64, 200)).astype(np.float32)
    if case == "same_thread":           # i and i + 32k: one thread's scan
        d[:, [70, 6, 166]] = 30.0
    elif case == "other_threads":       # i and i + 1: two threads
        d[:, [41, 40, 199]] = 30.0
    elif case == "ragged":              # n not a multiple of 32, grid ties
        d = rng.integers(-2, 3, size=(64, 77)).astype(np.float32)
    return d


@pytest.mark.parametrize("case", ["all_equal", "short", "same_thread",
                                  "other_threads", "ragged"])
def test_warp_first_max_is_the_first_maximum(case):
    dots = torch.from_numpy(_tie_dots(case))
    got = fst.warp_first_max_plain(dots)
    assert torch.equal(got, torch.argmax(dots, dim=1))
    if case in ("same_thread", "other_threads"):
        assert bool((got == {"same_thread": 6, "other_threads": 40}[case]).all())


def test_tie_fixture_tells_the_first_maximum_from_another(monkeypatch):
    """The tie fixture of tests/test_torch_cuda.py and chip_smoke.py: the
    plain path with the warp reduction as its support rule equals the
    first-max path bit for bit, and a support that takes the last maximum
    instead changes the results (so the card's bit-for-bit check can see a
    wrong tie rule)."""
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_gjk
    from gjkepa_tpu_torch.ops.lane_geom import P3

    p1, p2 = _torch(*fixtures.tie_pairs(48, 2100, 2100))
    first = fst.fused_hulls_streamed(p1, p2, CFG)

    def vertex_by(rule):
        def hull_vertex(p, d, sign=1.0):
            dots = sign * (p[:, :, 0] * d.x[:, None] + p[:, :, 1] * d.y[:, None]
                           + p[:, :, 2] * d.z[:, None])
            idx = rule(dots)
            return P3(*(torch.gather(p[:, :, k], 1, idx[:, None])[:, 0]
                        for k in range(3)))
        return hull_vertex

    monkeypatch.setattr(fused_gjk, "hull_vertex",
                        vertex_by(fst.warp_first_max_plain))
    warp = fst.fused_hulls_streamed(p1, p2, CFG)
    for name, a, b in zip(first._fields, first, warp):
        assert torch.equal(a, b), name
    monkeypatch.setattr(fused_gjk, "hull_vertex", vertex_by(
        lambda d: d.shape[1] - 1 - torch.argmax(d.flip(1), dim=1)))
    last = fst.fused_hulls_streamed(p1, p2, CFG)
    assert not torch.equal(first.normal, last.normal)
    assert int(first.hit.sum()) > 10
