"""The port answers every call the JAX package answers, the same way.

Three calls the JAX package takes and the port once refused, each held
against the JAX package on the same numpy inputs, and a surface test that
keeps the two packages' public functions in step.

  * ``fused_gjkepa_hulls(..., use_broadphase=False)``: every pair runs GJK,
    so a pair the bounding spheres would have rejected gets GJK's verdict
    and separation bound.  Against JAX's interpret-mode call on 256 pairs
    of 16-vertex hulls (K1's route) and on 4 pairs of 2,049 + 2,048
    vertices (the large-hull route, K12/K13).  Tolerances: hit and status
    exact; gjk_iters exact on hits and on >= 95% of lanes (XLA:CPU fuses
    multiply-adds, the port rounds every op: see tests/test_torch_gjk.py);
    depth and distance within 1e-6 on the lanes whose gjk_iters agree, and
    on every lane the distance, a separation lower bound, at most the
    float64 separation of the two hulls plus 1e-6.
  * ``gjk_distance_batch`` / ``gjk_distance_shapes_batch`` with
    ``chunk_size``: bit for bit equal to the unchunked call (every pair is
    independent), B = 0 included, and against JAX's chunked call within
    tests/test_torch_distance.py's tolerances.
  * The surface: for every public function of every ``gjkepa_tpu`` module,
    the port has a function of the same name under the same relative module
    path that accepts every parameter the JAX function takes.  EXCEPTIONS
    lists what the port leaves out on purpose, each with its reason.
"""

import dataclasses
import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import ConvexHull

import gjkepa_tpu
from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.api import gjk_distance_batch as jax_distance
from gjkepa_tpu.api import gjk_distance_shapes_batch as jax_distance_shapes
from gjkepa_tpu.models.shapes import ShapeBatch as JaxShapes
from gjkepa_tpu.ops.fused import fused_gjkepa_hulls as jax_fused_hulls
from gjkepa_tpu_torch import GJKEPAConfig, ShapeBatch, Status
from gjkepa_tpu_torch.api import gjk_distance_batch, gjk_distance_shapes_batch
from gjkepa_tpu_torch.models import fixtures
from gjkepa_tpu_torch.ops.fused import fused_gjkepa_hulls
from gjkepa_tpu_torch.ops.fused_streamed import streams
from tests.conftest import random_hull

torch.set_num_threads(1)

JAX_CFG = JaxConfig.for_f32()
CFG = GJKEPAConfig.from_reference(dataclasses.asdict(JAX_CFG))


def _separation(a, b):
    """The float64 distance between the convex hulls of vertex sets a and b:
    0 when the origin lies in the Minkowski difference, else the least
    distance from the origin to a triangle of its boundary (qhull)."""
    hull = ConvexHull((a[:, None, :] - b[None, :, :]).reshape(-1, 3))
    if (hull.equations[:, 3] <= 0.0).all():
        return 0.0
    return min(_origin_to_triangle(*hull.points[s]) for s in hull.simplices)


def _origin_to_triangle(a, b, c):
    """Distance from the origin to triangle abc (Ericson's closest point)."""
    ab, ac, ap = b - a, c - a, -a
    d1, d2 = ab @ ap, ac @ ap
    if d1 <= 0 and d2 <= 0:
        return np.linalg.norm(a)
    bp = -b
    d3, d4 = ab @ bp, ac @ bp
    if d3 >= 0 and d4 <= d3:
        return np.linalg.norm(b)
    vc = d1 * d4 - d3 * d2
    if vc <= 0 and d1 >= 0 and d3 <= 0:
        return np.linalg.norm(a + d1 / (d1 - d3) * ab)
    cp = -c
    d5, d6 = ab @ cp, ac @ cp
    if d6 >= 0 and d5 <= d6:
        return np.linalg.norm(c)
    vb = d5 * d2 - d1 * d6
    if vb <= 0 and d2 >= 0 and d6 <= 0:
        return np.linalg.norm(a + d2 / (d2 - d6) * ac)
    va = d3 * d6 - d5 * d4
    if va <= 0 and d4 - d3 >= 0 and d5 - d6 >= 0:
        return np.linalg.norm(b + (d4 - d3) / ((d4 - d3) + (d5 - d6))
                              * (c - b))
    denom = 1.0 / (va + vb + vc)
    return np.linalg.norm(a + ab * (vb * denom) + ac * (vc * denom))


# -- fused_gjkepa_hulls without the broadphase --------------------------------

def _small_pairs():
    """256 pairs of 16-vertex hulls at spread 1.2: a third of them far
    enough apart that the bounding spheres reject them."""
    rng = np.random.default_rng(0)
    return tuple(np.stack([random_hull(rng, 16,
                                       center=rng.normal(size=3) * 1.2)
                           for _ in range(256)]).astype(np.float32)
                 for _ in range(2))


def _big_pairs():
    """4 pairs of 2,049 + 2,048 vertices (n1 + n2 = 4097, the large-hull
    route), spread 1.5: one pair is a broadphase miss."""
    rng = np.random.default_rng(3)

    def hulls(n):
        v = rng.normal(size=(4, n, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        v *= 0.5 + 0.5 * rng.random((4, n, 1))
        return (v + rng.normal(size=(4, 1, 3)) * 1.5).astype(np.float32)

    return hulls(2049), hulls(2048)


@pytest.fixture(scope="module", params=["small", "large"])
def no_broadphase(request):
    """(p1, p2, JAX's result, the port's, the port's with the broadphase)
    without the broadphase, on one route."""
    p1, p2 = _small_pairs() if request.param == "small" else _big_pairs()
    assert streams(p1.shape[1], p2.shape[1]) == (request.param == "large")
    ref = jax_fused_hulls(jnp.asarray(p1), jnp.asarray(p2), cfg=JAX_CFG,
                          use_broadphase=False, interpret=True)
    t1, t2 = torch.from_numpy(p1), torch.from_numpy(p2)
    got = fused_gjkepa_hulls(t1, t2, cfg=CFG, use_broadphase=False)
    on = fused_gjkepa_hulls(t1, t2, cfg=CFG)
    ref = {f: np.asarray(x) for f, x in zip(ref._fields, ref)}
    got = {f: x.numpy() for f, x in zip(got._fields, got)}
    return p1, p2, ref, got, on


def test_no_broadphase_verdicts_match_jax(no_broadphase):
    _, _, ref, got, _ = no_broadphase
    np.testing.assert_array_equal(got["hit"], ref["hit"])
    np.testing.assert_array_equal(got["status"], ref["status"])
    assert not (got["status"] == Status.MISS_BROADPHASE).any()
    hit = got["hit"]
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(got["gjk_iters"][hit], ref["gjk_iters"][hit])
    agree = got["gjk_iters"] == ref["gjk_iters"]
    assert agree.mean() >= 0.95, np.nonzero(~agree)
    np.testing.assert_array_equal(got["epa_iters"][hit], ref["epa_iters"][hit])


def test_no_broadphase_depth_and_distance_match_jax(no_broadphase):
    p1, p2, ref, got, _ = no_broadphase
    agree = got["gjk_iters"] == ref["gjk_iters"]
    for name in ("depth", "distance"):
        np.testing.assert_allclose(got[name][agree], ref[name][agree],
                                   rtol=0, atol=1e-6, err_msg=name)
    sep = np.array([_separation(a.astype(np.float64), b.astype(np.float64))
                    for a, b in zip(p1, p2)])
    over = got["distance"] - sep
    assert over.max() <= 1e-6, (np.argmax(over), over.max())
    assert (got["distance"][~got["hit"]] > 0).any()


def test_the_broadphase_mode_changes_results(no_broadphase):
    """Lanes the spheres reject (MISS_BROADPHASE, distance 0) get GJK's
    verdict and a separation bound without them; every other lane is the
    same."""
    _, _, _, got, on = no_broadphase
    rejected = (on.status == Status.MISS_BROADPHASE).numpy()
    assert rejected.any()
    assert (got["status"][rejected] == Status.MISS_GJK).all()
    assert (got["distance"][rejected] > 0).all()
    for name in ("hit", "status", "depth", "gjk_iters", "epa_iters",
                 "distance"):
        np.testing.assert_array_equal(got[name][~rejected],
                                      getattr(on, name).numpy()[~rejected],
                                      err_msg=name)


# -- chunked distance --------------------------------------------------------

def _hull_pairs(dtype):
    rng = np.random.default_rng(0)
    return tuple(np.stack([random_hull(rng, 12, center=rng.normal(size=3)
                                       * 2.0)
                           for _ in range(32)]).astype(dtype)
                 for _ in range(2))


def _shape_pairs(dtype):
    return [tuple(x.astype(dtype) if x.dtype == np.float32 else x
                  for x in p) for p in fixtures.mixed16_pairs(4, 3)]


def _configs(dtype):
    return ((JaxConfig(), GJKEPAConfig()) if dtype == "float64"
            else (JAX_CFG, CFG))


def _bit_equal(x, y):
    return all(torch.equal(a, b) for a, b in zip(x, y))


@pytest.mark.parametrize("chunk", [1, 7, 32])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chunked_distance_batch_equals_unchunked(dtype, chunk):
    p1, p2 = (torch.from_numpy(p) for p in _hull_pairs(dtype))
    cfg = _configs(dtype)[1]
    want = gjk_distance_batch(p1, p2, cfg=cfg)
    assert _bit_equal(gjk_distance_batch(p1, p2, cfg=cfg, chunk_size=chunk),
                      want)
    assert (~want.intersecting).sum() >= 16


@pytest.mark.parametrize("chunk", [1, 7, 64])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chunked_distance_shapes_batch_equals_unchunked(dtype, chunk):
    a, b = (ShapeBatch.from_numpy(*p, device="cpu",
                                  dtype=getattr(torch, dtype))
            for p in _shape_pairs(dtype))
    assert len(a) == 64
    cfg = _configs(dtype)[1]
    want = gjk_distance_shapes_batch(a, b, cfg=cfg)
    assert _bit_equal(gjk_distance_shapes_batch(a, b, cfg=cfg,
                                                chunk_size=chunk), want)


def test_chunked_distance_of_an_empty_batch():
    """B = 0 gives every field at batch size 0 with the unchunked dtypes,
    chunked or not; a chunk size below 1 raises."""
    p1, p2 = (torch.from_numpy(p[:0]) for p in _hull_pairs("float64"))
    a, b = (ShapeBatch(*(t[:0] for t in ShapeBatch.from_numpy(
        *p, device="cpu", dtype=torch.float64)))
        for p in _shape_pairs("float64"))
    for r in (gjk_distance_batch(p1, p2, chunk_size=4),
              gjk_distance_batch(p1, p2),
              gjk_distance_shapes_batch(a, b, chunk_size=3)):
        assert [tuple(t.shape) for t in r] == [(0,), (0, 3), (0, 3), (0,),
                                               (0,)]
        assert [t.dtype for t in r] == [torch.float64] * 3 + [torch.bool,
                                                              torch.int32]
    with pytest.raises(ValueError, match="chunk_size"):
        gjk_distance_batch(p1, p2, chunk_size=0)


def _assert_distance_close(got, ref, tol):
    np.testing.assert_array_equal(got.intersecting.numpy(),
                                  np.asarray(ref.intersecting))
    for f in ("distance", "point_a", "point_b"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=tol, err_msg=f)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chunked_distance_batch_matches_jax_chunked(dtype):
    p1, p2 = _hull_pairs(dtype)
    jax_cfg, cfg = _configs(dtype)
    ref = jax_distance(jnp.asarray(p1), jnp.asarray(p2), cfg=jax_cfg,
                       chunk_size=7)
    got = gjk_distance_batch(torch.from_numpy(p1), torch.from_numpy(p2),
                             cfg=cfg, chunk_size=7)
    _assert_distance_close(got, ref, 1e-9 if dtype == "float64" else 1e-5)


def test_chunked_distance_shapes_batch_matches_jax_chunked():
    pairs = _shape_pairs("float64")
    ref = jax_distance_shapes(*(JaxShapes(*(jnp.asarray(x) for x in p))
                                for p in pairs), cfg=JaxConfig(),
                              chunk_size=16)
    got = gjk_distance_shapes_batch(
        *(ShapeBatch.from_numpy(*p, device="cpu", dtype=torch.float64)
          for p in pairs), cfg=GJKEPAConfig(), chunk_size=16)
    np.testing.assert_array_equal(got.intersecting.numpy(),
                                  np.asarray(ref.intersecting))
    err = np.abs(got.distance.numpy() - np.asarray(ref.distance))
    assert err.max() <= 1e-8, err.max()


# -- the surface -------------------------------------------------------------

# What the port does not take, and why.  A key is a parameter name (left
# out of every function), "module.function(parameter)" or
# "module.function" (relative to the package).
EXCEPTIONS = {
    "block": "the TPU lane-block width; each CUDA kernel sizes its own grid",
    "interpret": "Pallas interpret mode; CPU tensors take the kernels' "
                 "plain PyTorch versions",
    "ops.fused.fused_gjkepa_hulls(sort_hits)": "orders lanes only, the "
                 "result is the same either way (fused.py:1350); the port "
                 "always moves the hits first",
    "ops.fused.pzero": "a Pallas lowering helper, (1, block) zeros; the "
                 "port's lane helpers take their shape from a tensor "
                 "(lane_geom.pzero_like)",
    "models.shapes.make_shape_pair_support": "takes two ShapeBatches, the "
                 "port's batch idiom, for JAX's eight per-field arrays",
}

_JAX_MODULES = ["gjkepa_tpu"] + sorted(
    m.name for m in pkgutil.walk_packages(gjkepa_tpu.__path__,
                                          "gjkepa_tpu."))


def _public_functions(module):
    """The public functions a module defines (jit-wrapped ones unwrapped),
    by name."""
    out = {}
    for name, obj in vars(module).items():
        if name.startswith("_") or inspect.isclass(obj) or not callable(obj):
            continue
        fn = inspect.unwrap(obj)
        if inspect.isfunction(fn) and fn.__module__ == module.__name__:
            out[name] = fn
    return out


def _surface_gaps(jax_name):
    """(functions compared, gaps) of one JAX module against the port."""
    rel = jax_name[len("gjkepa_tpu."):] if "." in jax_name else ""
    jm = importlib.import_module(jax_name)
    tm = importlib.import_module("gjkepa_tpu_torch" + ("." + rel if rel
                                                       else ""))
    gaps = []
    funcs = _public_functions(jm)
    for name, fn in funcs.items():
        key = f"{rel}.{name}" if rel else name
        if key in EXCEPTIONS:
            continue
        port = getattr(tm, name, None)
        if not callable(port):
            gaps.append(f"{key}: missing")
            continue
        theirs = inspect.signature(inspect.unwrap(port)).parameters
        kinds = {p.kind for p in theirs.values()}
        for p in inspect.signature(fn).parameters.values():
            if (p.name in EXCEPTIONS or f"{key}({p.name})" in EXCEPTIONS
                    or p.name in theirs
                    or p.VAR_KEYWORD in kinds
                    or (p.kind == p.VAR_POSITIONAL
                        and p.VAR_POSITIONAL in kinds)):
                continue
            gaps.append(f"{key}: no parameter {p.name!r}")
    return len(funcs), gaps


@pytest.mark.parametrize("jax_name", _JAX_MODULES)
def test_port_takes_every_call_of_the_module(jax_name):
    """The port's module of the same relative path has every public function
    of the JAX module, each taking every parameter JAX's takes."""
    _, gaps = _surface_gaps(jax_name)
    assert not gaps, gaps


def test_surface_count_and_exceptions():
    """Every exception names something the JAX package has, and the walk
    compares every public function of the package (89 in 26 modules)."""
    compared = sum(_surface_gaps(m)[0] for m in _JAX_MODULES)
    assert len(_JAX_MODULES) == 26
    assert compared == 89, compared
    jfused = importlib.import_module("gjkepa_tpu.ops.fused")
    jshapes = importlib.import_module("gjkepa_tpu.models.shapes")
    assert "sort_hits" in inspect.signature(
        jfused.fused_gjkepa_hulls).parameters
    assert callable(jfused.pzero) and callable(
        jshapes.make_shape_pair_support)
    assert {"block", "interpret"} <= set(inspect.signature(
        jfused.fused_gjkepa_shapes).parameters)
