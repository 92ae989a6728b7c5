"""The sanitizer: the port's ``debug`` checkers against the JAX package's
on the same numpy inputs.

Clean inputs: each checker returns its unchecked query's result unchanged
(every field bit for bit).  Poisoned inputs (NaN and Inf vertices and
shape parameters, a NaN or non-unit normal and a far contact point fed to
the manifolds, ``tests/test_debug.py``'s slab violation, a float32 NaN
whose coordinate-range check comes first): the port and JAX raise the same
check name (JAX's numeric prefix stripped) and the same lanes.

The manifold checkers of both packages get the same query rows (the
port's), so that only the checkers are compared.  JAX's fused shape
checker takes about a minute in interpret mode, so its comparison is
marked slow; the fast case holds the port to the check and lanes JAX
names (``tests/test_debug.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu import debug as jdebug
from gjkepa_tpu import models as jmodels
from gjkepa_tpu_torch import (GJKEPAConfig, ShapeBatch, boxes,
                              collide_shapes_batch, fused_gjkepa_hulls,
                              fused_gjkepa_shapes, gjkepa_batch,
                              manifold_batch, manifold_shapes_batch, spheres)
from gjkepa_tpu_torch.debug import (DebugCheckError, checked_fused_gjkepa_hulls,
                                    checked_fused_gjkepa_shapes,
                                    checked_gjkepa_batch,
                                    checked_manifold_batch,
                                    checked_manifold_shapes_batch)
from gjkepa_tpu_torch.models import fixtures
from tests.conftest import cube, random_hull

torch.set_num_threads(1)

F32 = GJKEPAConfig.for_f32()
JF32 = JaxConfig.for_f32()
MESSAGE = re.compile(r"sanitizer check failed: (?:\d\d: )?(.+) "
                     r"\(lanes (\[[0-9, ]*\]…?)\)")


def _outcome(fn):
    """(check name without JAX's prefix, lanes) of the error ``fn``
    raises, or None when it returns."""
    try:
        fn()
    except (DebugCheckError, jdebug.DebugCheckError) as e:
        m = MESSAGE.fullmatch(str(e))
        assert m, str(e)
        return m.group(1), m.group(2)
    return None


def _same_outcome(port, jax_fn):
    want = _outcome(jax_fn)
    assert want is not None, "the JAX checker did not raise"
    assert _outcome(port) == want
    return want


def _equal(got, want):
    for name, x, y in zip(got._fields, got, want):
        assert torch.equal(x, y), name


def _hull_batch(seed=0, b=8, n=10):
    """tests/test_debug.py's ``_batch``."""
    rng = np.random.default_rng(seed)
    return tuple(np.stack([random_hull(rng, n, center=rng.normal(size=3)
                                       * 0.5) for _ in range(b)])
                 for _ in range(2))


def _poison(a, *where):
    """A copy of ``a`` with the given (index, value) entries set."""
    a = np.array(a)
    for idx, value in where:
        a[idx] = value
    return a


NAN, INF = np.nan, np.inf

# -- the portable query ------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_checked_gjkepa_batch_clean_equals_unchecked(dtype):
    p1, p2 = (torch.from_numpy(x.astype(dtype)) for x in _hull_batch())
    cfg = GJKEPAConfig() if dtype == np.float64 else F32
    r = checked_gjkepa_batch(p1, p2, cfg=cfg)
    _equal(r, gjkepa_batch(p1, p2, cfg=cfg))
    if dtype == np.float64:                  # the default is the f64 ladder
        _equal(checked_gjkepa_batch(p1, p2), r)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["nan_p1", "inf_p2", "nan_and_inf"])
def test_checked_gjkepa_batch_poisoned_matches_jax(case, dtype):
    """In float32 a NaN or Inf vertex fails the coordinate-range check
    first (JAX's checks come back in sorted key order)."""
    p1, p2 = _hull_batch()
    where1, where2 = {"nan_p1": ((((3, 2, 1), NAN),), ()),
                      "inf_p2": ((), (((1, 0, 0), INF), ((6, 4, 2), -INF))),
                      "nan_and_inf": ((((0, 9, 2), NAN),),
                                      (((5, 3, 1), INF),))}[case]
    p1 = _poison(p1, *where1).astype(dtype)
    p2 = _poison(p2, *where2).astype(dtype)
    cfg, jcfg = (GJKEPAConfig(), JaxConfig()) if dtype == np.float64 \
        else (F32, JF32)
    name, _ = _same_outcome(
        lambda: checked_gjkepa_batch(torch.from_numpy(p1),
                                     torch.from_numpy(p2), cfg=cfg),
        lambda: jdebug.checked_gjkepa_batch(jnp.asarray(p1), jnp.asarray(p2),
                                            cfg=jcfg))
    if dtype == np.float32:
        assert name.startswith("f32 coordinates exceed")


def test_checked_gjkepa_batch_f32_out_of_range():
    """Coordinates past the float32 ladder's range (200 at scale 1)."""
    p1, p2 = (x.astype(np.float32) for x in _hull_batch())
    p2 = p2 + np.float32(300.0) * (np.arange(8) % 3 == 1)[:, None, None]
    _same_outcome(
        lambda: checked_gjkepa_batch(torch.from_numpy(p1),
                                     torch.from_numpy(p2), cfg=F32),
        lambda: jdebug.checked_gjkepa_batch(jnp.asarray(p1), jnp.asarray(p2),
                                            cfg=JF32))


# -- the fused queries -------------------------------------------------------

def test_checked_fused_hulls_clean_equals_unchecked():
    p1, p2 = (torch.from_numpy(x.astype(np.float32)) for x in _hull_batch())
    _equal(checked_fused_gjkepa_hulls(p1, p2),
           fused_gjkepa_hulls(p1, p2, cfg=F32))


def test_checked_fused_hulls_poisoned_matches_jax():
    """NaN and Inf vertices on three lanes; one interpret-mode compile of
    JAX's checker, reused by both poisoned calls."""
    p1, p2 = (x.astype(np.float32) for x in _hull_batch())
    cases = [(_poison(p1, ((5, 3, 0), NAN)), p2),
             (_poison(p1, ((1, 0, 2), INF)), _poison(p2, ((6, 9, 1), -INF)))]
    for a, b in cases:
        _same_outcome(
            lambda: checked_fused_gjkepa_hulls(torch.from_numpy(a),
                                               torch.from_numpy(b)),
            lambda: jdebug.checked_fused_gjkepa_hulls(
                jnp.asarray(a), jnp.asarray(b), cfg=JF32, block=8,
                interpret=True))


def test_checked_fused_hulls_lists_16_lanes():
    p1, p2 = (torch.from_numpy(x.astype(np.float32))
              for x in _hull_batch(b=20))
    p1[:, 2, 0] = float("nan")
    with pytest.raises(DebugCheckError) as e:
        checked_fused_gjkepa_hulls(p1, p2)
    assert str(e.value) == (
        "sanitizer check failed: non-finite input vertex (NaN/Inf in p1 or "
        f"p2) (lanes {list(range(16))}…)")


def _sphere_pairs(seed=0, n=8):
    """tests/test_debug.py's sphere pairs, as numpy (radii, pos)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    radii = (0.4 + 0.4 * rng.random(n)).astype(np.float32)
    return radii, pos


def test_checked_fused_shapes_clean_equals_unchecked():
    radii, pos = _sphere_pairs()
    a = spheres(radii, pos=pos, device="cpu")
    b = spheres(radii, pos=-pos, device="cpu")
    _equal(checked_fused_gjkepa_shapes(a, b),
           fused_gjkepa_shapes(a, b, cfg=F32))
    # the four kinds: bench.py's c3 draws, closed forms and GJK lanes
    a3, b3 = (ShapeBatch.from_numpy(*s, device="cpu")
              for s in fixtures.c3_pairs(0, 512))
    _equal(checked_fused_gjkepa_shapes(a3, b3, cfg=F32),
           fused_gjkepa_shapes(a3, b3, cfg=F32))


def _bad_sphere_params():
    radii, pos = _sphere_pairs()
    a = spheres(radii, pos=pos, device="cpu")
    params = a.params.clone()
    params[2, 0] = float("inf")
    return (ShapeBatch(a.kind, params, a.pos, a.rot),
            spheres(radii, pos=-pos, device="cpu"))


def test_checked_fused_shapes_poisoned():
    """The check and lanes JAX names (tests/test_debug.py, verified against
    JAX by the slow case below)."""
    a, b = _bad_sphere_params()
    assert _outcome(lambda: checked_fused_gjkepa_shapes(a, b)) == (
        "non-finite shape parameter (NaN/Inf in params/pos/rot)", "[2]")
    rot = a.rot.clone()
    rot[4, 1, 1] = float("nan")
    assert _outcome(lambda: checked_fused_gjkepa_shapes(
        ShapeBatch(a.kind, a.params, a.pos, rot),
        ShapeBatch(b.kind, b.params, b.pos + float("inf"), b.rot))) == (
        "non-finite shape parameter (NaN/Inf in params/pos/rot)",
        str(list(range(8))))


@pytest.mark.slow
def test_checked_fused_shapes_poisoned_matches_jax():
    a, b = _bad_sphere_params()
    ja, jb = (jmodels.ShapeBatch(*(jnp.asarray(t.numpy()) for t in s))
              for s in (a, b))
    _same_outcome(lambda: checked_fused_gjkepa_shapes(a, b),
                  lambda: jdebug.checked_fused_gjkepa_shapes(
                      ja, jb, cfg=JF32, block=8, interpret=True))


# -- the manifolds -----------------------------------------------------------

def _cube_query():
    """tests/test_debug.py's overlapping cubes through the port's portable
    query (float64)."""
    p1 = np.stack([cube(), cube([0.2, 0, 0])])
    p2 = np.stack([cube([0.3, 0, 0]), cube([0.4, 0.1, 0])])
    r = gjkepa_batch(torch.from_numpy(p1), torch.from_numpy(p2))
    return p1, p2, {f: getattr(r, f).numpy()
                    for f in ("normal", "depth", "hit", "contact_point")}


def _manifold_both(p1, p2, q, cfg, jcfg, **kw):
    """(port checker call, JAX checker call) on the same arrays."""
    args = (p1, p2, q["normal"], q["depth"], q["hit"], q["contact_point"])
    return (lambda: checked_manifold_batch(
                *(torch.from_numpy(np.asarray(x)) for x in args), cfg=cfg,
                **kw),
            lambda: jdebug.checked_manifold_batch(
                *(jnp.asarray(x) for x in args), cfg=jcfg))


def test_checked_manifold_clean_equals_unchecked():
    p1, p2, q = _cube_query()
    t = [torch.from_numpy(x) for x in (p1, p2, q["normal"], q["depth"],
                                       q["hit"], q["contact_point"])]
    m = checked_manifold_batch(*t, cfg=GJKEPAConfig())
    assert bool(m.mask.any())
    _equal(m, manifold_batch(*t, cfg=GJKEPAConfig()))
    # masks: the slab is taken over the valid vertices only
    m1 = torch.ones(t[0].shape[:2], dtype=torch.bool)
    m1[:, -1] = False
    far = t[0].clone()
    far[:, -1] = 50.0
    _equal(checked_manifold_batch(far, *t[1:], mask1=m1, cfg=GJKEPAConfig()),
           manifold_batch(far, *t[1:], mask1=m1, cfg=GJKEPAConfig()))


@pytest.mark.parametrize("poison", ["nan_normal", "long_normal",
                                    "far_contact_point"])
def test_checked_manifold_poisoned_matches_jax(poison):
    p1, p2, q = _cube_query()
    if poison == "nan_normal":
        q["normal"] = _poison(q["normal"], ((0, 0), NAN))
    elif poison == "long_normal":
        q["normal"] = q["normal"] * 3.0
    else:
        q["contact_point"] = q["contact_point"] + 100.0
        q["normal"] = np.array([[0.6, 0.8, 0.0], [0.0, 0.6, 0.8]])
    _same_outcome(*_manifold_both(p1, p2, q, GJKEPAConfig(), JaxConfig()))


def test_checked_manifold_slab_violation_matches_jax():
    """tests/test_debug.py's vertex-vertex contact: the degenerate
    fallback's single point is the caller's contact point, and one far
    outside the support slab trips the contact-plane check."""
    tet_a = np.array([[0.5, 0, 0], [-0.5, 0.4, 0], [-0.5, -0.4, 0.4],
                      [-0.5, -0.4, -0.4]])
    tet_b = -tet_a + np.array([0.9, 0.0, 0.0])
    q = {"normal": np.array([[1.0, 0.0, 0.0]]), "depth": np.array([0.1]),
         "hit": np.array([True]),
         "contact_point": np.array([[0.45, 0.0, 0.0]])}
    port, jax_fn = _manifold_both(tet_a[None], tet_b[None], q,
                                  GJKEPAConfig(), JaxConfig())
    assert _outcome(port) is None and _outcome(jax_fn) is None
    q["contact_point"] = np.array([[100.0, 0.0, 0.0]])
    name, lanes = _same_outcome(*_manifold_both(
        tet_a[None], tet_b[None], q, GJKEPAConfig(), JaxConfig()))
    assert (name, lanes) == ("manifold point off the contact plane slab",
                             "[0]")


def _box_query():
    """tests/test_debug.py's box pairs through the port's portable shape
    query (float32): numpy half extents and positions, and the rows."""
    h = np.full((4, 3), 0.5, np.float32)
    pos_b = np.array([[0.3, 0, 0], [0, 0.4, 0], [0, 0, 0.5], [3.0, 0, 0]],
                     np.float32)
    a = boxes(h, pos=np.zeros((4, 3), np.float32), device="cpu")
    b = boxes(h, pos=pos_b, device="cpu")
    r = collide_shapes_batch(a, b, cfg=F32)
    return h, pos_b, a, b, {f: getattr(r, f).numpy()
                            for f in ("normal", "depth", "hit",
                                      "contact_point")}


def test_checked_manifold_shapes_clean_equals_unchecked():
    *_, a, b, q = _box_query()
    t = [torch.from_numpy(q[f]) for f in ("normal", "depth", "hit",
                                          "contact_point")]
    m = checked_manifold_shapes_batch(a, b, *t)
    assert bool(m.mask.any())
    _equal(m, manifold_shapes_batch(a, b, *t, cfg=F32))


@pytest.mark.parametrize("poison", ["nan_normal", "long_normal",
                                    "far_contact_point"])
def test_checked_manifold_shapes_poisoned_matches_jax(poison):
    h, pos_b, a, b, q = _box_query()
    if poison == "nan_normal":
        q["normal"] = _poison(q["normal"], ((1, 1), NAN))
    elif poison == "long_normal":
        q["normal"] = q["normal"] * np.float32(3.0)
    else:
        q["contact_point"] = q["contact_point"] + np.float32(100.0)
        q["normal"] = np.tile(np.float32([[0.0, 0.6, 0.8]]), (4, 1))
    ja = jmodels.boxes(jnp.asarray(h), pos=jnp.zeros((4, 3), jnp.float32))
    jb = jmodels.boxes(jnp.asarray(h), pos=jnp.asarray(pos_b))
    rows = [q[f] for f in ("normal", "depth", "hit", "contact_point")]
    _same_outcome(
        lambda: checked_manifold_shapes_batch(
            a, b, *(torch.from_numpy(x) for x in rows)),
        lambda: jdebug.checked_manifold_shapes_batch(
            ja, jb, *(jnp.asarray(x) for x in rows), cfg=JF32))
