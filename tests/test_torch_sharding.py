"""Pair-axis sharding: the port's ``parallel.sharding`` against the JAX
package's on the same numpy inputs.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's mesh is 8 (or 4) entries of the CPU, so the chunking, the
per-shard queries and the summed count run through the plain versions.
Inputs: ``tests/test_sharding.py``'s 64-cube batch (float64, the default
config) and its 64 x 8 float32 hull batch (``for_f32``).

Tolerances against JAX: hit and status exact; float64 depth and contact
point within 1e-9 (``tests/test_torch_gjkepa.py``); float32 fused depth and
distance within 1e-6 (``tests/test_torch_api.py``), the contact point
within 1e-5 on hit lanes (``tests/test_sharding.py``).  Against the port's
own unsharded query every field is equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu import gjkepa_batch as jax_gjkepa_batch
from gjkepa_tpu import parallel as jpar
from gjkepa_tpu_torch import GJKEPAConfig, gjkepa_batch, gjkepa_batch_fused
from gjkepa_tpu_torch.parallel import (Sharded, contact_count_sharded,
                                       gjkepa_batch_fused_sharded,
                                       gjkepa_batch_sharded, pair_mesh,
                                       shard_pairs)
from tests.conftest import cube

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _cubes(b=64, seed=0):
    """tests/test_sharding.py's ``_batch``: unit cubes at N(0, 1.2^2)."""
    rng = np.random.default_rng(seed)
    p1 = np.stack([cube(rng.normal(size=3) * 1.2) for _ in range(b)])
    p2 = np.stack([cube(rng.normal(size=3) * 1.2) for _ in range(b)])
    return p1, p2


def _hulls(b=64, n=8, seed=0):
    """tests/test_sharding.py's fused batch: float32 unit-sphere hulls."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        v = rng.normal(size=(b, n, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        out.append((v + rng.normal(size=(b, 1, 3)) * 0.6).astype(np.float32))
    return tuple(out)


@pytest.fixture(scope="module")
def portable():
    """The 64-cube batch through JAX's sharded query and count, and
    through the port's sharded and unsharded query on an 8-entry mesh."""
    p1, p2 = _cubes()
    jmesh = jpar.pair_mesh()
    j1, j2 = jpar.shard_pairs(jmesh, jnp.asarray(p1), jnp.asarray(p2))
    ref = jpar.gjkepa_batch_sharded(jmesh, j1, j2)
    ref = {f: np.asarray(x) for f, x in zip(ref._fields, ref)}
    ref_count = int(jpar.contact_count_sharded(jmesh, j1, j2))
    t1, t2 = torch.from_numpy(p1), torch.from_numpy(p2)
    mesh = pair_mesh(8, device="cpu")
    s1, s2 = shard_pairs(mesh, t1, t2)
    return dict(p1=t1, p2=t2, mesh=mesh, s1=s1, s2=s2, ref=ref,
                ref_count=ref_count,
                sharded=gjkepa_batch_sharded(mesh, s1, s2),
                unsharded=gjkepa_batch(t1, t2))


def test_cpu_mesh_has_8_entries():
    mesh = pair_mesh(8, device="cpu")
    assert mesh.size == 8
    assert mesh.devices == [CPU] * 8
    assert mesh.axis_names == ("pairs",)
    assert pair_mesh(device="cpu").size == 1
    assert pair_mesh(4, axis="lanes", device="cpu").axis_names == ("lanes",)


@pytest.mark.parametrize("device", [None, "cuda:0"], ids=["cards", "cuda0"])
def test_pair_mesh_without_a_card_raises(monkeypatch, device):
    """No card: the mesh raises, it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pair_mesh(device=device)


def test_shard_pairs_places_equal_chunks():
    mesh = pair_mesh(8, device="cpu")
    x = torch.arange(64.0).reshape(16, 4)
    s = shard_pairs(mesh, x)
    assert isinstance(s, Sharded) and s.mesh == mesh
    assert [c.shape for c in s.shards] == [(2, 4)] * 8
    assert [c.device for c in s.shards] == mesh.devices
    assert torch.equal(s.gather(), x)
    assert len(shard_pairs(mesh, x, x)) == 2


def test_sharded_matches_jax(portable):
    got = portable["sharded"]
    assert len(got.shards) == 8
    assert [s.depth.device for s in got.shards] == portable["mesh"].devices
    assert all(s.hit.shape == (8,) for s in got.shards)
    g, ref = got.gather(), portable["ref"]
    assert g.hit.any() and not g.hit.all()
    for name in ("hit", "status", "colli_type"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), ref[name],
                                      err_msg=name)
    for name in ("depth", "contact_point"):
        np.testing.assert_allclose(getattr(g, name).numpy(), ref[name],
                                   rtol=0, atol=1e-9, err_msg=name)


def test_sharded_equals_unsharded(portable):
    g = portable["sharded"].gather()
    for name, x, y in zip(g._fields, g, portable["unsharded"]):
        assert torch.equal(x, y), name


def test_contact_count_matches_jax(portable):
    cnt = contact_count_sharded(portable["mesh"], portable["s1"],
                                portable["s2"])
    assert cnt.shape == () and cnt.dtype == torch.int32
    assert cnt.device == portable["mesh"].devices[0]
    assert int(cnt) == portable["ref_count"]
    assert int(cnt) == int(portable["unsharded"].hit.sum())


def test_submesh(portable):
    """A 4-entry mesh over the first 32 pairs: equal to the port's
    unsharded rows, hits and depths as JAX's (lanes are independent)."""
    mesh = pair_mesh(4, device="cpu")
    r = gjkepa_batch_sharded(mesh, portable["p1"][:32], portable["p2"][:32])
    assert len(r.shards) == 4
    g = r.gather()
    for name, x, y in zip(g._fields, g, portable["unsharded"]):
        assert torch.equal(x, y[:32]), name
    np.testing.assert_array_equal(g.hit.numpy(), portable["ref"]["hit"][:32])
    np.testing.assert_allclose(g.depth.numpy(), portable["ref"]["depth"][:32],
                               rtol=0, atol=1e-9)


def test_fused_sharded_matches_jax():
    """The fused query on each shard against JAX's under ``shard_map``
    (interpret mode), and bit for bit against the port's unsharded fused
    query."""
    p1, p2 = _hulls()
    jcfg = JaxConfig.for_f32()
    jmesh = jpar.pair_mesh(8)
    j1, j2 = jpar.shard_pairs(jmesh, jnp.asarray(p1), jnp.asarray(p2))
    ref = jpar.gjkepa_batch_fused_sharded(jmesh, j1, j2, cfg=jcfg,
                                          interpret=True)
    assert len(ref.depth.sharding.device_set) == 8
    ref = {f: np.asarray(x) for f, x in zip(ref._fields, ref)}

    cfg = GJKEPAConfig.for_f32()
    mesh = pair_mesh(8, device="cpu")
    t1, t2 = torch.from_numpy(p1), torch.from_numpy(p2)
    r = gjkepa_batch_fused_sharded(mesh, *shard_pairs(mesh, t1, t2), cfg=cfg)
    assert [s.depth.device for s in r.shards] == mesh.devices
    g = r.gather()
    for name, x, y in zip(g._fields, g, gjkepa_batch_fused(t1, t2, cfg=cfg)):
        assert torch.equal(x, y), name
    hit = g.hit.numpy()
    assert hit.sum() > 3
    for name in ("hit", "status"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), ref[name],
                                      err_msg=name)
    for name in ("depth", "distance"):
        np.testing.assert_allclose(getattr(g, name).numpy(), ref[name],
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(g.contact_point.numpy()[hit],
                               ref["contact_point"][hit], rtol=0, atol=1e-5)


def test_fused_default_config_is_for_f32():
    p1, p2 = (torch.from_numpy(x) for x in _hulls(16, 8, seed=1))
    mesh = pair_mesh(2, device="cpu")
    a = gjkepa_batch_fused_sharded(mesh, p1, p2).gather()
    b = gjkepa_batch_fused_sharded(mesh, p1, p2,
                                   cfg=GJKEPAConfig.for_f32()).gather()
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def test_indivisible_batch_raises_in_both_packages():
    p1, _ = _cubes(63)
    with pytest.raises(ValueError):
        jax.device_put(jnp.asarray(p1), jax.sharding.NamedSharding(
            jpar.pair_mesh(), jax.sharding.PartitionSpec("pairs")))
    with pytest.raises(ValueError):
        jpar.shard_pairs(jpar.pair_mesh(), jnp.asarray(p1))
    mesh = pair_mesh(8, device="cpu")
    t1 = torch.from_numpy(p1)
    with pytest.raises(ValueError, match="not divisible"):
        shard_pairs(mesh, t1)
    with pytest.raises(ValueError, match="not divisible"):
        gjkepa_batch_sharded(mesh, t1, t1)
    with pytest.raises(ValueError, match="not divisible"):
        contact_count_sharded(mesh, t1, t1)


def test_mismatched_mesh_or_axis_raises():
    x = torch.zeros((8, 8, 3))
    s = shard_pairs(pair_mesh(4, device="cpu"), x)
    with pytest.raises(ValueError, match="another mesh"):
        gjkepa_batch_sharded(pair_mesh(2, device="cpu"), s, s)
    with pytest.raises(ValueError, match="axis"):
        shard_pairs(pair_mesh(4, device="cpu"), x, axis="lanes")
