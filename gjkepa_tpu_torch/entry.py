"""Entry points: the flagship query and the sharded pipeline's dry run.

Port of the root ``__graft_entry__.py``: :func:`entry` gives the flagship
call (the portable hull query over 256 x 16 float32 hull pairs) with its
inputs, and :func:`dryrun_multichip` runs the pipeline with the pair axis
sharded over ``n_devices`` mesh entries and checks it.

Usage, from the root of a checkout (needs a CUDA device):

    python3 -m gjkepa_tpu_torch.entry
"""

from __future__ import annotations

import numpy as np
import torch

from .api import gjk_distance_batch, gjkepa_batch
from .config import GJKEPAConfig
from .ops.manifold import manifold_batch
from .parallel.sharding import (Sharded, contact_count_sharded,
                                gjkepa_batch_fused_sharded,
                                gjkepa_batch_sharded, pair_mesh, shard_pairs)

__all__ = ["entry", "dryrun_multichip"]


def entry(device: torch.device | str = "cuda"):
    """(fn, (p1, p2)): the full narrow-phase query (broadphase, GJK, EPA,
    contact) of the portable path under the float32 ladder, and its inputs:
    256 pairs of 16-vertex hulls from ``default_rng(0)`` on ``device``."""
    cfg = GJKEPAConfig.for_f32()
    rng = np.random.default_rng(0)
    b, n = 256, 16

    def hulls():
        v = rng.normal(size=(b, n, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        centers = rng.normal(size=(b, 1, 3)) * 0.8
        return torch.from_numpy((v + centers).astype(np.float32)).to(device)

    p1, p2 = hulls(), hulls()

    def fn(p1, p2):
        return gjkepa_batch(p1, p2, cfg=cfg)

    return fn, (p1, p2)


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _on_mesh(r: Sharded, what: str) -> None:
    devices = [next(iter(s)).device for s in r.shards]
    _expect(devices == r.mesh.devices,
            f"{what} shards on {devices}, mesh {r.mesh.devices}")


def dryrun_multichip(n_devices: int,
                     device: torch.device | str | None = None) -> None:
    """Shard the pipeline over an ``n_devices`` mesh (:func:`pair_mesh`:
    the cards, or ``n_devices`` entries of ``device``) and run one step:
    the sharded portable query, the contact count (a sum over the shards)
    against the unsharded hit count, the sharded fused query, and on each
    shard the portable distance and the manifolds fed by the sharded
    query.  Raises AssertionError when a check fails."""
    mesh = pair_mesh(n_devices, device=device)
    cfg = GJKEPAConfig.for_f32()
    rng = np.random.default_rng(0)
    b, n = 8 * n_devices, 8            # tiny shapes, divisible by the mesh

    def hulls():
        v = rng.normal(size=(b, n, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        return torch.from_numpy(
            (v + rng.normal(size=(b, 1, 3)) * 0.6).astype(np.float32))

    p1, p2 = shard_pairs(mesh, hulls(), hulls())

    # the full pipeline, sharded over the pair axis
    r = gjkepa_batch_sharded(mesh, p1, p2, cfg=cfg)
    _on_mesh(r, "the portable query's")

    # the cross-device reduction
    cnt = contact_count_sharded(mesh, p1, p2, cfg=cfg)
    ref = int(gjkepa_batch(p1.gather(), p2.gather(), cfg=cfg).hit.sum())
    _expect(int(cnt) == ref, f"contact count {int(cnt)}, unsharded {ref}")

    # the fused path (K1, K2, the contact rows) on each shard
    rf = gjkepa_batch_fused_sharded(mesh, p1, p2, cfg=cfg)
    _on_mesh(rf, "the fused query's")
    hits = int(rf.gather().hit.sum())
    _expect(hits == ref, f"fused hits {hits}, unsharded {ref}")

    # the portable distance on each shard
    d = Sharded([gjk_distance_batch(a, b_, cfg=cfg)
                 for a, b_ in zip(p1.shards, p2.shards)], mesh)
    _on_mesh(d, "the distance's")
    dg = d.gather()
    _expect(bool(torch.isfinite(dg.distance).all()), "non-finite distance")
    # separated pairs carry a non-negative distance certificate
    _expect(bool((dg.intersecting | (dg.distance >= 0)).all()),
            "negative distance on a separated pair")

    # the manifolds on each shard, fed by the sharded query's results
    m = Sharded([manifold_batch(a, b_, q.normal, q.depth, q.hit,
                                q.contact_point, cfg=cfg)
                 for a, b_, q in zip(p1.shards, p2.shards, r.shards)], mesh)
    _on_mesh(m, "the manifolds'")
    mg, rg = m.gather(), r.gather()
    _expect(bool(torch.isfinite(mg.points).all()), "non-finite manifold")
    # manifold points only on hit lanes
    _expect(bool((rg.hit[:, None] | ~mg.mask).all()),
            "a manifold point on a miss lane")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"entry() ran: {int(out.hit.sum())} hits of {args[0].shape[0]}")
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip OK")
