"""The closest-distance query over hull pairs: ``fused_gjk_distance_hulls``,
K8 twice (every pair at a cap of ``phase1_iters``, then the unconverged ones
at ``max_iters``).  Judged on every lane of the kept calls against the plain
float64 distance, under the query's own guarantee: a pair closer than
``touch_distance`` reads intersecting, at distance 0.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import check, reference, roofline


def make_call(port, cfg, args: dict):
    def call(p1, p2):
        return port.fused_gjk_distance_hulls(
            p1, p2, cfg=cfg, max_iters=args["max_iters"],
            phase1_iters=args["phase1_iters"])
    return call


def work(out):
    """What the roofline needs of one call's outputs."""
    return (out.iters,)


def least_s(works, vertices: int) -> dict:
    """Summed least seconds of K8's launches over the calls ``works``."""
    iters = torch.stack([w[0] for w in works])
    lanes = iters.shape[1]
    return {"distance_hulls": sum(roofline.k8(lanes, vertices, i)[0]
                                  for i in iters.long().sum(1).tolist())}


def _control(p1, p2, touch: float):
    """The float64 distance on inputs rounded to bfloat16, under the
    query's guarantee, its outputs rounded to bfloat16."""
    d = reference.hull_distance(reference.to_bf16(p1), reference.to_bf16(p2))
    inter = d["intersecting"] | (d["distance"] < touch)
    return (torch.where(inter, 0.0, reference.to_bf16(d["distance"])), inter,
            reference.to_bf16(d["point_a"]), reference.to_bf16(d["point_b"]))


def readings(kept, pool, args: dict, rng: np.random.Generator,
             control: bool = False) -> dict:
    """Over the kept calls:

    * ``distance_err``: the largest distance gap on pairs at least
      ``distance_floor`` apart;
    * ``witness_err``: on those pairs, the largest of the witness points'
      difference off the reference's (the closest points' difference is
      unique) and their heights off each hull's supporting plane across
      the reference direction;
    * ``touch_violations``: lanes read intersecting though more than
      ``touch_distance`` + ``touch_slack`` apart, or apart though the
      hulls intersect."""
    touch, slack = args["touch_distance"], args["touch_slack"]
    dist_err, wit_err, violations = [], [], 0
    for _, slot, out in kept:
        p1, p2 = pool[slot]
        ref = reference.hull_distance(p1, p2)
        if control:
            d, inter, pa, pb = _control(p1, p2, touch)
        else:
            d, inter, pa, pb = (out.distance, out.intersecting, out.point_a,
                                out.point_b)
        d, pa, pb = d.double(), pa.double(), pb.double()
        rd = ref["distance"]
        violations += int(((inter & (rd > touch + slack))
                           | (~inter & ref["intersecting"])).sum())
        far = rd >= args["distance_floor"]
        # the closest points' difference is unique, and each witness lies
        # on its hull's supporting plane across the reference direction
        u = ref["point_b"] - ref["point_a"]
        n = u / rd.clamp_min(1e-30)[:, None]
        ha = torch.einsum("lvk,lk->lv", p1.double(), n).amax(1)
        lb = torch.einsum("lvk,lk->lv", p2.double(), n).amin(1)
        werr = torch.stack([((pb - pa) - u).abs().amax(1),
                            (ha - (pa * n).sum(1)).abs(),
                            ((pb * n).sum(1) - lb).abs()], 1).amax(1)
        dist_err.append((d - rd).abs()[far].cpu().numpy())
        wit_err.append(werr[far].cpu().numpy())
    return {"distance_err": check.nanmax(np.concatenate(dist_err)),
            "witness_err": check.nanmax(np.concatenate(wit_err)),
            "touch_violations": violations}
