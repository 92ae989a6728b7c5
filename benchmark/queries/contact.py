"""The full contract over hull pairs: ``gjkepa_batch_fused``.

K1 over every pair, K2 over the hits, then the contact rows.  Judged on
every lane of the kept calls for the hit verdict and the misses' separation
bound (against the plain float64 distance) and, on lanes drawn from the
seed among those the distance finds intersecting, for depth, normal,
contact point and nearest points (against the float64 oracle).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import check, reference, roofline

FIELDS = ("hit", "depth", "normal", "contact_point", "nearest_points")


def make_call(port, cfg, args: dict):
    def call(p1, p2):
        return port.gjkepa_batch_fused(p1, p2, cfg=cfg)
    return call


def work(out):
    """What the roofline needs of one call's outputs."""
    return out.status, out.gjk_iters, out.epa_iters, out.hit


def least_s(works, vertices: int) -> dict:
    """Summed least seconds of K1 and K2 over the calls ``works``."""
    status, gjk_iters, epa_iters, hit = (torch.stack(t) for t in zip(*works))
    lanes = status.shape[1]
    sums = torch.stack([(status != 0).sum(1), gjk_iters.long().sum(1),
                        epa_iters.long().sum(1), hit.sum(1)], 1).tolist()
    return {"gjk_hulls": sum(roofline.k1(lanes, vertices, a, g)[0]
                             for a, g, _, _ in sums),
            "epa_hulls": sum(roofline.k2(h, vertices, e)[0]
                             for _, _, e, h in sums)}


def readings(kept, pool, args: dict, rng: np.random.Generator,
             control: bool = False) -> dict:
    """The numbers of this query over the kept calls ``kept`` ((call index,
    pool slot, outputs) triples).  ``control`` puts the references in the
    program's place, on inputs and outputs rounded to bfloat16."""
    calls = [check.verdicts(*pool[slot], out, control)
             for _, slot, out in kept]
    candidates = [(k, torch.nonzero(ref["intersecting"]).flatten().cpu()
                   .numpy()) for k, (ref, _, _) in enumerate(calls)]
    picks = check.sample_lanes(rng, candidates, args["oracle_lanes"])
    a = check.gather([pool[slot][0] for _, slot, _ in kept], picks)
    b = check.gather([pool[slot][1] for _, slot, _ in kept], picks)
    ref = reference.oracle_rows(a, b, version=args["version"])
    if control:
        got = check.bf16_rows(reference.oracle_rows(
            *(reference.to_bf16(torch.from_numpy(x)).numpy() for x in (a, b)),
            version=args["version"]))
    else:
        got = {f: check.gather([getattr(o, f) for _, _, o in kept], picks)
               for f in FIELDS}
    return {**check.hit_numbers(calls), "oracle_lanes": len(picks),
            **check.contact_numbers(got, ref)}
