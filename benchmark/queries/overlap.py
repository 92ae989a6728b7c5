"""The boolean query over hull pairs: ``fused_gjkepa_hulls`` with
``epa_max_iters=0``, so only K1 runs (the bounding-sphere broadphase, then
GJK).  Judged on every lane of the kept calls: its hit verdict against the
plain float64 distance, and its separation bound on the misses.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import check, roofline


def make_call(port, cfg, args: dict):
    cfg = cfg.replace(epa_max_iters=0)

    def call(p1, p2):
        return port.fused_gjkepa_hulls(p1, p2, cfg=cfg)
    return call


def work(out):
    """What the roofline needs of one call's outputs."""
    return out.status, out.gjk_iters


def least_s(works, vertices: int) -> dict:
    """Summed least seconds of K1 over the calls ``works``."""
    status, gjk_iters = (torch.stack(t) for t in zip(*works))
    lanes = status.shape[1]
    sums = torch.stack([(status != 0).sum(1), gjk_iters.long().sum(1)],
                       1).tolist()
    return {"gjk_hulls": sum(roofline.k1(lanes, vertices, a, g)[0]
                             for a, g in sums)}


def readings(kept, pool, args: dict, rng: np.random.Generator,
             control: bool = False) -> dict:
    """``hit_mismatches`` and ``separation_excess`` over every lane of the
    kept calls (:func:`benchmark.check.hit_numbers`).  ``control`` puts the
    float64 distance on inputs and outputs rounded to bfloat16 in the
    program's place."""
    return check.hit_numbers(check.verdicts(*pool[slot], out, control)
                             for _, slot, out in kept)
