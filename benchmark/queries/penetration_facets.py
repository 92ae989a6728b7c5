"""The penetration query of :mod:`benchmark.queries.penetration` (the same
call, work and least time: ``fused_gjkepa_hulls`` with EPA on), judged
against :mod:`benchmark.reference_penetration_facets`, the exact float64
depth and normal from the hulls' facets and edges, which scales to hulls
of hundreds of vertices where the brute-force reference cannot.

The lanes are taken as the brute-force query takes them: a seeded
permutation of every lane of the kept calls, from its head until
``reference_lanes`` of them penetrate, each judged for depth (a miss
reading depth 0 on either side) and each penetrating one for its normal.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import check, reference
from benchmark import reference_penetration_facets as rpf
from benchmark.queries.penetration import (CONVERGED, _program, _rows,
                                           least_s, make_call, work)

__all__ = ["make_call", "work", "least_s", "readings"]


def _control(a, b):
    """The facet reference on inputs rounded to bfloat16, its outputs
    rounded to bfloat16, in the program's place; a penetrating lane reads
    converged."""
    c = rpf.penetration(reference.to_bf16(a), reference.to_bf16(b))
    hit = c["penetrating"]
    return (hit, torch.where(hit, CONVERGED, 0),
            reference.to_bf16(c["depth"]), reference.to_bf16(c["normal"]))


def readings(kept, pool, args: dict, rng: np.random.Generator,
             control: bool = False) -> dict:
    """Over the lanes taken from the kept calls ``kept`` ((call index, pool
    slot, outputs) triples), against the facet reference:

    * ``depth_err``: the largest |depth - reference depth| over every lane
      taken;
    * ``normal_excess``: on the penetrating lanes, the largest
      |h(normal) - reference depth|, h the support height of A - B, in
      float64;
    * ``epa_status_off_share``: the share of the penetrating lanes whose
      status is not a converged EPA (not compared);
    * ``reference_lanes``: how many lanes penetrate (not compared).

    ``control`` puts the facet reference on inputs and outputs rounded to
    bfloat16 in the program's place."""
    lanes = kept[0][2].hit.shape[0]
    every = np.stack(np.divmod(rng.permutation(len(kept) * lanes), lanes), 1)
    want = args["reference_lanes"]
    blocks, found = [], 0
    for start in range(0, len(every), want):
        if found >= want:
            break
        picks = every[start:start + want]
        picks = picks[np.lexsort((picks[:, 1], picks[:, 0]))]
        a = _rows([pool[slot][0] for _, slot, _ in kept], picks).double()
        b = _rows([pool[slot][1] for _, slot, _ in kept], picks).double()
        ref = rpf.penetration(a, b)
        got = _control(a, b) if control else _program(kept, picks)
        blocks.append((a, b, ref["penetrating"], ref["depth"], *got))
        found += int(ref["penetrating"].sum())
    # lanes past the one that makes ``want`` penetrating ones are dropped
    rows = [torch.cat(t) for t in zip(*blocks)]
    inside = rows[2]
    keep = torch.cumsum(inside.long(), 0) - inside.long() < want
    a, b, inside, ref_depth, hit, status, depth, normal = (
        t[keep] for t in rows)
    depth = torch.where(hit, depth.double(), 0.0)
    excess = (rpf.minkowski_height(a[inside], b[inside], normal[inside])
              - ref_depth[inside]).abs()
    return {"depth_err": check.nanmax((depth - ref_depth).abs().cpu().numpy()),
            "normal_excess": check.nanmax(excess.cpu().numpy()),
            "epa_status_off_share": check.share(
                (status[inside] != CONVERGED).cpu().numpy()),
            "reference_lanes": int(inside.sum())}
