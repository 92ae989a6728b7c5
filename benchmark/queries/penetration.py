"""The penetration query over hull pairs: ``fused_gjkepa_hulls`` with EPA
on, as the configuration states it.  K1 over every pair, the hit-first
order, K2 over the hits: hit, status, depth, normal and iteration counts.

Judged against the exact float64 depth and normal of
:mod:`benchmark.reference_penetration` on lanes drawn from the seed: a
seeded permutation of every lane of the kept calls, taken from its head
until ``reference_lanes`` of them penetrate.  Every lane taken is judged
for depth, a miss reading depth 0 on either side, so a false hit on a lane
that does not penetrate shows too.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import check, reference, roofline
from benchmark import reference_penetration as rp

CONVERGED = 3       # the program's Status.HIT: a hit whose EPA converged


def make_call(port, cfg, args: dict):
    def call(p1, p2):
        return port.fused_gjkepa_hulls(p1, p2, cfg=cfg)
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


def _rows(tensors, picks: np.ndarray) -> torch.Tensor:
    """Rows ``picks`` ((call, lane) rows, sorted) of a per-call list of
    tensors, in that order, on their device."""
    return torch.cat([tensors[k][torch.from_numpy(
        picks[picks[:, 0] == k, 1]).to(tensors[k].device)]
        for k in np.unique(picks[:, 0])])


def _program(kept, picks):
    """The program's hit, status, depth and normal on the lanes ``picks``."""
    return tuple(_rows([getattr(o, f) for _, _, o in kept], picks)
                 for f in ("hit", "status", "depth", "normal"))


def _control(a, b):
    """The reference on inputs rounded to bfloat16, its outputs rounded to
    bfloat16, in the program's place; a penetrating lane reads converged."""
    c = rp.penetration(reference.to_bf16(a), reference.to_bf16(b))
    hit = c["penetrating"]
    return (hit, torch.where(hit, CONVERGED, 0),
            reference.to_bf16(c["depth"]), reference.to_bf16(c["normal"]))


def readings(kept, pool, args: dict, rng: np.random.Generator,
             control: bool = False) -> dict:
    """Over the lanes taken from the kept calls ``kept`` ((call index, pool
    slot, outputs) triples):

    * ``depth_err``: the largest |depth - reference depth| over every lane
      taken;
    * ``normal_excess``: on the penetrating lanes, the largest
      |h(normal) - reference depth|, h the support height of A - B
      (:func:`~benchmark.reference_penetration.minkowski_height`), in
      float64: 0 for any normal of a nearest facet, so ties between facets
      do not matter, and a normal that is not of unit length shows too;
    * ``epa_status_off_share``: the share of the penetrating lanes whose
      status is not a converged EPA;
    * ``reference_lanes``: how many lanes penetrate (not compared).

    ``control`` puts the reference on inputs and outputs rounded to
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
        ref = rp.penetration(a, b)
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
    excess = (rp.minkowski_height(a[inside], b[inside], normal[inside])
              - ref_depth[inside]).abs()
    return {"depth_err": check.nanmax((depth - ref_depth).abs().cpu().numpy()),
            "normal_excess": check.nanmax(excess.cpu().numpy()),
            "epa_status_off_share": check.share(
                (status[inside] != CONVERGED).cpu().numpy()),
            "reference_lanes": int(inside.sum())}
