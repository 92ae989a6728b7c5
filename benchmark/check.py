"""The comparison that decides ``correct``: numbers read from what the
timed path produced, each held to the limit its traffic file states.

A query module (``benchmark/queries/<name>.py``) reads its numbers with the
helpers here from the outputs the window kept; this module samples lanes,
reduces the per-lane gaps and judges.  Every number is a gap, so lower is
better and a reading passes when it is at most its limit; a number that
could not be read (no lane to compare) is NaN and fails.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import reference

# A lane's normal, contact point or nearest-point height is "off" when it
# lies farther than this from the float64 reference's, in any coordinate: a
# thousand times the float32 rounding of coordinates of order 2, a
# twentieth of bfloat16's.
OFF_TOL = 1e-4


def nanmax(x: np.ndarray) -> float:
    return float(np.max(x)) if x.size else math.nan


def share(mask: np.ndarray) -> float:
    return float(np.mean(mask)) if mask.size else math.nan


def sample_lanes(rng: np.random.Generator, candidates, n: int):
    """``n`` (kept call, lane) pairs drawn without replacement from
    ``candidates``, a list of (call, lanes) with lanes a 1-d int array."""
    flat = [(k, int(lane)) for k, lanes in candidates for lane in lanes]
    if len(flat) <= n:
        return flat
    pick = rng.choice(len(flat), size=n, replace=False)
    return [flat[i] for i in sorted(pick)]


def gather(tensors, picks):
    """Rows ``picks`` ((call, lane) pairs) of a per-call list of tensors, as
    one float64 numpy array (bool arrays stay bool)."""
    rows = [tensors[k][lane] for k, lane in picks]
    if not rows:
        return np.zeros((0,))
    t = torch.stack(rows).cpu()
    return t.numpy() if t.dtype == torch.bool else t.double().numpy()


def bf16_rows(rows: dict) -> dict:
    """The oracle's float rows rounded to bfloat16: the control's output."""
    out = dict(rows)
    for key in ("depth", "normal", "contact_point", "nearest_points"):
        out[key] = reference.to_bf16(torch.from_numpy(rows[key])).numpy()
    return out


def verdicts(p1, p2, out, control: bool):
    """For one kept call on hulls ``p1``, ``p2``: the float64 distance
    (:func:`reference.hull_distance`), and the hit verdicts and separation
    bounds to judge, the program's ``out.hit``, ``out.distance`` or, with
    ``control``, the distance's on inputs and outputs rounded to
    bfloat16."""
    ref = reference.hull_distance(p1, p2)
    if not control:
        return ref, out.hit, out.distance
    c = reference.hull_distance(reference.to_bf16(p1), reference.to_bf16(p2))
    return ref, c["intersecting"], reference.to_bf16(c["distance"])


def hit_numbers(calls) -> dict:
    """Over (ref, hit, sep) triples of :func:`verdicts`:

    * ``hit_mismatches``: the lanes whose verdict differs from the
      float64 distance's;
    * ``separation_excess``: on the lanes called a miss, the most by which
      the separation bound (a lower bound of the distance) exceeds the
      float64 distance."""
    mismatches, excess = 0, []
    for ref, hit, sep in calls:
        mismatches += int((hit != ref["intersecting"]).sum())
        excess.append((sep.double() - ref["distance"])[~hit].cpu().numpy())
    return {"hit_mismatches": mismatches,
            "separation_excess": nanmax(np.concatenate(excess))}


def contact_numbers(got: dict, ref: dict) -> dict:
    """Gaps between a query's rows and the oracle's over the sampled lanes
    the oracle judged (``ref["valid"]``):

    * ``depth_err``: the largest depth gap, a miss reading depth 0 on
      either side, so a wrong verdict shows by how deep the pair is;
    * ``normal_off_share``, ``contact_point_off_share``: the share of the
      lanes both call hits whose normal, contact point lies off the
      oracle's (``OFF_TOL``);
    * ``nearest_off_share``: the share of those lanes whose nearest points'
      heights along the oracle's normal lie off the oracle's (a tie
      between support vertices gives the same height)."""
    v = ref["valid"]
    depth_err = nanmax(np.abs(got["depth"][v] - ref["depth"][v]))
    both = v & got["hit"] & ref["hit"]
    n_ref = ref["normal"][both]
    n_off = np.abs(got["normal"][both] - n_ref).max(axis=1) > OFF_TOL
    c_off = np.abs(got["contact_point"][both]
                   - ref["contact_point"][both]).max(axis=1) > OFF_TOL
    h_off = np.abs(np.einsum("lsk,lk->ls", got["nearest_points"][both]
                             - ref["nearest_points"][both], n_ref)
                   ).max(axis=1) > OFF_TOL
    return {"depth_err": depth_err,
            "normal_off_share": share(n_off),
            "contact_point_off_share": share(c_off),
            "nearest_off_share": share(h_off)}


def judge(readings: dict, limits: dict):
    """(correct, check): every limited reading at most its limit; ``check``
    maps each to its value and limit, in the limits' order."""
    check = {name: {"value": readings.get(name, math.nan), "limit": limit}
             for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in check.values())
    return correct, check
