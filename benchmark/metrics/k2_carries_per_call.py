"""Tiers K2's ladder carried a polytope into, a K2 launch: the pool's carry
counter (``ops.fused_epa.tier_carries``, which each team adds its carries
to on the card, the main path's launches too) over K2's launches
(``ops.fused_epa.LAUNCHES_BY_TEAM``), both over the process so far.  Where
a tier stops for capacity by free faces, the next one goes on from its
polytope wherever a restart from the simplex would repeat its iterations
bit for bit.  Every launch is handed the counter, whether or not a tier is
pooled.  A diagnostic: the traffic sets it, and it says how often the
carry engages.  None for a program without the counter, and without device
operations or K2 launches."""

import sys


def read(view):
    epa = sys.modules.get("gjkepa_tpu_torch.ops.fused_epa")
    if not view.device_ops or not hasattr(epa, "tier_carries"):
        return None
    launches = sum(epa.LAUNCHES_BY_TEAM.values())
    if not launches:
        return None
    return epa.tier_carries() / launches
