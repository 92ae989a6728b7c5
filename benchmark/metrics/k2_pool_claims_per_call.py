"""Slots of K2's device pool claimed a K2 launch: the pool's claim counter
(``ops.fused_epa.pool_claims``, which each team's claim adds to on the
card, the main path's launches too) over K2's launches
(``ops.fused_epa.LAUNCHES_BY_TEAM``), both over the process so far: the
pool is made at the first launch that pools a tier, and at the default
ladder every launch does.  A hit claims a slot when its ladder reaches a
tier past K2's shared memory.  None for a program without the counter,
and without device operations or K2 launches."""

import sys


def read(view):
    epa = sys.modules.get("gjkepa_tpu_torch.ops.fused_epa")
    if not view.device_ops or not hasattr(epa, "pool_claims"):
        return None
    launches = sum(epa.LAUNCHES_BY_TEAM.values())
    if not launches:
        return None
    return epa.pool_claims() / launches
