"""The rigid-body sim: the port's ``sim_step`` against the JAX package's
on the CPU, from the same numpy ``SimState``, both through their portable
narrowphase (GJK and EPA over the analytic box supports); the hull
kernels' narrowphase (K1/K2 over box corners, the card's branch) through
its plain versions against the JAX fused hull path in interpret mode and
against the portable step; ``init_boxes``.

Tolerances (float32):

  * ``diag``: the counts and flags exact, ``max_depth`` within 1e-6;
  * a step: pos and quat within 1e-6, vel and angvel within 1e-5 +
    1e-5 |value| (XLA fuses multiply-adds where the port rounds each
    operation, and the solver's sums run in another order);
  * the narrowphase's hit and status exact, depth and normal within 1e-5.

Three steps chain on each package's own state in a scene of 27 box
contacts.  In the packed scene (~100 contacts, up to 0.23 deep) the two
part after the first step: where a contact's manifold degenerates (an
edge against an edge), its point is the witnesses' midpoint along the
normal, and an edge's two corners tie there; rounding picks one while the
two narrowphases still agree on hit, depth and normal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.ops.fused import fused_gjkepa_hulls as jax_fused_hulls
from gjkepa_tpu.sim import rigid as jr
from gjkepa_tpu_torch import GJKEPAConfig
from gjkepa_tpu_torch.ops.broadphase import swept_candidate_pairs
from gjkepa_tpu_torch.ops.fused import fused_gjkepa_hulls
from gjkepa_tpu_torch.sim import SimConfig, SimState, init_boxes, sim_step
from gjkepa_tpu_torch.sim import rigid

torch.set_num_threads(1)

CFG = GJKEPAConfig.for_f32()
SCFG = SimConfig(max_pairs=512)


def scene(spread):
    """64 boxes in a 4 x 4 x 4 grid above the ground at ``spread``: 4.0
    packs them (105 box contacts in the first step, 2 on the ground), 4.4
    leaves 27."""
    return init_boxes(64, height=0.55, spread=spread, device="cpu")


def to_jax(state):
    return jr.SimState(*(jnp.asarray(x.numpy()) for x in state))


def to_torch(state):
    return SimState(*(torch.from_numpy(np.array(x)) for x in state))


def assert_states_close(got, want):
    for f in ("pos", "quat"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=1e-6, err_msg=f)
    for f in ("vel", "angvel"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def assert_diag_equal(got, want):
    assert set(got) == set(want)
    for k in ("n_candidates", "candidate_overflow", "manifold_overflow",
              "n_contacts", "n_ground"):
        assert int(got[k]) == int(want[k]), k
    assert abs(float(got["max_depth"]) - float(want["max_depth"])) <= 1e-6


def test_step_matches_jax():
    """One step of the packed scene from the shared state."""
    state = scene(4.0)
    js, jd = jr.sim_step(to_jax(state), jr.SimConfig(max_pairs=512))
    ts, td = sim_step(state, SCFG)
    assert int(td["n_contacts"]) >= 100 and int(td["n_ground"]) >= 1
    assert_diag_equal(td, jd)
    assert_states_close(ts, to_torch(js))


def test_three_steps_match_jax():
    """Three steps, each package on its own state."""
    ts = scene(4.4)
    js = to_jax(ts)
    jcfg = jr.SimConfig(max_pairs=512)
    for _ in range(3):
        js, jd = jr.sim_step(js, jcfg)
        ts, td = sim_step(ts, SCFG)
        assert int(td["n_contacts"]) >= 20
        assert_diag_equal(td, jd)
        assert_states_close(ts, to_torch(js))


def test_hull_kernel_branch_matches_the_portable_step():
    """The card's branch (K1/K2 over box corners, here their plain
    versions) against the CPU's (portable GJK/EPA over box supports): the
    same step within the tolerance above."""
    state = scene(4.0)
    fused, fd = rigid._step(state, SCFG, CFG, rigid._pair_contacts_fused)
    portable, pd = sim_step(state, SCFG)
    assert int(pd["n_contacts"]) >= 100
    assert_diag_equal(fd, pd)
    assert_states_close(fused, portable)


def test_fused_narrowphase_matches_jax_interpret():
    """The first 128 candidate pairs of the packed scene as displaced
    corners: the port's K1/K2 plain versions against the JAX fused hull
    path in interpret mode."""
    state = scene(4.0)
    rot = rigid.quat_to_mat(state.quat)
    pairs, valid, _, _ = swept_candidate_pairs(
        state.pos, torch.linalg.norm(state.half, dim=1), SCFG.max_pairs)
    pairs, valid = pairs[:128], valid[:128]
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    c1 = rigid._corners(state, rot, i)
    c2 = rigid._corners(state, rot, j) + torch.where(
        valid, 0.0, 4e4)[:, None, None]
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    ref = jax_fused_hulls(jnp.asarray(c1.numpy()), jnp.asarray(c2.numpy()),
                          cfg=jcfg, block=128, interpret=True)
    got = fused_gjkepa_hulls(c1, c2, cfg=CFG)
    hit, depth, normal, _ = rigid._pair_contacts_fused(state, rot, pairs,
                                                       valid, CFG)
    np.testing.assert_array_equal(got.status, np.asarray(ref.status))
    np.testing.assert_array_equal(hit, np.asarray(ref.hit) & valid.numpy())
    assert 10 <= int(hit.sum()) and not bool(got.hit[~valid].any())
    np.testing.assert_allclose(depth, np.asarray(ref.depth), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(normal, np.asarray(ref.normal), rtol=0,
                               atol=1e-5)


def test_init_boxes_seeded_on_the_named_device():
    a, b = init_boxes(27, seed=3, device="cpu"), init_boxes(27, seed=3,
                                                            device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = init_boxes(27, seed=4, device="cpu")
    assert not torch.equal(a.pos, c.pos)
    for t in a:
        assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert init_boxes(8, dtype=torch.float64, device="cpu").pos.dtype == \
        torch.float64
    # a 3 x 3 x 3 grid (spacing 12 / 3 from height 10): 27 boxes fill it
    layers = torch.round((a.pos[:, 2] - 10.0) / 4.0)
    assert sorted(torch.unique(layers).tolist()) == [0.0, 1.0, 2.0]
    assert ((a.half >= 0.4) & (a.half <= 0.6)).all()
    assert (a.quat[:, 0] == 1).all() and (a.angvel == 0).all()
    with pytest.raises(ValueError, match="no sim narrowphase"):
        sim_step(SimState(*(t.to("meta") for t in a)), SCFG)
