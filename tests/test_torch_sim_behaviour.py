"""The port's copies of ``tests/test_sim.py``'s behaviour tests, on the
CPU (the portable narrowphase), at the same sizes and step counts: boxes
fall and settle, energy dissipates, a 2-box and a 3-box stack hold.  Each
stack step is also taken by the JAX package's step from the port's state
and held to the port's at ``tests/test_torch_sim.py``'s tolerance, on >=
90% of the steps: the boxes stand face on face, where the box supports
tie, and rounding decides a tie (236 of 240 and 282 of 300 steps agree
in a CPU run of this test; the rest are the JAX step counting two
separated boxes as a contact of negative depth, where its GJK's first
probes fall on a tie, or a 4-point pick among equal depths)."""

import jax.numpy as jnp
import numpy as np
import torch

from gjkepa_tpu.sim import rigid as jr
from gjkepa_tpu_torch.sim import SimConfig, SimState, init_boxes, sim_step

torch.set_num_threads(1)


@torch.inference_mode()          # no autograd bookkeeping: ~25% faster
def run_steps(state, scfg, n):
    diag = None
    for _ in range(n):
        state, diag = sim_step(state, scfg)
    return state, diag


def test_boxes_fall_and_settle():
    state = init_boxes(64, height=3.0, spread=5.0, device="cpu")
    s2, diag = run_steps(state, SimConfig(max_pairs=512), 150)
    pos = s2.pos.numpy()
    assert np.isfinite(pos).all()
    # everything fell, nothing tunnelled through the floor past a slop
    assert pos[:, 2].max() < 3.5 + 2.0
    assert pos[:, 2].min() > -0.5
    assert int(diag["n_ground"]) > 10
    assert np.abs(s2.vel.numpy()).max() < 50.0


def test_energy_dissipates():
    state = init_boxes(32, height=4.0, spread=4.0, device="cpu")
    scfg = SimConfig(max_pairs=256)
    s_mid, _ = run_steps(state, scfg, 60)
    s_end, _ = run_steps(s_mid, scfg, 240)
    ke_mid = float((s_mid.vel ** 2).sum())
    ke_end = float((s_end.vel ** 2).sum())
    assert ke_end < max(ke_mid, 1.0) * 2.0
    assert torch.isfinite(s_end.quat).all()
    np.testing.assert_allclose(torch.linalg.norm(s_end.quat, dim=1), 1.0,
                               atol=1e-4)


def stack(z):
    """Unit boxes at the heights z, at rest; a box far off (x = 20) rounds
    a 2-box stack up to three bodies, so that both stacks share one
    compiled JAX step."""
    n = 3
    pos = np.zeros((n, 3), np.float32)
    pos[:, 2] = 0.6
    pos[:len(z), 2] = z
    pos[len(z):, 0] = 20.0
    quat = np.zeros((n, 4), np.float32)
    quat[:, 0] = 1.0
    zeros = np.zeros((n, 3), np.float32)
    return SimState(*(torch.from_numpy(x.copy()) for x in (
        pos, quat, zeros, zeros, np.full((n, 3), 0.5, np.float32))))


def close(got, diag, want, wdiag):
    if any(int(diag[k]) != int(wdiag[k])
           for k in ("n_contacts", "n_ground", "n_candidates")):
        return False
    return all(np.allclose(getattr(got, f), np.asarray(getattr(want, f)),
                           rtol=rtol, atol=atol)
               for f, rtol, atol in (("pos", 0, 1e-6), ("quat", 0, 1e-6),
                                     ("vel", 1e-5, 1e-5),
                                     ("angvel", 1e-5, 1e-5)))


@torch.inference_mode()
def run_stack(state, n):
    """n steps of the port, each also through the JAX step from the same
    state; the final positions."""
    scfg, jcfg = SimConfig(max_pairs=16), jr.SimConfig(max_pairs=16)
    agree = 0
    for _ in range(n):
        nxt, diag = sim_step(state, scfg)
        js, jd = jr.sim_step(jr.SimState(*(jnp.asarray(x.numpy())
                                           for x in state)), jcfg)
        agree += close(nxt, diag, js, jd)
        state = nxt
    assert agree >= 0.9 * n, agree
    return state.pos.numpy()


def test_stack_does_not_interpenetrate():
    # two boxes dropped exactly on top of each other
    pos = run_stack(stack([0.6, 2.0]), 240)
    assert abs(pos[0, 2] - 0.5) < 0.15
    assert pos[1, 2] > pos[0, 2] + 0.7


def test_three_box_stack_stays_stable():
    # a 3-box stack stays within tolerance for 300 steps (the face-clip
    # manifold; single-point contacts make stacks only marginally stable)
    pos = run_stack(stack([0.55, 1.6, 2.65]), 300)
    assert abs(pos[0, 2] - 0.5) < 0.15
    assert abs(pos[1, 2] - 1.5) < 0.25
    assert abs(pos[2, 2] - 2.5) < 0.35
    assert np.abs(pos[:, :2]).max() < 0.3
