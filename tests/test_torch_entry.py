"""The entry points: the port's ``entry`` against the root
``__graft_entry__.py``, and ``dryrun_multichip`` on a CPU mesh.

``entry(device="cpu")`` gives the JAX ``entry()``'s inputs bit for bit,
and its ``fn`` (the portable query under the float32 ladder) agrees with
JAX's: hit, status and contact type exact, depth, normal, contact point
and distance within 1e-5 (``tests/test_torch_gjkepa.py``'s float32
tolerance).
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from gjkepa_tpu_torch import entry as port_entry

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    jfn, jargs = jax_entry.entry()
    fn, args = port_entry.entry(device="cpu")
    return jfn, jargs, fn, args


def test_entry_inputs_equal_jax(both):
    _, jargs, _, args = both
    assert len(args) == 2
    for j, t in zip(jargs, args):
        assert t.device == torch.device("cpu") and t.dtype == torch.float32
        assert t.shape == (256, 16, 3)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_entry_fn_matches_jax(both):
    jfn, jargs, fn, args = both
    ref = jfn(*jargs)
    got = fn(*args)
    assert 0 < int(got.hit.sum()) < 256
    for name in ("hit", "status", "colli_type"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("depth", "normal", "contact_point", "distance"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_multichip_on_a_cpu_mesh(n):
    port_entry.dryrun_multichip(n, device="cpu")


def test_dryrun_multichip_needs_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(4)
