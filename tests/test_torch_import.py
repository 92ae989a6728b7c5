"""The PyTorch port's package boundary: no JAX, the carried state, and no
fallback between the kernels and their plain versions."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu.ops.directions import DIRECTION_TABLE as JAX_TABLE
from gjkepa_tpu_torch import GJKEPAConfig, _build
from gjkepa_tpu_torch.ops import fused_epa, fused_gjk
from gjkepa_tpu_torch.ops import fused_streamed as fst
from gjkepa_tpu_torch.ops.directions import DIRECTION_TABLE
from gjkepa_tpu_torch.ops.fused import cascade_plan, hit_first_order

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_out():
    code = ("import sys, gjkepa_tpu_torch, gjkepa_tpu_torch.api, "
            "gjkepa_tpu_torch._build, gjkepa_tpu_torch.models, "
            "gjkepa_tpu_torch.models.fixtures, "
            "gjkepa_tpu_torch.ops.shape_geom, "
            "gjkepa_tpu_torch.ops.fused_shapes, "
            "gjkepa_tpu_torch.ops.contact_shapes, "
            "gjkepa_tpu_torch.ops.distance, "
            "gjkepa_tpu_torch.ops.fused_distance, "
            "gjkepa_tpu_torch.ops.fused_hull_shapes, "
            "gjkepa_tpu_torch.ops.fused_streamed, "
            "gjkepa_tpu_torch.ops.geom, gjkepa_tpu_torch.ops.gjk, "
            "gjkepa_tpu_torch.ops.epa, gjkepa_tpu_torch.ops.contact, "
            "gjkepa_tpu_torch.ops.broadphase, gjkepa_tpu_torch.utils.hull, "
            "gjkepa_tpu_torch.ops.manifold, gjkepa_tpu_torch.sim, "
            "gjkepa_tpu_torch.sim.rigid, gjkepa_tpu_torch.parallel, "
            "gjkepa_tpu_torch.parallel.sharding, gjkepa_tpu_torch.debug, "
            "gjkepa_tpu_torch.entry; "
            "from gjkepa_tpu_torch import (manifold_batch, "
            "manifold_shapes_batch, manifold_hull_shape_batch, "
            "ManifoldResult); "
            "from gjkepa_tpu_torch.sim import (SimState, SimConfig, "
            "init_boxes, sim_step); "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'gjkepa_tpu.')) "
            "or m == 'gjkepa_tpu'); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("make", [
    lambda c: c(),
    lambda c: c.for_f32(),
    lambda c: c.for_f32(10.0).replace(version=3, epa_max_iters=40),
], ids=["default", "for_f32", "scaled_v3"])
def test_config_from_reference_roundtrips(make):
    jax_cfg = make(JaxConfig)
    cfg = GJKEPAConfig.from_reference(dataclasses.asdict(jax_cfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    assert cfg == make(GJKEPAConfig)


def test_config_from_reference_rejects_drift():
    fields = dataclasses.asdict(JaxConfig())
    with pytest.raises(ValueError, match="unknown"):
        GJKEPAConfig.from_reference({**fields, "extra_knob": 1})
    del fields["version"]
    with pytest.raises(ValueError, match="missing"):
        GJKEPAConfig.from_reference(fields)


def test_direction_table_equals_jax():
    assert DIRECTION_TABLE.dtype == np.float64
    np.testing.assert_array_equal(DIRECTION_TABLE, JAX_TABLE)


def _cubes(b=4, dx=0.5):
    c = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                  for z in (-.5, .5)], np.float32)
    p1 = torch.from_numpy(np.stack([c] * b))
    p2 = torch.from_numpy(np.stack([c + np.float32([dx, 0, 0])] * b))
    return p1, p2


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors the wrappers never build or launch a kernel."""
    def no_build():
        raise AssertionError("kernel build attempted for CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    n1, n2, n3 = fused_gjk.LAUNCHES, fused_epa.LAUNCHES, dict(fst.LAUNCHES)
    p1, p2 = _cubes()
    cfg = GJKEPAConfig.for_f32()
    g = fused_gjk.gjk_hulls(p1, p2, cfg)
    order, n_act = hit_first_order(g.hit)
    e = fused_epa.epa_cascade(p1, p2, g.simplex, g.status, order, n_act,
                              cascade_plan(cfg))
    assert bool(g.hit.all())
    np.testing.assert_allclose(e.depth.numpy(), 0.5, atol=1e-6)
    # the large-hull kernels' wrappers (K12, K13) on the same pairs
    gb = fst.gjk_hulls_big(p1, p2, fst.streamed_broadphase(
        p1, p2, cfg.broadphase_tol), cfg)
    eb = fst.epa_hulls_big(p1, p2, gb.simplex, gb.status, order, n_act,
                           cascade_plan(cfg))
    assert all(torch.equal(x, y) for x, y in zip((*g, *e), (*gb, *eb)))
    assert (fused_gjk.LAUNCHES, fused_epa.LAUNCHES) == (n1, n2)
    assert fst.LAUNCHES == n3


def test_kernel_entry_raises_without_nvcc(monkeypatch, tmp_path):
    """The CUDA entry points build with nvcc or raise: nothing falls back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load.cache_clear()
    p1, p2 = _cubes()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            fused_gjk._gjk_hulls_cuda(p1, p2, GJKEPAConfig.for_f32())
    finally:
        _build.load.cache_clear()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("kernel", ["gjk", "epa"])
def test_unsupported_device_raises(kernel):
    """A tensor on a device with no kernel is refused, not moved."""
    p1, p2 = (t.to("meta") for t in _cubes())
    cfg = GJKEPAConfig.for_f32()
    with pytest.raises(ValueError, match="no K[12] kernel for device meta"):
        if kernel == "gjk":
            fused_gjk.gjk_hulls(p1, p2, cfg)
        else:
            b = p1.shape[0]
            fused_epa.epa_cascade(
                p1, p2, torch.empty((b, 4, 3), device="meta"),
                torch.empty(b, dtype=torch.int32, device="meta"),
                torch.empty(b, dtype=torch.int32, device="meta"),
                torch.empty((), dtype=torch.int32, device="meta"),
                cascade_plan(cfg))


def test_wrappers_reject_what_the_kernels_do_not_take():
    p1, p2 = _cubes()
    cfg = GJKEPAConfig.for_f32()
    with pytest.raises(TypeError, match="float32"):
        fused_gjk.gjk_hulls(p1.double(), p2.double(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fused_gjk.gjk_hulls(p1.transpose(0, 1), p2.transpose(0, 1), cfg)
    with pytest.raises(ValueError, match="batch sizes differ"):
        fused_gjk.gjk_hulls(p1, p2[:2], cfg)
