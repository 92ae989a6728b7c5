"""The check on imported module names: top-level names compared whole."""

import subprocess
import sys

from benchmark import run, spec


def test_forbidden_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "gjkepa_tpu",
            "gjkepa_tpu.ops.fused", "gjkepa_tpu_torch",
            "gjkepa_tpu_torch.ops.fused", "jaxtyping", "bench", "chip_smoke",
            "tests.oracle_np", "benchmark.tests.conftest", "torch"]
    assert run.forbidden(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "gjkepa_tpu",
         "gjkepa_tpu.ops.fused", "bench", "chip_smoke", "tests.oracle_np"])


def test_benchmark_and_port_load_no_jax():
    """Everything a run imports, in a fresh process."""
    code = ("import sys, benchmark.run as r, benchmark.calibrate, "
            "benchmark.trace, benchmark.check, gjkepa_tpu_torch\n"
            "from benchmark import spec\n"
            "for c in spec.load_json(spec.BENCHMARK_JSON)['workloads']:\n"
            "    cell = spec.cell(c['name'])\n"
            "    spec.load_module('queries', cell.traffic['query'])\n"
            "    [spec.load_module('metrics', m['name']) "
            "for m in cell.per_layer]\n"
            "print(r.forbidden(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == "[]"
