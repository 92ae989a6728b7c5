"""Small CPU runs of the benchmark's cells: the program's plain versions on
CPU tensors, at a few hundred pairs."""

import pytest
import torch

from benchmark import spec

BENCH = spec.load_json(spec.BENCHMARK_JSON)
CELLS = [w["name"] for w in BENCH["workloads"]]
# mixes whose files are here but whose cells are not in BENCHMARK.json yet
# (their host-bound rate spreads too widely for a bound; PERF.md section 7):
# held to the same tests, so a later entry finds them working
UNLISTED = ["hull24_16k.deep_contact", "hull64_64k.contact"]
SMALL = {"pairs": 256, "pool": 2}


def any_cell(name: str) -> spec.Cell:
    """A cell of BENCHMARK.json, or one of the unlisted mixes with every
    end-to-end metric and no per-layer one."""
    if name in CELLS:
        return spec.cell(name)
    config, traffic = name.split(".")
    return spec.Cell(name, 1,
                     spec.load_json(spec.HERE / "configs" / f"{config}.json"),
                     spec.load_json(spec.HERE / "traffic" / f"{traffic}.json"),
                     BENCH["end_to_end"], [])


@pytest.fixture
def cpu():
    return torch.device("cpu")
