"""Each cell run small on the CPU, through the program's plain versions: a
well-formed result line that the check calls correct; and the command's
refusal without a card."""

import json
import math
import time

import pytest

from benchmark import run, spec

from .conftest import CELLS, SMALL, UNLISTED, any_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(name, traced, cpu, seed=2 ** 31 + 17):
    lines = []
    result, checks = run.run_cell(any_cell(name), seed, 0.3, traced, cpu,
                                  time.perf_counter(), lines.append,
                                  traced_calls=2, **SMALL)
    return result, checks, lines


@pytest.mark.parametrize("name", CELLS + UNLISTED)
def test_cell_untraced(name, cpu):
    result, checks, _ = _run(name, False, cpu)
    json.loads(json.dumps(result))
    assert list(result) == KEYS + ["check"]
    assert result["correct"] is True, result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0
    cell = any_cell(name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = result["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert result["device"]["count"] == 1
    assert list(result["check"]) == list(cell.traffic["check"]["limits"])
    assert len(checks) == len(result["check"])
    for line, (n, c) in zip(checks, result["check"].items()):
        assert line.startswith(f"check {n} = ") and line.endswith(" ok")
        assert c["value"] <= c["limit"]


def test_cell_traced(cpu):
    result, _, lines = _run(CELLS[0], True, cpu)
    assert list(result) == KEYS + ["breakdown", "check"]
    assert result["correct"] is True
    # no device on the CPU: only the host span reads
    assert set(result["metrics"]) == {"host_call_ms"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert any(line.startswith("traced sub-window") for line in lines)


def test_same_seed_same_pool(cpu):
    cell = spec.cell(CELLS[0])
    a = run.Setup(cell, 2 ** 31 + 5, cpu, **SMALL).pool
    b = run.Setup(cell, 2 ** 31 + 5, cpu, **SMALL).pool
    c = run.Setup(cell, 2 ** 31 + 6, cpu, **SMALL).pool
    assert all((x == y).all() for pa, pb in zip(a, b) for x, y in zip(pa, pb))
    assert not (a[0][0] == c[0][0]).all()
    assert not (a[0][0] == a[1][0]).all()       # the pool's batches differ


def test_deep_recipe_touches(cpu):
    s = run.Setup(any_cell("hull24_16k.deep_contact"), 3, cpu, **SMALL)
    assert bool(s.call(*s.pool[0]).hit.float().mean() > 0.95)


def test_command_refuses_without_a_card(capsys):
    assert run.main(["--workload", CELLS[0], "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_quantile():
    assert run._p([1.0], 0.95) == 1.0
    assert math.isclose(run._p(list(range(101)), 0.95), 95.0)
    assert math.isclose(run._p(list(range(101)), 0.5), 50.0)
