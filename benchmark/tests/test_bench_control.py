"""The check must fail what it exists to catch, run small on the CPU:

* the control, the references put in the program's place on inputs and
  outputs rounded to bfloat16 (the nearest precision below the
  configuration's float32), fails some number of every cell;
* a run with the timed path broken underneath comes out not correct, for
  each fault a query can have: outputs left unchanged from an earlier call,
  half of the batch left out, and answers altered where they are produced
  (one lane in 16).  The exchange between chips has no fault here: every
  cell runs on one chip."""

import time

import pytest
import torch

from benchmark import check, run, spec, window

from .conftest import CELLS, SMALL, UNLISTED, any_cell


@pytest.mark.parametrize("name", CELLS + UNLISTED)
def test_control_fails(name, cpu):
    cell = any_cell(name)
    s = run.Setup(cell, 11, cpu, pairs=512, pool=2)
    kept = window.run(s.call, s.pool, cpu, s.in_flight, calls=2,
                      keep=2).kept
    limits = cell.traffic["check"]["limits"]
    assert check.judge(s.readings(kept, 11), limits)[0] is True
    correct, numbers = check.judge(s.readings(kept, 11, control=True),
                                   limits)
    assert correct is False, numbers


def _rows(out, fn):
    """``out`` with ``fn(field, rows)`` applied to each per-lane field."""
    return type(out)(*(fn(f) for f in out))


def _zero_half(f):
    f = f.clone()
    f[f.shape[0] // 2:] = 0
    return f


def _alter(f):
    f = f.clone()
    if f.dtype == torch.bool:
        f[::16] = ~f[::16]
    else:
        f[::16] += 1 if not f.is_floating_point() else 0.01
    return f


def _unchanged():
    first = []

    def fault(out):
        if not first:
            first.append(out)
        return first[0]
    return fault


FAULTS = {"unchanged": _unchanged,
          "half_left_out": lambda: lambda out: _rows(out, _zero_half),
          "altered": lambda: lambda out: _rows(out, _alter)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS + UNLISTED)
def test_fault_is_not_correct(name, fault, cpu, monkeypatch):
    cell = any_cell(name)
    query = spec.load_module("queries", cell.traffic["query"])
    make_call = query.make_call
    broken = FAULTS[fault]()

    def make_broken(port, cfg, args):
        call = make_call(port, cfg, args)
        return lambda p1, p2: broken(call(p1, p2))
    monkeypatch.setattr(query, "make_call", make_broken)
    # a second long enough for the window to make calls on both batches
    result, lines = run.run_cell(cell, 5, 1.0, False, cpu,
                                 time.perf_counter(), lambda m: None, **SMALL)
    assert result["correct"] is False, result["check"]
    assert any(line.endswith("FAILED") for line in lines)
