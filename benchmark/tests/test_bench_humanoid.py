"""The cell ``humanoid.shac_32768``: it resolves by name with a reader for
each of its four per-layer metrics, which read nothing without a trace; a
tiny run of it on the CPU (labelled as such) prints the result line's keys;
and a run whose timed path is broken underneath comes out not correct, once
per fault a SHAC cell can have. The last two are ``test_bench_harness.py``'s
checks, run on this cell."""

import pytest
from test_bench_harness import (
    test_a_broken_timed_path_is_not_correct as _broken_is_not_correct,
    test_tiny_cpu_run_prints_the_result_keys as _tiny_run_prints_the_keys)

from benchmark.harness import cell_run, spec
from benchmark.harness.subjects import TRAINERS

CELL = "humanoid.shac_32768"
METRICS = {"k1_roofline.humanoid", "k2_roofline.humanoid",
           "step_mfu.humanoid", "k3_roofline"}


def test_the_cell_resolves_by_name_with_its_readers():
    cell = spec.load_cell(CELL)
    assert cell.trainer == "shac" and cell.chips == 1
    assert cell.config["diff_env"]["name"] == "HumanoidEnv"
    assert cell.traffic["config"]["num_actors"] == 32768
    assert cell.traffic["check_epochs"] == 1
    assert {m["name"] for m in cell.per_layer} == METRICS
    assert set(cell.readers) == METRICS
    assert set(cell.limits["set_from"]) == set(cell.limits["limits"])


def test_the_readers_read_nothing_without_a_trace():
    cell = spec.load_cell(CELL)
    ctx = cell_run.Context(cell, {}, 8, 4, 1, 1.0)
    for name, read in cell.readers.items():
        assert read(ctx) is None, name


@pytest.mark.parametrize("trace", (0, 1))
def test_tiny_cpu_run_prints_the_result_keys(trace):
    _tiny_run_prints_the_keys(CELL, trace)


@pytest.mark.parametrize("fault", TRAINERS["shac"]["faults"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    _broken_is_not_correct(CELL, fault, monkeypatch)
