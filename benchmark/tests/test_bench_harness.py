"""The harness is driven by data: every cell of BENCHMARK.json resolves to
its files by name, a configuration, mix, limits file or metric added in a
copy is picked up with no file edited, a tiny run on the CPU (labelled as
such) prints the result line's keys, and a run whose timed path is broken
underneath comes out not correct, once per fault a training cell can have
(one chip: no exchange between chips to leave out)."""

import json
import os
import shutil
import time

import pytest

from benchmark.harness import cell_run, spec
from benchmark.harness.faults import FAULTS
from benchmark.harness.subjects import TRAINERS

ROOT = spec.ROOT
TINY = dict(num_actors=8, steps_num=4, minibatch_size=16)
CELLS = ("ant.shac_65536", "ant.ppo_65536")


def _tiny_cell(name):
    cell = spec.load_cell(name)
    cell.traffic["config"].update(TINY)
    return cell


def _cell_faults():
    """(cell, fault) for each fault that the cell's trainer can have."""
    return [(c, f) for c in CELLS
            for f in TRAINERS[spec.load_cell(c).trainer]["faults"]]


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_resolves_by_name():
    bench = _bench()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.trainer in cell.config["trainers"]
        assert cell.limits["limits"]
        names = {m["name"] for m in cell.per_layer}
        assert names and set(cell.readers) == names
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))


def test_added_files_are_picked_up_without_edits(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    before = {p: open(os.path.join(root, "benchmark", p), "rb").read()
              for p in ("run.py", "harness/spec.py", "harness/cell_run.py")}
    # a new robot file, mix, limits and metric, and their entries
    cfg = json.loads((root / "benchmark/configs/ant.json").read_text())
    cfg["name"] = "ant2"
    (root / "benchmark/configs/ant2.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "benchmark/traffic/shac_65536.json")
                     .read_text())
    mix["config"]["num_actors"] = 1024
    (root / "benchmark/traffic/shac_1024.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/ant2.shac_1024.json").write_text(
        json.dumps({"limits": {"grad1_gap": 0.5}}))
    (root / "benchmark/metrics/epochs_in_window.py").write_text(
        "def read(ctx):\n    return ctx.epochs\n")
    bench["configs"].append(dict(bench["configs"][0], name="ant2",
                                 file="benchmark/configs/ant2.json"))
    bench["workloads"].append(dict(name="ant2.shac_1024", config="ant2",
                                   traffic="shac_1024", chips=1, why="x"))
    bench["per_layer"].append(dict(name="epochs_in_window", unit="epochs",
                                   better="higher", source="host_clock",
                                   layer="trainer",
                                   moves="train_env_steps_per_s",
                                   workloads=["ant2.shac_1024"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("ant2.shac_1024", str(root))
    assert cell.config["name"] == "ant2"
    assert cell.traffic["config"]["num_actors"] == 1024
    assert cell.limits["limits"] == {"grad1_gap": 0.5}
    assert "epochs_in_window" in cell.readers
    assert cell.readers["epochs_in_window"](
        cell_run.Context(cell, {}, 1, 1, 3, 1.0)) == 3
    for p, text in before.items():
        assert open(os.path.join(root, "benchmark", p), "rb").read() == text


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_tiny_cpu_run_prints_the_result_keys(cell_name, trace):
    cell = _tiny_cell(cell_name)
    result = cell_run.run(cell, 2 ** 31 + 5, 0.1, bool(trace), "cpu",
                          time.time())
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(result)[:-1] == keys and list(result)[-1] == "checks"
    assert json.loads(json.dumps(result)) == result
    assert result["device"]["platform"] == "cpu"
    assert "not a measurement" in result["device"]["kind"]
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in wanted}
    assert set(result["checks"]) == set(cell.limits["limits"])


@pytest.mark.parametrize("cell_name,fault", _cell_faults())
def test_a_broken_timed_path_is_not_correct(cell_name, fault, monkeypatch):
    from benchmark.harness import subjects

    inner = subjects.ProgramTrainer.__init__

    def broken(self, cell, seed, logdir, device, fault_=None):
        inner(self, cell, seed, logdir, device, FAULTS[fault])
    monkeypatch.setattr(subjects.ProgramTrainer, "__init__", broken)
    result = cell_run.run(_tiny_cell(cell_name), 2 ** 31 + 9, 0.1, False,
                          "cpu", time.time())
    assert result["correct"] is False, result["checks"]
