"""The import rule: a run of the harness loads no module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``diffrl_tpu`` (names compared
whole: the port's ``diffrl_tpu_torch`` begins with the JAX package's), and
the plain reference loads nothing of the port either."""

import json
import subprocess
import sys

from benchmark.harness.spec import ROOT

_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_HARNESS = """
from benchmark.harness import cell_run, spec
cell = spec.load_cell("ant.shac_65536")
cell.traffic["config"].update(num_actors=4, steps_num=2)
cell_run.run(cell, 3, 0.1, True, "cpu", time.time())
"""

_REFERENCE = """
import torch
from benchmark.harness import check, spec
from benchmark.harness.subjects import ReferenceTrainer
for name in ("ant.shac_65536", "ant.ppo_65536"):
    cell = spec.load_cell(name)
    cell.traffic["config"].update(num_actors=4, steps_num=2,
                                  minibatch_size=8)
    check.read(ReferenceTrainer(cell, 3, "cpu", torch.float64), 1)
"""


def _top_level_modules(body):
    out = subprocess.run([sys.executable, "-c", _RUN.format(root=ROOT,
                                                            body=body)],
                         capture_output=True, text=True, timeout=600,
                         check=True, cwd=ROOT).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_harness_run_loads_no_jax():
    loaded = _top_level_modules(_HARNESS)
    assert "diffrl_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "diffrl_tpu"}


def test_reference_loads_nothing_of_the_port():
    loaded = _top_level_modules(_REFERENCE)
    assert not loaded & {"jax", "jaxlib", "flax", "diffrl_tpu",
                         "diffrl_tpu_torch"}
