"""The control comes out not correct: the plain reference in float32 with
TF32 matmuls (the nearest precision below the configuration's float32
with TF32 off) put in the program's place, held to each cell's limits
against the float64 reference, at 2048 envs (a size a test run holds; the
cells' own sizes are read by ``benchmark/calibrate.py``). TF32 exists only
on the card."""

import pytest
import torch

from benchmark.harness import check, spec
from benchmark.harness.subjects import ReferenceTrainer


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ("ant.shac_65536", "ant.ppo_65536"))
def test_control_is_not_correct(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("TF32 needs the card")
    cell = spec.load_cell(cell_name)
    cell.traffic["config"]["num_actors"] = 2048
    if "minibatch_size" in cell.traffic["config"]:
        cell.traffic["config"]["minibatch_size"] = 2048 * 32 // 4
    epochs = int(cell.traffic["check_epochs"])
    ref = check.read(ReferenceTrainer(cell, 21, "cuda", torch.float64),
                     epochs)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        control = check.read(
            ReferenceTrainer(cell, 21, "cuda", torch.float32), epochs)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved
    correct, rows = check.judge(check.compare(control, ref),
                                cell.limits["limits"])
    assert not correct, rows
