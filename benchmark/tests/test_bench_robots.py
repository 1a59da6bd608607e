"""A robot's reference copy can be a file of its own: an env class that
``ENVS`` lacks is found in ``ROBOTS_DIR/<name>.py`` by ``model_of`` and by
the SHAC and PPO references, with no file of the reference edited; a name
found nowhere still raises KeyError."""

import pytest
import torch

from benchmark.harness import check, spec
from benchmark.harness.subjects import ReferenceTrainer
from benchmark.reference import envs

ROBOT = '''from benchmark.reference.envs import Ant


class TinyAntEnv(Ant):
    """The Ant under another name."""
'''


def test_a_robot_file_is_found(tmp_path, monkeypatch):
    (tmp_path / "TinyAntEnv.py").write_text(ROBOT)
    monkeypatch.setattr(envs, "ROBOTS_DIR", str(tmp_path))
    cls = envs.env_class("TinyAntEnv")
    assert cls.__name__ == "TinyAntEnv" and issubclass(cls, envs.Ant)
    assert "TinyAntEnv" not in envs.ENVS
    assert envs.model_of("TinyAntEnv").dof_count == \
        envs.model_of("AntEnv").dof_count
    for cell_name in ("ant.shac_65536", "ant.ppo_65536"):
        cell = spec.load_cell(cell_name)
        cell.config["diff_env"]["name"] = "TinyAntEnv"
        cell.traffic["config"].update(num_actors=4, steps_num=2,
                                      minibatch_size=8)
        subject = ReferenceTrainer(cell, 3, "cpu", torch.float64)
        assert type(subject.tr.env).__name__ == "TinyAntEnv"
        reading = check.read(subject, 1)
        assert all(torch.isfinite(torch.tensor(list(v.values()))).all()
                   for v in reading["losses"])
        subject.close()
    with pytest.raises(KeyError):
        envs.env_class("NoSuchEnv")
