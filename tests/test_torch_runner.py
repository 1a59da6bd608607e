"""The port's Runner (diffrl_tpu_torch.algorithms.runner) and its two
training command lines, train_bptt and train_rl, on the CPU.

- the Runner's name map against the JAX package's (the same names, each to
  the trainer of the same name);
- the command lines' arguments: the defaults (examples/cfg/bptt/ant.yaml
  and examples/cfg/ppo/ant.yaml, CUDA unless --device), the overrides into
  the config (--num-envs, --max-epochs, --save-interval into
  save_interval or save_frequency);
- one tiny epoch of each through its command line with --device cpu
  (configs from examples/cfg/ cut to 2 envs and 3 steps in a temporary
  file): BPTT on CartPole, PPO and SAC through the Runner on CartPole, the
  config written next to the logs and the final checkpoint saved; BPTT's
  checkpoint then played (--play).
"""

import os

import pytest
import yaml

from diffrl_tpu.algorithms.runner import _ALGOS as JAX_ALGOS

from diffrl_tpu_torch import train_bptt, train_rl
from diffrl_tpu_torch.algorithms import BPTT, PPO, SAC
from diffrl_tpu_torch.algorithms.runner import ALGOS, Runner
from diffrl_tpu_torch.train_shac import build_config

HERE = os.path.dirname(__file__)
CFG = os.path.join(HERE, "..", "examples", "cfg")


def test_name_map_matches_jax():
    assert set(ALGOS) == set(JAX_ALGOS)
    for name, cls in ALGOS.items():
        assert cls.__name__ == JAX_ALGOS[name].__name__, name
    r = Runner(device="cpu")
    r.load({"params": {"algo": {"name": "nope"}}})
    with pytest.raises(KeyError):
        r.run({})


def test_command_lines_parse_and_override():
    a = train_bptt.get_args([])
    assert a.cfg.endswith(os.path.join("bptt", "ant.yaml"))
    assert a.device is None and a.logdir == "logs/tmp/bptt/"
    a = train_rl.get_args(["--cfg", os.path.join(CFG, "sac", "ant.yaml"),
                           "--num-envs", "3", "--max-epochs", "2",
                           "--save-interval", "7", "--no-time-stamp",
                           "--device", "cpu"])
    assert a.device == "cpu"
    config = build_config(a)["params"]["config"]
    assert (config["num_actors"], config["max_epochs"],
            config["save_frequency"]) == (3, 2, 7)
    assert train_rl.get_args([]).cfg.endswith(os.path.join("ppo",
                                                          "ant.yaml"))
    a = train_bptt.get_args(["--save-interval", "5", "--no-time-stamp",
                             "--play"])
    cfg = build_config(a)
    assert cfg["params"]["config"]["save_interval"] == 5
    assert cfg["params"]["config"]["num_actors"] == 2   # player.num_actors
    assert cfg["params"]["general"]["train"] is False


def _tiny(tmp_path, algo, **config):
    with open(os.path.join(CFG, algo, "cartpole_swing_up.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["config"].update(config)
    cfg["params"]["diff_env"]["episode_length"] = 3
    path = tmp_path / f"{algo}.yaml"
    path.write_text(yaml.dump(cfg))
    return str(path)


def _argv(cfg, logdir, *more):
    return ["--cfg", cfg, "--device", "cpu", "--num-envs", "2",
            "--max-epochs", "1", "--no-time-stamp", "--logdir", str(logdir),
            *more]


def test_train_bptt_runs_one_epoch_and_plays_on_the_cpu(tmp_path):
    cfg = _tiny(tmp_path, "bptt", steps_num=3)
    trainer = train_bptt.main(_argv(cfg, tmp_path / "b"))
    assert isinstance(trainer, BPTT) and trainer.iter_count == 1
    assert trainer.device.type == "cpu"
    for f in ("cfg.yaml", "final_policy.pt"):
        assert (tmp_path / "b" / f).exists(), f
    with open(cfg) as f:
        player = yaml.safe_load(f)
    player["params"]["config"]["player"]["games_num"] = 2
    (tmp_path / "play.yaml").write_text(yaml.dump(player))
    mean_loss, mean_len = train_bptt.main(_argv(
        str(tmp_path / "play.yaml"), tmp_path / "p", "--play", "--checkpoint",
        str(tmp_path / "b" / "final_policy.pt")))
    assert mean_len == 3.0


@pytest.mark.parametrize("algo,cls,config", [
    ("ppo", PPO, dict(steps_num=3, minibatch_size=3, mini_epochs=1)),
    ("sac", SAC, dict(num_steps_per_episode=3, batch_size=4,
                      num_seed_steps=0, replay_buffer_size=64)),
])
def test_train_rl_runs_one_epoch_through_the_runner_on_the_cpu(
        tmp_path, algo, cls, config):
    trainer = train_rl.main(_argv(_tiny(tmp_path, algo, **config),
                                  tmp_path / algo))
    assert isinstance(trainer, cls) and trainer.iter_count == 1
    assert trainer.device.type == "cpu"
    for f in ("cfg.yaml", "final_policy.pt"):
        assert (tmp_path / algo / f).exists(), f
