"""Headless tests of the port's Kit extension driver
(diffrl_tpu_torch.extension), the three of tests/test_extension.py on the
port, on the CPU; and a JAX SHAC checkpoint carried into the port
(utils.convert.checkpoint_from_jax) driving PolicyExperiment.run as the
network file: its weights and statistics exactly the JAX ones.
"""

import os
import pickle
import textwrap

import jax
import numpy as np
import torch
import yaml

from diffrl_tpu.algorithms.shac import SHAC as JSHAC

from diffrl_tpu_torch.extension import PolicyExperiment, load_experiment_script
from diffrl_tpu_torch.extension.kit_ext import DiffRLExtension
from diffrl_tpu_torch.utils.convert import checkpoint_from_jax, param_pairs

torch.set_num_threads(1)


def _tiny_cfg():
    base = os.path.join(os.path.dirname(__file__), "..", "examples", "cfg",
                        "shac", "cartpole_swing_up.yaml")
    cfg = yaml.safe_load(open(base))
    c = cfg["params"]["config"]
    c["num_actors"] = 4
    c["steps_num"] = 4
    c["max_epochs"] = 2
    c["save_interval"] = 0
    return cfg


def test_policy_experiment_ticks(tmp_path):
    usd = str(tmp_path / "traj.usda")
    exp = PolicyExperiment(_tiny_cfg(), logdir=str(tmp_path / "log"),
                           usd_path=usd, device="cpu")

    exp.train()
    exp.train()
    assert len(exp.train_loss) == 2
    assert all(np.isfinite(v) for v in exp.train_loss)

    exp.reset()
    assert exp.render_time == 0.0
    q0 = exp.trainer.env_state.joint_q.clone()
    for _ in range(3):
        exp.run()
    assert abs(exp.render_time - 3 * exp.env.dt) < 1e-9
    exp.save_usd()
    text = open(usd).read()
    assert "xformOp:orient.timeSamples" in text
    assert "epoch" in exp.log_output and "reset" in exp.log_output
    exp.reset()          # the seed's start states again
    assert torch.equal(exp.trainer.env_state.joint_q, q0)


def test_load_experiment_script(tmp_path):
    script = tmp_path / "exp.py"
    script.write_text(textwrap.dedent("""
        from diffrl_tpu_torch.extension import Experiment

        class Counter(Experiment):
            def __init__(self):
                super().__init__()
                self.n = 0
            def reset(self):
                self.n = 0
            def train(self):
                self.n += 1
                self.train_loss.append(float(-self.n))
            def run(self):
                self.render_time += 1.0 / 60.0

        def make_experiment():
            return Counter()
    """))
    exp = load_experiment_script(str(script))
    exp.train()
    assert exp.train_loss == [-1.0]

    # a module-level `experiment` object, no factory
    script2 = tmp_path / "exp2.py"
    script2.write_text(
        "from diffrl_tpu_torch.extension import Experiment\n"
        "experiment = Experiment()\n")
    assert type(load_experiment_script(str(script2))).__name__ == \
        "Experiment"


def test_kit_extension_mode_machine(tmp_path):
    """DiffRLExtension's action/update logic runs headless (no omni)."""
    ext = DiffRLExtension()
    assert ext.get_stage_script() is None  # no stage: graceful None
    ext._on_update()  # no experiment: no-op

    class Dummy:
        def __init__(self):
            self.train_loss = []
            self.render_time = 0.0
            self.log_output = ""
            self.network_file = None
            self.record = True
            self.resets = 0

        def reset(self):
            self.resets += 1

        def train(self):
            self.train_loss.append(-1.0)

        def run(self):
            self.render_time += 1.0 / 60.0

    ext.experiment = Dummy()
    ext.train()
    assert ext.mode == "training" and ext.experiment.resets == 1
    ext._on_update()
    assert ext.experiment.train_loss == [-1.0]
    ext.run()
    assert ext.mode == "inference"
    ext._on_update()
    assert ext.experiment.render_time > 0
    ext.stop()
    assert ext.mode == "stopped"
    ext.reset()
    assert ext.experiment.resets == 3  # run() + reset() each reset too


def test_policy_experiment_runs_a_jax_checkpoint(tmp_path):
    cfg = _tiny_cfg()
    cfg["params"]["general"] = {"logdir": str(tmp_path / "jax"), "seed": 3}
    jt = JSHAC(cfg)
    jt.save("jax_policy")
    with open(tmp_path / "jax" / "jax_policy.pkl", "rb") as f:
        state = pickle.load(f)
    port = str(tmp_path / "jax_policy.pt")
    checkpoint_from_jax(state, cfg, port)

    exp = PolicyExperiment(_tiny_cfg(), logdir=str(tmp_path / "log"),
                           device="cpu")
    exp.network_file = port
    exp.run()
    assert "loaded network" in exp.log_output
    t = exp.trainer
    for name, net, params in (
            ("actor", t.actor, jt.actor_params),
            ("critic", t.critic, jt.critic_params),
            ("target_critic", t.target_critic, jt.target_critic_params)):
        for pname, p, want in param_pairs(net, jax.device_get(params)):
            np.testing.assert_array_equal(p.detach().numpy(), want,
                                          err_msg=f"{name} {pname}")
    np.testing.assert_array_equal(t.obs_rms.mean.numpy(),
                                  np.asarray(jt.obs_rms.mean))
