"""Ant and Humanoid for the benchmark's plain reference: a frozen copy of
the port's ``envs/base.py`` (the replay path only), ``envs/locomotion.py``,
``envs/ant.py`` and ``envs/humanoid.py``, computed in ``dtype``.

Every random draw is the port's: the same calls on a ``torch.Generator`` of
the same device and seed, made in float32 and only then cast to ``dtype``,
so that the reference sees the start states that the program draws.

Another robot's reference copy is a file of its own: ``env_class(name)``
finds an env class that ``ENVS`` lacks in ``ROBOTS_DIR/<name>.py``, which
defines a class of that name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

from .articulation import free_graphs, simulate_batched_lb
from .mjcf import parse_mjcf
from .model import ModelBuilder, np_quat_from_axis_angle

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")
ROBOTS_DIR = os.path.join(os.path.dirname(__file__), "robots")
_EPS = 1.0e-6


# -- quaternions ([x, y, z, w]) ------------------------------------------------

def quat_from_angle_axis(angle, axis):
    half = angle * 0.5
    return torch.cat([axis * torch.sin(half)[..., None],
                      torch.cos(half)[..., None]], dim=-1)


def quat_mul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + bw * ax + ay * bz - by * az,
                        aw * by + bw * ay + az * bx - bz * ax,
                        aw * bz + bw * az + ax * by - bx * ay,
                        aw * bw - ax * bx - ay * by - az * bz], dim=-1)


def quat_conjugate(q):
    return torch.cat([-q[..., 0:3], q[..., 3:4]], dim=-1)


def quat_rotate(q, v):
    qv, w = q[..., 0:3], q[..., 3:4]
    qv_b, v_b = torch.broadcast_tensors(qv, v)
    return (v * (2.0 * w * w - 1.0)
            + torch.linalg.cross(qv_b, v_b, dim=-1) * w * 2.0
            + qv * torch.sum(qv * v, dim=-1, keepdim=True) * 2.0)


def safe_normalize(v, eps=_EPS):
    l2 = torch.sum(v * v, dim=-1, keepdim=True)
    safe = l2 > eps * eps
    inv = torch.where(
        safe, 1.0 / torch.sqrt(torch.where(safe, l2, torch.ones_like(l2))),
        torch.zeros_like(l2))
    return v * inv


# -- the env step ----------------------------------------------------------------

@dataclass
class EnvState:
    joint_q: torch.Tensor      # [E, C]
    joint_qd: torch.Tensor     # [E, D]
    actions: torch.Tensor      # [E, A]
    progress: torch.Tensor     # [E] int32

    def detach(self) -> "EnvState":
        return EnvState(self.joint_q.detach(), self.joint_qd.detach(),
                        self.actions.detach(), self.progress)


def clip(x, lo: float, hi: float):
    """jnp.clip's semantics (a tie splits the cotangent)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _sanitize(x):
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


class _GradNanGuard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sanitize(g)


def grad_nan_guard(x):
    if x is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _GradNanGuard.apply(x)


class LocomotionEnv:
    """A free-base locomotion env on the link-batched replay path."""

    num_obs = 0
    num_acts = 0
    dt = 1.0 / 60.0
    sim_substeps = 16
    start_height = 0.0
    targets = (0.0, 0.0, 0.0)
    termination_height = 0.0
    joint_vel_obs_scaling = 0.1

    def __init__(self, num_envs, seed, episode_length, stochastic_init,
                 mm_caching_frequency, device, dtype=torch.float64):
        self.device, self.dtype = torch.device(device), dtype
        self.num_envs = num_envs
        self.episode_length = episode_length
        self.stochastic_init = stochastic_init
        self.mm_caching_frequency = mm_caching_frequency
        if self.sim_substeps % mm_caching_frequency:
            raise ValueError(
                "sim_substeps must be a multiple of MM_caching_frequency")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.model = self.build_model()
        start_rotation = torch.as_tensor(
            np_quat_from_axis_angle((1.0, 0.0, 0.0), -math.pi * 0.5),
            dtype=torch.float32, device=self.device).to(dtype)
        self.inv_start_rot = quat_conjugate(start_rotation)
        self.start_pos = torch.tensor([0.0, self.start_height, 0.0],
                                      dtype=dtype, device=self.device)
        self.target = torch.tensor(self.targets, dtype=dtype,
                                   device=self.device)
        self.joint_q_init = torch.as_tensor(
            self.model.joint_q_init, device=self.device).to(dtype)

    def _builder_and_start(self):
        builder = ModelBuilder()
        parse_mjcf(os.path.join(_ASSETS, self.asset), builder,
                   **self.mjcf_args)
        builder.joint_q[0:3] = [0.0, self.start_height, 0.0]
        builder.joint_q[3:7] = list(
            np_quat_from_axis_angle((1.0, 0.0, 0.0), -math.pi * 0.5))
        return builder

    def _finalize(self, builder):
        return dataclasses.replace(
            builder.finalize(), ground=True,
            gravity=np.array([0.0, -9.81, 0.0], np.float32))

    def initial_state(self, n):
        """n start states: the program's draws (float32), cast to dtype."""
        C, D = self.model.coord_count, self.model.dof_count
        q0 = self.joint_q_init.expand(n, C)
        qd0 = torch.zeros((n, D), dtype=self.dtype, device=self.device)
        if not self.stochastic_init:
            return q0.clone(), qd0

        def uniform(*shape):
            return torch.rand(shape, generator=self.generator,
                              device=self.device).to(self.dtype)

        pos = q0[:, 0:3] + 0.1 * (uniform(n, 3) - 0.5) * 2.0
        angle = (uniform(n) - 0.5) * math.pi / 12.0
        axis = safe_normalize(uniform(n, 3) - 0.5)
        rot = quat_mul(q0[:, 3:7], quat_from_angle_axis(angle, axis))
        joints = q0[:, 7:] + 0.2 * (uniform(n, C - 7) - 0.5) * 2.0
        return (torch.cat([pos, rot, joints], dim=-1),
                0.5 * (uniform(n, D) - 0.5))

    def observations(self, joint_q, joint_qd, actions):
        torso_pos = joint_q[:, 0:3]
        torso_rot = joint_q[:, 3:7]
        ang_vel = joint_qd[:, 0:3]
        lin_vel = joint_qd[:, 3:6] - torch.linalg.cross(torso_pos, ang_vel,
                                                        dim=-1)
        to_target = self.target + self.start_pos - torso_pos
        to_target = torch.stack([to_target[:, 0],
                                 torch.zeros_like(to_target[:, 1]),
                                 to_target[:, 2]], dim=-1)
        target_dirs = safe_normalize(to_target)
        torso_quat = quat_mul(torso_rot,
                              self.inv_start_rot.expand_as(torso_rot))
        basis = torch.eye(3, dtype=torso_quat.dtype, device=torso_quat.device)
        up_vec = quat_rotate(torso_quat, basis[1])
        heading_vec = quat_rotate(torso_quat, basis[0])
        heading = torch.sum(heading_vec * target_dirs, dim=-1)
        return torch.cat([torso_pos[:, 1:2], torso_rot, lin_vel, ang_vel,
                          joint_q[:, 7:],
                          self.joint_vel_obs_scaling * joint_qd[:, 6:],
                          up_vec[:, 1:2], heading[:, None], actions], dim=-1)

    def termination(self, obs):
        return obs[:, 0] < self.termination_height

    def invalid_mask(self, obs, joint_q, joint_qd):
        return torch.zeros(obs.shape[0], dtype=torch.bool, device=obs.device)

    zero_reward_on_invalid = False

    def reset(self) -> EnvState:
        q, qd = self.initial_state(self.num_envs)
        return EnvState(
            q, qd, torch.zeros((self.num_envs, self.num_acts),
                               dtype=self.dtype, device=self.device),
            torch.zeros((self.num_envs,), dtype=torch.int32,
                        device=self.device))

    def batch_observations(self, s: EnvState):
        return self.observations(s.joint_q, s.joint_qd, s.actions)

    def initialize_trajectory(self, s: EnvState):
        d = s.detach()
        return d, self.batch_observations(d)

    def step(self, env_state: EnvState, actions):
        """One env step (the port's DiffEnv.step, in the same order)."""
        actions = torch.clamp(actions.reshape(self.num_envs, self.num_acts),
                              -1.0, 1.0)
        joint_act = self.action_to_controls(actions)
        q, qd = simulate_batched_lb(
            self.model, *map(grad_nan_guard, (env_state.joint_q,
                                              env_state.joint_qd,
                                              joint_act)),
            None, dt=self.dt, substeps=self.sim_substeps,
            mass_matrix_freq=self.mm_caching_frequency)
        progress = env_state.progress + 1
        obs = self.observations(_sanitize(q), _sanitize(qd), actions)
        rew = self.reward(obs, actions)
        truncation = progress > self.episode_length - 1
        term = self.termination(obs)
        invalid = self.invalid_mask(obs, q, qd)
        done = truncation | term | invalid
        rew = torch.where(torch.isfinite(rew), rew, torch.zeros_like(rew))
        if self.zero_reward_on_invalid:
            rew = torch.where(invalid, torch.zeros_like(rew), rew)
        q0, qd0 = (x.detach() for x in self.initial_state(self.num_envs))
        d = done[:, None]
        q_new = torch.where(d, q0, torch.where(d, _sanitize(q), q))
        qd_new = torch.where(d, qd0, torch.where(d, _sanitize(qd), qd))
        actions_new = torch.where(d, torch.zeros_like(actions), actions)
        progress_new = torch.where(done, torch.zeros_like(progress), progress)
        obs_out = torch.where(d, self.observations(q_new, qd_new,
                                                   actions_new), obs)
        info = {"obs_before_reset": obs, "truncation": truncation}
        return (EnvState(q_new, qd_new, actions_new, progress_new), obs_out,
                rew, done, info)

    def close(self):
        """Frees the simulator's CUDA graphs of this env's model."""
        free_graphs(self.model)


class Ant(LocomotionEnv):
    num_obs, num_acts = 37, 8
    sim_substeps = 16
    termination_height = 0.27
    action_strength = 200.0
    start_height = 0.75
    targets = (10000.0, 0.0, 0.0)
    asset = "ant.xml"
    mjcf_args = dict(density=1000.0, stiffness=0.0, damping=1.0,
                     contact_ke=4.0e4, contact_kd=1.0e4, contact_kf=3.0e3,
                     contact_mu=0.75, limit_ke=1.0e3, limit_kd=1.0e1,
                     armature=0.05)
    start_joint_q = (0.0, 1.0, 0.0, -1.0, 0.0, -1.0, 0.0, 1.0)

    def build_model(self):
        builder = self._builder_and_start()
        builder.joint_q[7:15] = list(self.start_joint_q)
        builder.joint_target[7:15] = list(self.start_joint_q)
        return self._finalize(builder)

    def action_to_controls(self, actions):
        return torch.cat([actions.new_zeros((actions.shape[0], 6)),
                          actions * self.action_strength], dim=-1)

    def reward(self, obs, actions):
        return (obs[:, 5] + 0.1 * obs[:, 27] + obs[:, 28]
                + (obs[:, 0] - self.termination_height)
                + torch.sum(actions ** 2, dim=-1) * 0.0)


_MOTOR_STRENGTHS = (200, 200, 200, 200, 200, 600, 400, 100, 100, 200, 200,
                    600, 400, 100, 100, 100, 100, 200, 100, 100, 200)


class Humanoid(LocomotionEnv):
    num_obs, num_acts = 76, 21
    sim_substeps = 48
    termination_height = 0.74
    motor_scale = 0.35
    action_penalty = -0.002
    termination_tolerance = 0.1
    height_rew_scale = 10.0
    start_height = 1.35
    targets = (200.0, 0.0, 0.0)
    asset = "humanoid.xml"
    mjcf_args = dict(stiffness=5.0, damping=0.1, contact_ke=2.0e4,
                     contact_kd=5.0e3, contact_kf=1.0e3, contact_mu=0.75,
                     limit_ke=1.0e3, limit_kd=1.0e1, armature=0.007,
                     load_stiffness=True, load_armature=True)
    zero_reward_on_invalid = True

    def build_model(self):
        return self._finalize(self._builder_and_start())

    def action_to_controls(self, actions):
        strengths = torch.tensor(_MOTOR_STRENGTHS, dtype=torch.float32,
                                 device=actions.device).to(actions.dtype)
        return torch.cat([actions.new_zeros((actions.shape[0], 6)),
                          actions * self.motor_scale * strengths], dim=-1)

    def reward(self, obs, actions):
        height_diff = obs[:, 0] - (self.termination_height
                                   + self.termination_tolerance)
        height = clip(height_diff, -1.0, self.termination_tolerance)
        height = torch.where(height < 0.0, -200.0 * height ** 2, height)
        height = torch.where(height > 0.0, self.height_rew_scale * height,
                             height)
        return (obs[:, 5] + 0.1 * obs[:, 53] + obs[:, 54] + height
                + torch.sum(actions ** 2, dim=-1) * self.action_penalty)

    def invalid_mask(self, obs, joint_q, joint_qd):
        return (torch.any(~torch.isfinite(obs), dim=-1)
                | torch.any(~torch.isfinite(joint_q), dim=-1)
                | torch.any(~torch.isfinite(joint_qd), dim=-1)
                | torch.any(torch.abs(joint_q) > 1e6, dim=-1)
                | torch.any(torch.abs(joint_qd) > 1e6, dim=-1))


ENVS = {"AntEnv": Ant, "HumanoidEnv": Humanoid}


def env_class(name):
    """The reference env class ``name``: from ``ENVS``, else the class of
    that name in the module ``ROBOTS_DIR/<name>.py`` (which imports what it
    needs from ``benchmark.reference``). KeyError where neither has it."""
    if name in ENVS:
        return ENVS[name]
    path = os.path.join(ROBOTS_DIR, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no reference env {name!r}: not in ENVS, and no "
                       f"{path}")
    module_name = f"benchmark.reference.robots.{name}"
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    if not hasattr(module, name):
        raise KeyError(f"{path} defines no class {name!r}")
    return getattr(module, name)


def model_of(name):
    """The model of env ``name`` (its class's build, no env state)."""
    cls = env_class(name)
    return cls.build_model(cls.__new__(cls))
