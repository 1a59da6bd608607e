"""A linear-quadratic toy env, written once for both packages, so that the
model-free trainers (PPO, SAC) can be held against the JAX package's whole
epochs without compiling any physics.

State: x [E, 3] and the step count t [E]. A step clips the actions to
[-1, 1], sets x' = x A^T + a B^T, rewards -|x'|^2 - 0.1 |a|^2, ends an
episode at ``episode_length`` steps (truncation) or when |x'|^2 > 2.5
(termination), and resets ended envs to fixed start states X0[e], so that
no random draw differs between the packages. ``backend`` is "jax" (the JAX
trainers' interface: reset(key), state a dict pytree) or "torch" (the
port's: tensors on ``device``).
"""

import numpy as np

_RS = np.random.RandomState(0)
A = (0.9 * np.eye(3) + 0.1 * _RS.normal(size=(3, 3))).astype(np.float32)
B = (0.5 * _RS.normal(size=(3, 2))).astype(np.float32)
X0 = _RS.uniform(-0.6, 0.6, (64, 3)).astype(np.float32)


class ToyEnv:
    num_obs, num_acts = 3, 2

    def __init__(self, backend, num_envs=8, episode_length=5, device="cpu"):
        self.num_envs = num_envs
        self.episode_length = episode_length
        if backend == "jax":
            import jax.numpy as xp
            self.asarray = xp.asarray
        else:
            import torch as xp
            self.asarray = lambda a: torch_asarray(a, device)
            self.device = xp.device(device)
        self.xp = xp
        self.A, self.B = self.asarray(A.T), self.asarray(B.T)
        self.x0 = self.asarray(X0[:num_envs])

    def shard(self, rank, size):
        """Rows [rank E/size, (rank + 1) E/size) of the batch: the port's
        data mesh (its trainers call it under multi_gpu)."""
        n = self.num_envs // size
        self.x0 = self.x0[rank * n:(rank + 1) * n]
        self.num_envs = n
        return self

    def reset(self, key=None):
        return {"x": self.x0 + 0.0, "t": self.x0[:, 0] * 0}

    def batch_observations(self, state):
        return state["x"]

    def step(self, state, actions):
        xp = self.xp
        a = actions.clip(-1.0, 1.0)
        x = state["x"] @ self.A + a @ self.B
        t = state["t"] + 1
        rew = -(x * x).sum(-1) - 0.1 * (a * a).sum(-1)
        truncation = t >= self.episode_length
        term = (x * x).sum(-1) > 2.5
        done = truncation | term
        x_new = xp.where(done[:, None], self.x0, x)
        new = {"x": x_new, "t": xp.where(done, t * 0, t)}
        info = {"obs_before_reset": x, "truncation": truncation,
                "episode_end": term, "invalid": term & False}
        return new, x_new, rew, done, info


def torch_asarray(a, device):
    import torch
    return torch.as_tensor(np.asarray(a), device=device)
