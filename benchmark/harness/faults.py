"""Faults planted under a trainer (the port's or the reference's) to show
that the check catches them: each takes the trainer object and the
optimizer attributes of its kind, breaks it in place, and returns a
function that undoes what it changed outside the trainer (or None).

- ``frozen_state``: every optimizer step returns the state unchanged;
- ``half_batch``: the second half of the env batch is left out, the mean
  taken over the first (every env step hands the first half's rows in
  the second half's place);
- ``altered_answer``: the env step's reward is altered where it is made
  (offset by 0.01 in every env);
- ``altered_slice``: the same offset in a fiftieth of the envs alone;
- ``scaled_adjoint``: the adjoint kernel's outputs (K2, the VJP of each
  cached substep in the reverse pass) scaled by 0.99 (the port's trainer
  only).
"""

from __future__ import annotations

import dataclasses

import torch

REWARD_OFFSET = 0.01
SLICE = 50              # altered_slice alters envs [0, E // SLICE)
ADJOINT_SCALE = 0.99


def frozen_state(tr, optimizers):
    for attr in optimizers.values():
        getattr(tr, attr).step = lambda *a, **k: None


def _wrap_step(tr, fn):
    inner = tr.env.step

    def step(env_state, actions):
        return fn(*inner(env_state, actions))
    tr.env.step = step


def half_batch(tr, optimizers):
    def dup(x):
        if not torch.is_tensor(x) or x.dim() == 0:
            return x
        h = x.shape[0] // 2
        return torch.cat([x[:h], x[:h], x[2 * h:]])

    def fn(state, obs, rew, done, info):
        state = type(state)(*(dup(getattr(state, f.name))
                              for f in dataclasses.fields(state)))
        return (state, dup(obs), dup(rew), dup(done),
                {k: dup(v) for k, v in info.items()})
    _wrap_step(tr, fn)


def altered_answer(tr, optimizers):
    def fn(state, obs, rew, done, info):
        return state, obs, rew + REWARD_OFFSET, done, info
    _wrap_step(tr, fn)


def altered_slice(tr, optimizers):
    def fn(state, obs, rew, done, info):
        n = max(1, rew.shape[0] // SLICE)
        offset = torch.zeros_like(rew)
        offset[:n] = REWARD_OFFSET
        return state, obs, rew + offset, done, info
    _wrap_step(tr, fn)


def scaled_adjoint(tr, optimizers):
    # the reverse pass imports substep_vjp from its module at each call
    from diffrl_tpu_torch.sim import substep_kernels

    inner = substep_kernels.substep_vjp

    def vjp(*a, **k):
        return tuple(None if t is None else t * ADJOINT_SCALE
                     for t in inner(*a, **k))
    vjp.launches = inner.launches       # which inner counts by its name
    substep_kernels.substep_vjp = vjp

    def undo():
        inner.launches = vjp.launches
        substep_kernels.substep_vjp = inner
    return undo


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch,
          "altered_answer": altered_answer, "altered_slice": altered_slice,
          "scaled_adjoint": scaled_adjoint}
