#!/usr/bin/env python3
"""Least floors of the float64 rule for the port's kernels (K1 and K2).

    python3 tools/torch_vjp_floor.py [--env NAME]     (default: Ant)

Needs one CUDA device. On settled states of the env (zero-action env steps
from reset, chip_smoke.py's MODELS) at E = 4096 (three seeds of actions and
cotangents) and E = 1000 (one), it runs one cached substep through K1 and
its VJP through K2, their plain versions in float32 and their plain
versions in float64; for the first two seeds at E = 4096 also one env
step's gradient on the kernel path and the plain path. For each output it
prints the least floor that diffrl_tpu_torch.testing.check_against_f64
would need with the kernel in the kernel's role, and with the roles of the
kernel and the plain version swapped: where the plain version takes the
float64 branch of every select, the second is the float32 noise the rule's
floor must cover. It also prints each side's largest error against
float64, and the entries where kernel and plain version differ by more
than check_vjp allows: how many, and at how many of them the kernel is the
one further from float64.
"""

from __future__ import annotations

import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import diffrl_tpu_torch.envs as envs  # noqa: E402
from diffrl_tpu_torch.sim import articulation_lb as lb  # noqa: E402
from diffrl_tpu_torch.sim import substep_kernels as sk  # noqa: E402
from diffrl_tpu_torch.testing import check_against_f64, env_scale  # noqa

CASES = ((4096, 1, True), (4096, 2, True), (4096, 3, False),
         (1000, 0, False))


def report(what, labels, kernel, plain, exact, rtol, atol):
    for lab, k, p, x in zip(labels, kernel, plain, exact):
        *_, e_k, e_p, need = check_against_f64(lab, k, p, x, rtol, atol,
                                               floor=math.inf)
        swapped = check_against_f64(lab, p, k, x, rtol, atol,
                                    floor=math.inf)[4]
        off = (k - p).abs() > rtol * p.abs() + atol * env_scale(p)
        worse = off & ((k.double() - x).abs() > (p.double() - x).abs())
        print(f"{what} {lab}: least floor {need:.3f}, swapped "
              f"{swapped:.3f}; max error vs float64 kernel {e_k:.3e} "
              f"plain {e_p:.3e}; off the plain version {int(off.sum())}, "
              f"the kernel further from float64 at {int(worse.sum())}",
              flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_vjp_floor: CUDA is not available", file=sys.stderr)
        return 1
    name = "Ant"
    if argv[:1] == ["--env"]:
        name = argv[1]
    spec = cs.MODELS[name]
    mm = spec["mm"]
    dev = torch.device("cuda", 0)
    for E, seed, with_step in CASES:
        env = envs.make(name, num_envs=E, seed=0, stochastic_init=True,
                        MM_caching_frequency=mm, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        s = cs.settled_state(env, spec["settle"])
        acts = torch.rand((E, env.num_acts), generator=gen, device=dev) * 2 - 1
        ja = env.action_to_controls(acts)[0]
        jat = ja.T.contiguous()
        h = env.dt / env.sim_substeps
        q, qd = s.joint_q.T.contiguous(), s.joint_qd.T.contiguous()
        with torch.no_grad():
            q1, qd1, H, Hinv = lb.refresh_substep_lb(env.model, q, qd, jat,
                                                     None, h)
        gq = torch.randn(q1.shape, generator=gen, device=dev)
        gqd = torch.randn(qd1.shape, generator=gen, device=dev)
        args = (env.model, q1, qd1, jat, None, h, H, Hinv, gq, gqd)
        d64 = [t.double() for t in args[1:4]]
        kf = sk.substep_forward(*args[:8])
        pf = lb.substep_lb(*args[:8])
        xf = lb.substep_lb(env.model, *d64, None, h, H.double(),
                           Hinv.double())
        report(f"{name} E={E} seed {seed} substep forward", ("q", "qd"),
               kf, pf, xf, 2e-5, 2e-5)
        kv = sk.substep_vjp(*args)
        pv = lb.substep_vjp_lb(*args)
        xv = lb.substep_vjp_lb(env.model, *d64, None, h,
                               *(t.double() for t in args[6:]))
        report(f"{name} E={E} seed {seed} substep", ("dq", "dqd",
                                                     "djoint_act", "dH"),
               kv[:3] + kv[4:], pv[:3] + pv[4:], xv[:3] + xv[4:], 2e-4, 1e-5)
        if with_step:
            w_q = torch.randn(s.joint_q.shape, generator=gen, device=dev)
            w_qd = torch.randn(s.joint_qd.shape, generator=gen, device=dev)
            gargs = (s.joint_q, s.joint_qd, ja, w_q, w_qd, mm,
                     env.sim_substeps)
            kg = cs.step_grad(env.model, *gargs, plain=False)
            pg = cs.step_grad(env.model, *gargs, plain=True)
            xg = cs.step_grad(env.model, *(t.double() for t in gargs[:5]),
                              mm, env.sim_substeps, plain=True)
            report(f"{name} E={E} seed {seed} env step",
                   ("dq", "dqd", "djoint_act"), [t.T for t in kg],
                   [t.T for t in pg], [t.T for t in xg], 1e-3, 1e-4)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
