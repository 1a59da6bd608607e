"""Tolerance rules that hold a kernel against its plain version.

``chip_smoke.py``, ``tools/bench_substep_teams.py`` and
``tests/test_torch_cuda.py`` check both kernels with these functions, so
the rule is written once. They were made for the adjoint kernel and hold
the forward kernel's outputs as well.

- ``check_vjp``: elementwise |got - want| <= rtol |want| + atol s_e, where
  s_e is the largest |want| entry of env e (at least 1). A cotangent's
  float32 rounding scales with its largest entries: settled Ant states reach
  dq entries of ~200 where a few others of ~1e-2 come out of sums that
  cancel, and there the float32 plain version itself sits more than
  atol = 1e-5 from the float64 answer.
- ``check_against_f64``: the kernel is as close to the float64 answer as
  the float32 plain version is, entry by entry: |got - exact| <=
  2 |plain - exact| + rtol |exact| + floor n_e, with n_e = m_e + 2^-23 s_e
  and m_e the plain version's largest error in env e. This bounds the error
  at the small entries that ``check_vjp``'s per-env atol leaves loose: an
  env's slack is its own float32 noise, not its largest entry. The floor
  is in units of that noise because at a single entry the plain version's
  error may be near 0 by chance while the kernel's, from sums taken in
  another order, is not: on settled Ant states on an H100, with the roles
  of kernel and plain swapped, the rule needs a floor of up to 3.5. On
  Humanoid, whose 27-term sums (Hinv tau, lam qdd^T) carry terms about 100
  times their result, it needs up to 38 with the roles swapped and 44 with
  the kernel in its role (tools/torch_vjp_floor.py, NVIDIA H100):
  ``HUMANOID_FLOOR`` is about twice that. On SNU Humanoid (24-term sums,
  88 contacts, 152 muscles) it needs up to 10.6 with the kernel in its
  role and 22 with the roles swapped over four cases, leaving out one env
  where the kernel took a select's other side, as the rule now does
  itself (below) (tools/torch_vjp_floor.py --env SNUHumanoid, NVIDIA
  H100); in one run of chip_smoke.py a dH entry needed 30: ``SNU_FLOOR``
  is twice that.

  A select (a contact in or out, a guard) whose argument lies within
  float32 rounding of its boundary may be taken on its other side by
  either float32 path, and the answer then jumps (by ~10 in a settled
  contact's dq). Where the kernel alone took it, the plain version's error
  does not cover it. So an env that breaks the rule is set apart, counted
  rather than failed, only where one of its named selects
  (``articulation_lb.SELECTS``: a contact's depth, its normal speed, its
  tangential guard, its friction cone, a muscle segment's guard) has its
  argument within ``SELECT_ULPS`` float32 units of its boundary
  (``articulation_lb.select_margins``, passed as ``margins``). The message
  names the select, the env and the margin. A fault elsewhere in an env
  whose selects all lie far from their boundaries fails.
- ``check_kernel``: the float64 rule, and the distance to the float32
  plain version reported, not enforced: where the two float32 results
  differ by more than ``check_vjp`` allows, the float64 answer decides.
- ``check_env_distribution``: a whole Humanoid env step (47 substeps of
  stiff contacts) is chaotic in float32, and entry by entry neither float32
  path holds to float64; its error is held per env, as a distribution over
  the envs.
"""

from __future__ import annotations

import os
import re
import time

import numpy as np
import torch

from .sim.articulation_lb import SELECT_ULPS

# default floor of check_against_f64, in units of the plain version's
# largest error in each env (twice the 3.5 that float32 noise needs)
F64_FLOOR = 8.0
# the floor for Humanoid's kernels (about twice the 44 its float32 noise
# needs)
HUMANOID_FLOOR = 90.0
# the floor for SNU Humanoid's kernels (twice the 30 its float32 noise
# needed)
SNU_FLOOR = 60.0
# where a failed check leaves its witness (relative to the repository)
WITNESS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "witness")


def f64_floor(name: str) -> float:
    """The floor of check_against_f64 for the kernels of env ``name``."""
    return {"Humanoid": HUMANOID_FLOOR,
            "SNUHumanoid": SNU_FLOOR}.get(name, F64_FLOOR)


def env_scale(x: torch.Tensor) -> torch.Tensor:
    """Largest |x| entry of each env (the last axis), at least 1: [..., E]
    -> [E]."""
    return x.abs().reshape(-1, x.shape[-1]).amax(0).clamp(min=1.0)


def nearest_select(margins, env: int):
    """(name, float32 units) of env ``env``'s select nearest its boundary
    in ``margins`` (articulation_lb.select_margins)."""
    name = min(margins, key=lambda k: float(margins[k][env]))
    return name, float(margins[name][env])


def substep_witness(model_name, kind, output, args):
    """A check's ``witness``: the substep arguments ``args`` = (model, q,
    qd, ja, ma, dt, H, Hinv[, gq, gqd]) under their names, with the env's
    registry name, the kernel ("substep_forward" or "substep_vjp") and the
    index of the output checked."""
    keys = ("q", "qd", "ja", "ma", "dt", "H", "Hinv", "gq", "gqd")
    return dict(zip(keys, args[1:]), model=model_name, kind=kind,
                output=output)


def save_witness(name, entries, got, want, plain, witness):
    """Writes one env's inputs and its entries that are off as one .npz
    under WITNESS_DIR; returns its path. ``witness`` maps the inputs'
    names to env-minor tensors (their last axis the env; None for absent
    ones) and holds "model", "kind", "output" and "dt"
    (``substep_witness``); ``entries`` are the off entries' indices, all in
    one env."""
    env = int(entries[0][-1])
    arrays = {"check": np.array(name), "env": np.array(env)}
    for k, v in witness.items():
        if isinstance(v, torch.Tensor):
            arrays[k] = v[..., env].detach().cpu().numpy()
        elif v is not None:
            arrays[k] = np.array(v)
    arrays["entries"] = np.array([i[:-1] for i in entries], np.int64
                                 ).reshape(len(entries), -1)
    for k, t in (("got", got), ("want", want), ("plain", plain)):
        if t is not None:
            arrays[k] = np.array([float(t[tuple(i)]) for i in entries])
    os.makedirs(WITNESS_DIR, exist_ok=True)
    stem = re.sub(r"[^A-Za-z0-9_.-]+", "_", name)[:80]
    path = os.path.join(WITNESS_DIR, f"{stem}-{time.time_ns()}.npz")
    np.savez(path, **arrays)
    return path


def _first_bad(name, bad, got, want, plain=None, witness=None,
               margins=None):
    idx = torch.nonzero(bad)[0].tolist()
    envs = int(bad.reshape(-1, bad.shape[-1]).any(0).sum())
    also = "" if plain is None else f" plain {plain[tuple(idx)].item()}"
    near = ""
    if margins is not None:
        sel, units = nearest_select(margins, idx[-1])
        near = (f"; its select nearest its boundary: {sel} at "
                f"{units:.3g} float32 units")
    saved = ""
    if witness is not None:
        entries = [i + [idx[-1]]
                   for i in torch.nonzero(bad[..., idx[-1]]).tolist()]
        saved = "; witness " + save_witness(name, entries, got, want, plain,
                                            witness)
    return AssertionError(
        f"{name}: {int(bad.sum())} entries off in {envs} envs, first "
        f"{idx} (env {idx[-1]}): got {got[tuple(idx)].item()} want "
        f"{want[tuple(idx)].item()}{also}{near}{saved}")


def check_vjp(name, got, want, rtol, atol, witness=None):
    """Raises unless |got - want| <= rtol |want| + atol s_e everywhere
    (env-minor [..., E] tensors), leaving a witness of the first failing
    env when ``witness`` holds its inputs (``save_witness``). Returns max
    |got - want|."""
    err = (got - want).abs()
    bad = err > rtol * want.abs() + atol * env_scale(want)
    if bool(bad.any()):
        raise _first_bad(name, bad, got, want, witness=witness)
    return float(err.max())


def check_against_f64(name, got, plain, exact, rtol, atol,
                      floor=F64_FLOOR, margins=None, witness=None,
                      apart=None):
    """Raises unless |got - exact| <= 2 |plain - exact| + rtol |exact| +
    floor n_e at every entry, ``exact`` being the plain version run in
    float64 and n_e the plain version's largest error in env e plus 2^-23
    of the env's largest entry. An env that breaks this while one of its
    selects lies within SELECT_ULPS float32 units of its boundary
    (``margins``, articulation_lb.select_margins) is at that boundary:
    counted, not failed, and named in ``apart`` (a list) when given. A
    failure names the first failing env's nearest select and leaves a
    witness of that env when ``witness`` holds its inputs. Returns
    (entries outside rtol |exact| + atol for the kernel and for the plain
    version, their max errors, the least floor that would pass in the envs
    not at a boundary, and how many envs are)."""
    e_k = (got.double() - exact).abs()
    e_p = (plain.double() - exact).abs()
    noise = (e_p.reshape(-1, e_p.shape[-1]).amax(0)
             + 2.0 ** -23 * env_scale(exact))
    ratio = (e_k - 2.0 * e_p - rtol * exact.abs()) / noise
    bad = ratio > floor
    boundary = torch.zeros_like(noise, dtype=torch.bool)
    if margins is not None and bool(bad.any()):
        least = torch.stack(list(margins.values())).amin(0)
        boundary = (bad.reshape(-1, noise.numel()).any(0)
                    & (least.to(noise.device) <= SELECT_ULPS))
        bad &= ~boundary
        if apart is not None:
            for e in torch.nonzero(boundary)[:, 0].tolist():
                sel, units = nearest_select(margins, e)
                apart.append(f"{name} env {e}: {sel} at {units:.3g} "
                             f"float32 units")
    need = float(ratio.masked_fill(boundary, 0.0).max().clamp(min=0.0))
    if bool(bad.any()):
        raise _first_bad(f"{name} vs float64 (floor {floor:g} needs "
                         f"{need:.3e}; {int(boundary.sum())} envs at a "
                         f"select's boundary)", bad, got.double(), exact,
                         plain, witness, margins)
    tol = rtol * exact.abs() + atol
    return (int((e_k > tol).sum()), int((e_p > tol).sum()),
            float(e_k.max()), float(e_p.max()), need, int(boundary.sum()))


def check_kernel(name, got, plain, exact, rtol, atol, floor=F64_FLOOR,
                 margins=None, witness=None, apart=None):
    """The kernel against float64 by ``check_against_f64`` (which holds it
    to the float32 plain version's own error), reporting how far it is from
    the float32 plain version. Raises on the float64 rule only: where the
    two float32 results differ by more than ``check_vjp``'s bound, the
    float64 answer decides, and settled states give such entries for the
    plain version's sake as well as for the kernel's (sums that cancel, a
    contact select taken on the other side). Returns (max |got - plain|,
    entries outside check_vjp's bound, check_against_f64's tuple)."""
    f64 = check_against_f64(name, got, plain, exact, rtol, atol, floor,
                            margins, witness, apart)
    err = (got - plain).abs()
    off = err > rtol * plain.abs() + atol * env_scale(plain)
    return float(err.max()), int(off.sum()), f64


def env_errors(got, exact):
    """Each env's largest |got - exact| over its largest |exact| entry (at
    least 1): [..., E] -> [E]."""
    err = (got.double() - exact).abs().reshape(-1, exact.shape[-1]).amax(0)
    return err / env_scale(exact)


def check_env_distribution(name, got, plain, exact, factor=2.0,
                           quantiles=(0.5, 0.9)):
    """For outputs of many substeps whose float32 rounding takes contact
    selects on either side (an env step of Humanoid: 47 substeps of stiff
    contacts, where both float32 paths sit up to 10 or more from float64 at
    a few entries, not always in the same envs): the kernel path's error
    per env (``env_errors``) is, at each quantile over the envs, at most
    ``factor`` times the plain path's plus 2^-23. A fault that touches
    most envs moves the median; the tail of chaotic envs is left out.
    Returns {q: (kernel, plain)}."""
    e_k, e_p = env_errors(got, exact), env_errors(plain, exact)
    out = {}
    for q in quantiles:
        k, p = float(torch.quantile(e_k, q)), float(torch.quantile(e_p, q))
        if k > factor * p + 2.0 ** -23:
            raise AssertionError(
                f"{name}: the kernel path's error per env at quantile {q} "
                f"is {k:.3e}, the plain path's {p:.3e}")
        out[q] = (k, p)
    return out


def check_repeatable(model, q, qd, joint_act, muscle_act, dt, gen):
    """Runs the plain refresh substep, the cached substep (at the refresh's
    output) and both their VJPs (cotangents drawn from ``gen``) twice on
    the same env-minor inputs and raises unless every output has the same
    bits both times: the plain version sums in a fixed order on every
    device. Returns how many tensors were compared."""
    from .sim.articulation_lb import (refresh_substep_lb, substep_lb,
                                      substep_vjp_lb)

    ins = [t for t in (q, qd, joint_act, muscle_act) if t is not None]

    def run(cot):
        leaves = [t.detach().requires_grad_() for t in ins]
        ma = leaves[3] if muscle_act is not None else None
        with torch.enable_grad():
            q1, qd1, H, Hinv = refresh_substep_lb(model, *leaves[:3], ma,
                                                  dt)
            if cot is None:
                cot = [torch.randn(t.shape, generator=gen, device=t.device)
                       for t in (q1, qd1, H)]
            refresh_vjp = torch.autograd.grad((q1, qd1, H), leaves, cot)
        cached = (model, q1.detach(), qd1.detach(), joint_act, muscle_act,
                  dt, H.detach(), Hinv)
        outs = ((q1, qd1, H, Hinv) + refresh_vjp + substep_lb(*cached)
                + tuple(t for t in substep_vjp_lb(*cached, *cot[:2])
                        if t is not None))
        return [t.detach() for t in outs], cot

    first, cot = run(None)
    again, _ = run(cot)
    for i, (a, b) in enumerate(zip(first, again)):
        if not torch.equal(a, b):
            raise AssertionError(
                f"the plain path's output {i} differs between two runs on "
                f"the same inputs at {int((a != b).sum())} entries")
    return len(first)
