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
  ``HUMANOID_FLOOR`` is about twice that.
- ``check_kernel``: the float64 rule, and the distance to the float32
  plain version reported, not enforced: where the two float32 results
  differ by more than ``check_vjp`` allows, the float64 answer decides.
- ``check_env_distribution``: a whole Humanoid env step (47 substeps of
  stiff contacts) is chaotic in float32, and entry by entry neither float32
  path holds to float64; its error is held per env, as a distribution over
  the envs.
"""

from __future__ import annotations

import torch

# default floor of check_against_f64, in units of the plain version's
# largest error in each env (twice the 3.5 that float32 noise needs)
F64_FLOOR = 8.0
# the floor for Humanoid's kernels (about twice the 44 its float32 noise
# needs)
HUMANOID_FLOOR = 90.0


def env_scale(x: torch.Tensor) -> torch.Tensor:
    """Largest |x| entry of each env (the last axis), at least 1: [..., E]
    -> [E]."""
    return x.abs().reshape(-1, x.shape[-1]).amax(0).clamp(min=1.0)


def _first_bad(name, bad, got, want):
    idx = torch.nonzero(bad)[0].tolist()
    return AssertionError(
        f"{name}: {int(bad.sum())} entries off, first {idx}: got "
        f"{got[tuple(idx)].item()} want {want[tuple(idx)].item()}")


def check_vjp(name, got, want, rtol, atol):
    """Raises unless |got - want| <= rtol |want| + atol s_e everywhere
    (env-minor [..., E] tensors). Returns max |got - want|."""
    err = (got - want).abs()
    bad = err > rtol * want.abs() + atol * env_scale(want)
    if bool(bad.any()):
        raise _first_bad(name, bad, got, want)
    return float(err.max())


def check_against_f64(name, got, plain, exact, rtol, atol,
                      floor=F64_FLOOR):
    """Raises unless |got - exact| <= 2 |plain - exact| + rtol |exact| +
    floor n_e at every entry, ``exact`` being the plain version run in
    float64 and n_e the
    plain version's largest error in env e plus 2^-23 of the env's largest
    entry. Returns (entries outside rtol |exact| + atol for the kernel and
    for the plain version, their max errors, and the least floor that would
    pass)."""
    e_k = (got.double() - exact).abs()
    e_p = (plain.double() - exact).abs()
    noise = (e_p.reshape(-1, e_p.shape[-1]).amax(0)
             + 2.0 ** -23 * env_scale(exact))
    slack = e_k - 2.0 * e_p - rtol * exact.abs()
    bad = slack > floor * noise
    need = float((slack / noise).max().clamp(min=0.0))
    if bool(bad.any()):
        raise _first_bad(f"{name} vs float64 (floor {floor:g} needs "
                         f"{need:.3e})", bad, got.double(), exact)
    tol = rtol * exact.abs() + atol
    return (int((e_k > tol).sum()), int((e_p > tol).sum()),
            float(e_k.max()), float(e_p.max()), need)


def check_kernel(name, got, plain, exact, rtol, atol, floor=F64_FLOOR):
    """The kernel against float64 by ``check_against_f64`` (which holds it
    to the float32 plain version's own error), reporting how far it is from
    the float32 plain version. Raises on the float64 rule only: where the
    two float32 results differ by more than ``check_vjp``'s bound, the
    float64 answer decides, and settled states give such entries for the
    plain version's sake as well as for the kernel's (sums that cancel, a
    contact select taken on the other side). Returns (max |got - plain|,
    entries outside check_vjp's bound, check_against_f64's tuple)."""
    f64 = check_against_f64(name, got, plain, exact, rtol, atol, floor)
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
