"""Articulated-body dynamics per env and the coupled articulation + particle
engine with its remat backward (port of diffrl_tpu/sim/articulation.py).

The articulated physics has one implementation in the port: the stages of
sim/articulation_lb.py (_fk, _id, _contacts, _muscles, _tau, _integrate,
_mass_matrix_em), which work on env-minor tensors ([..., E]) with the links
in the plan's level-major order. The public functions here take a leading
env axis, as JAX's vmap gives them ([E, C] coordinates, [E, L, 7]
transforms, [E, D, 6] motion subspaces, [E, P, 3] particles), and transpose
and reorder into and out of the stages at the boundary.

``simulate`` advances blocks of one refresh substep (which rebuilds and
inverts the mass matrix) and (mass_matrix_freq - 1) cached substeps over
articulations and particles, with soft contacts coupling the two. Its
backward is autograd through ``torch.utils.checkpoint`` (JAX's remat): each
substep, or each group of ``remat_granularity`` cached substeps, keeps only
its inputs and is recomputed in the backward; or, for articulations alone
with ``backward="manual"``, the hand-written reverse pass of JAX's
``_simulate_manual`` (``_SimulateManual``). The cached substeps reuse
the refresh's inverse with the frozen-factor gradient (the solve's H takes
adj_H = -lam x^T; articulation_lb._SolveFrozenInv).
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops import (spatial_transform_inertia, spatial_transform_twist,
                   transform_inverse)
from . import articulation_lb as lb
from . import particles as part
from .model import Model, State


def _plan(model: Model, like: torch.Tensor) -> "lb._Plan":
    return lb._plan_for(model, like.device, like.dtype)


_ROWS: "weakref.WeakKeyDictionary[lb._Plan, tuple]" = (
    weakref.WeakKeyDictionary())


def _rows(plan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(proc row of each link, link of each proc row, chunk-dof of each
    canonical dof) as device index tensors of the plan."""
    t = _ROWS.get(plan)
    if t is None:
        dev = plan.X_pj.device
        t = _ROWS[plan] = tuple(
            torch.as_tensor(np.asarray(a, np.int64), device=dev)
            for a in (plan.row_of, plan.order, plan.dof_perm))
    return t


def _to_canon(plan, x):
    """Proc-order env-minor [L, k, E] -> canonical env-leading [E, L, k]."""
    return x.index_select(0, _rows(plan)[0]).permute(2, 0, 1)


def _to_proc(plan, x):
    """Canonical env-leading [E, L, k] -> proc-order env-minor [L, k, E]."""
    return x.permute(1, 2, 0).index_select(0, _rows(plan)[1])


def _S_canon(plan, S_chunks, E):
    """Per-group motion subspaces -> [E, D, 6] in canonical dof order."""
    parts = [S.reshape(-1, 6, E) for S in S_chunks if S.shape[1]]
    if not parts:
        return S_chunks[0].new_zeros((E, 0, 6))
    return torch.cat(parts, dim=0)[plan.inv_dof_perm_t].permute(2, 0, 1)


def _S_chunks(plan, S_s):
    """[E, D, 6] canonical -> the stages' per-group chunks [n, cd, 6, E]."""
    S_all = S_s.permute(1, 2, 0).index_select(0, _rows(plan)[2])
    chunks, at = [], 0
    for g in plan.groups:
        n, cd = g.stop - g.start, lb._N_DOFS[g.jtype]
        chunks.append(S_all[at:at + n * cd].reshape(n, cd, 6, -1))
        at += n * cd
    return chunks


# --------------------------------------------------------------------------
# the per-env public API (leading env axis)
# --------------------------------------------------------------------------


def eval_fk(model: Model, joint_q):
    """Forward kinematics: body transforms (X_sc, X_sm), [E, L, 7] each."""
    plan = _plan(model, joint_q)
    X_sc, X_sm = lb._fk(plan, joint_q.T)
    return _to_canon(plan, X_sc), _to_canon(plan, X_sm)


def eval_id(model: Model, joint_q, joint_qd, body_X_sc, body_X_sm):
    """Velocity/bias-force sweep. Returns (S_s [E, D, 6], v_s [E, L, 6],
    body_f [E, L, 6]); body_f = I a + v x* I v - gravity wrench."""
    plan = _plan(model, joint_q)
    S_chunks, v_s, body_f = lb._id(plan, joint_q.T, joint_qd.T,
                                   _to_proc(plan, body_X_sc),
                                   _to_proc(plan, body_X_sm))
    return (_S_canon(plan, S_chunks, joint_q.shape[0]),
            _to_canon(plan, v_s), _to_canon(plan, body_f))


def eval_spatial_inertias(model: Model, body_X_sm):
    """Space-frame spatial inertias I_s [E, L, 6, 6]."""
    I_m = torch.as_tensor(np.asarray(model.body_I_m, np.float32),
                          device=body_X_sm.device).to(body_X_sm.dtype)
    return spatial_transform_inertia(body_X_sm, I_m)


def eval_ground_contacts(model: Model, body_X_sc, body_v_s):
    """Articulated-body ground contacts: penalty normal + damping + smooth
    Coulomb friction, as per-link wrenches [E, L, 6]."""
    if not model.ground:
        return body_X_sc.new_zeros(body_X_sc.shape[:2] + (6,))
    plan = _plan(model, body_X_sc)
    return _to_canon(plan, lb._contacts(plan, _to_proc(plan, body_X_sc),
                                        _to_proc(plan, body_v_s)))


def eval_muscles(model: Model, body_X_sc, muscle_activation):
    """MTU muscle wrenches [E, L, 6]; muscle_activation [E, M] is each
    muscle's force magnitude."""
    plan = _plan(model, body_X_sc)
    return _to_canon(plan, lb._muscles(plan, _to_proc(plan, body_X_sc),
                                       muscle_activation.T))


def eval_tau(model: Model, joint_q, joint_qd, joint_act, S_s, body_f):
    """Leaf-to-root force accumulation and joint-space torques [E, D]."""
    plan = _plan(model, joint_q)
    return lb._tau(plan, joint_q.T, joint_qd.T, joint_act.T,
                   _S_chunks(plan, S_s), _to_proc(plan, body_f)).T


def eval_mass_matrix(model: Model, S_s, I_s):
    """Composite-rigid-body mass matrix H = J^T blockdiag(I_s) J [E, D, D],
    the Jacobian's structure a static ancestor mask."""
    mask = torch.as_tensor(model.topology.ancestor_dof_mask(),
                           device=S_s.device).to(S_s.dtype)
    J = torch.einsum("...df,ld->...lfd", S_s, mask)
    P = torch.einsum("...lfg,...lgd->...lfd", I_s, J)
    return torch.einsum("...lfd,...lfe->...de", J, P)


def _symmetric(blocks, like, D):
    """[E, D, D] from {(d, e): [E] value} of the upper triangle (d <= e),
    mirrored; zero elsewhere."""
    zero = like.new_zeros(like.shape[:-2])
    return torch.stack([torch.stack([
        blocks.get((min(i, j), max(i, j)), zero) for j in range(D)], -1)
        for i in range(D)], -2)


def eval_mass_matrix_factored(model: Model, S_s, body_X_sm):
    """H [E, D, D] without the space-frame inertias or the Jacobian (the
    JAX package's factored form): per link, each ancestor dof's twist in
    the link's mass frame u = Ad(X_sm^-1) S_d and
    H[d, e] = sum over links of u_d^T I_m u_e. The same values as
    eval_mass_matrix(model, S_s, eval_spatial_inertias(model, body_X_sm))
    up to float reassociation. S_s [E, D, 6], body_X_sm [E, L, 7]."""
    topo = model.topology
    mask = np.asarray(topo.ancestor_dof_mask())
    I_m = np.asarray(model.body_I_m, np.float32)
    blocks = {}
    for l in range(topo.link_count):
        dofs = [d for d in range(topo.dof_count) if mask[l, d]]
        if not dofs:
            continue
        t_inv = transform_inverse(body_X_sm[..., l, :])
        I3 = torch.as_tensor(I_m[l, 0:3, 0:3], device=S_s.device).to(
            S_s.dtype)
        us = [spatial_transform_twist(t_inv, S_s[..., d, :]) for d in dofs]
        vs = [torch.cat([u[..., 0:3] @ I3.T, float(I_m[l, 3, 3])
                         * u[..., 3:6]], dim=-1) for u in us]
        for a, d in enumerate(dofs):
            for b in range(a, len(dofs)):
                val = torch.sum(us[a] * vs[b], dim=-1)
                key = (d, dofs[b])
                blocks[key] = val if key not in blocks else blocks[key] + val
    return _symmetric(blocks, S_s, topo.dof_count)


def eval_mass_matrix_crba(model: Model, S_s, body_X_sm):
    """H [E, D, D] by the composite-rigid-body algorithm (the JAX
    package's eval_mass_matrix_crba): the links' space-frame inertias
    summed leaf to root into composite inertias I^c, then for each dof d
    of link l the force F_d = I^c_l S_d and H[d, e] = F_d . S_e for the
    dofs e <= d on l's path to the root. The same values as
    eval_mass_matrix up to float reassociation."""
    topo = model.topology
    mask = np.asarray(topo.ancestor_dof_mask())
    L, D = topo.link_count, topo.dof_count
    I_s = eval_spatial_inertias(model, body_X_sm)
    Ic = [I_s[..., l, :, :] for l in range(L)]
    for l in reversed(range(L)):
        parent = topo.joint_parent[l]
        if parent >= 0:
            Ic[parent] = Ic[parent] + Ic[l]
    starts = list(topo.joint_qd_start[:L]) + [D]
    blocks = {}
    for l in range(L):
        for d in range(starts[l], starts[l + 1]):
            F = torch.einsum("...ij,...j->...i", Ic[l], S_s[..., d, :])
            for e in range(d + 1):
                if mask[l, e]:
                    blocks[e, d] = torch.sum(F * S_s[..., e, :], dim=-1)
    return _symmetric(blocks, S_s, D)


class DynamicsAux(NamedTuple):
    """Derived quantities exposed for observation, rendering and testing."""

    body_X_sc: torch.Tensor
    body_X_sm: torch.Tensor
    body_v_s: torch.Tensor
    joint_tau: torch.Tensor
    joint_qdd: torch.Tensor


def _articulation(plan, model, q, qd, ja, ma, dt, HL, soft=None):
    """One articulation substep on the stages, env-minor (q [C, E], qd/ja
    [D, E], ma [M, E] | None, HL (H, Hinv) [D, D, E] | None). ``soft(X_sc,
    v_s)`` adds external wrenches [L, 6, E] before the torques. Returns
    (q', qd', (H, Hinv), (X_sc, X_sm, v_s, tau, qdd)) with the links in
    proc order."""
    X_sc, X_sm = lb._fk(plan, q)
    S_chunks, v_s, body_f = lb._id(plan, q, qd, X_sc, X_sm)
    if model.ground:
        body_f = body_f + lb._contacts(plan, X_sc, v_s)
    if ma is not None and ma.shape[0]:
        body_f = body_f + lb._muscles(plan, X_sc, ma)
    if soft is not None:
        body_f = body_f + soft(X_sc, v_s)
    tau = lb._tau(plan, q, qd, ja, S_chunks, body_f)
    if HL is None:
        HL = lb._mass_matrix_em(plan, X_sm, S_chunks)
    qdd = lb._solve_frozen_inv(HL[0], HL[1], tau)
    q_new, qd_new = lb._integrate(plan, q, qd, qdd, dt)
    return q_new, qd_new, HL, (X_sc, X_sm, v_s, tau, qdd)


def articulation_substep(model: Model, joint_q, joint_qd, joint_act,
                         muscle_act, dt, mass_cache=None, return_aux=False,
                         body_f_ext=None):
    """One dynamics substep of the articulation for every env.

    joint_q [E, C], joint_qd/joint_act [E, D], muscle_act [E, M] | None.
    mass_cache: (H, Hinv) [E, D, D] of an earlier factorization to reuse
    (the value comes from Hinv, the gradient goes to H); None rebuilds it.
    body_f_ext: external per-link wrenches [E, L, 6] (e.g. soft contacts).
    Returns (joint_q', joint_qd', (H, Hinv)[, DynamicsAux]).
    """
    plan = _plan(model, joint_q)
    HL = (None if mass_cache is None
          else tuple(m.permute(1, 2, 0) for m in mass_cache))
    soft = (None if body_f_ext is None
            else (lambda X_sc, v_s: _to_proc(plan, body_f_ext)))
    q, qd, HL, (X_sc, X_sm, v_s, tau, qdd) = _articulation(
        plan, model, joint_q.T, joint_qd.T, joint_act.T,
        None if muscle_act is None else muscle_act.T, dt, HL, soft)
    HL = tuple(m.permute(2, 0, 1) for m in HL)
    if return_aux:
        aux = DynamicsAux(_to_canon(plan, X_sc), _to_canon(plan, X_sm),
                          _to_canon(plan, v_s), tau.T, qdd.T)
        return q.T, qd.T, HL, aux
    return q.T, qd.T, HL


def _coupled(model, q, qd, px, pv, ja, ma, dt, HL):
    """One semi-implicit substep over both families: joint state env-minor
    (q [C, E], qd/ja [D, E], ma [M, E] | None, HL [D, D, E] | None),
    particles env-leading [E, P, 3] | None. Returns (q', qd', px', pv',
    HL); HL is None without links."""
    has_particles = px is not None
    couple = has_particles and model.shape_body is not None

    pf = part.particle_forces(model, px, pv) if has_particles else None
    if model.link_count:
        plan = _plan(model, q)
        soft = None
        if couple:
            def soft(X_sc, v_s):
                nonlocal pf
                f, bf = part.eval_soft_contacts(
                    model, px, pv, _to_canon(plan, X_sc),
                    _to_canon(plan, v_s))
                pf = pf + f
                return _to_proc(plan, bf)
        q, qd, HL, _ = _articulation(plan, model, q, qd, ja, ma, dt, HL,
                                     soft)
    elif couple:
        # static shapes (body == -1) still collide with particles
        pf = pf + part.eval_soft_contacts(model, px, pv)[0]

    if has_particles:
        c = part._consts(model, px)
        px, pv = part.integrate_particles(px, pv, pf, c.inv_mass, c.gravity,
                                          dt)
    return q, qd, px, pv, HL


def coupled_substep(model: Model, state: State, joint_act, muscle_act, dt,
                    mass_cache=None):
    """One semi-implicit substep over the articulation and the particles
    with particle <-> rigid soft-contact coupling, for every env.

    As in the JAX package, soft contacts see the CURRENT substep's body
    transforms (the reference feeds the previous substep's cached
    transforms, an artifact of its state double-buffering). state holds
    env-leading tensors; mass_cache (H, Hinv) [E, D, D] | None. Returns
    (State', (H, Hinv) [E, D, D] | None)."""
    HL = (None if mass_cache is None
          else tuple(m.permute(1, 2, 0) for m in mass_cache))
    q, qd, px, pv, HL = _coupled(
        model, state.joint_q.T, state.joint_qd.T, state.particle_q,
        state.particle_qd, joint_act.T,
        None if muscle_act is None else muscle_act.T, dt, HL)
    return (State(q.T, qd.T, px, pv),
            None if HL is None else tuple(m.permute(2, 0, 1) for m in HL))


# --------------------------------------------------------------------------
# simulate with the remat backward
# --------------------------------------------------------------------------


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


class _SimulateManual(torch.autograd.Function):
    """simulate with JAX's hand-written reverse pass (``_simulate_manual``,
    diffrl_tpu/sim/articulation.py), articulations only, env-minor.

    The forward runs without a graph and saves each substep's pre-state
    (q, qd) and each block's (H, Hinv). The backward walks the blocks from
    last to first and the cached substeps of each in reverse: each one is
    recomputed from its saved pre-state and its cotangent applied with
    torch.autograd.grad, the cotangent of H summed over the block (Hinv is
    frozen and takes none); then the block's refresh substep is recomputed
    with cotangents on (q1, qd1, H). Gradients reach (q, qd, joint_act,
    muscle_act); the model's arrays are constants."""

    @staticmethod
    def run(model, h, nblocks, mm, q, qd, ja, ma):
        """The forward: (q', qd', the saved pre-states and factors)."""
        plan = _plan(model, q)
        saved = []
        for _ in range(nblocks):
            q0, qd0 = q, qd
            q, qd, HL, _ = _articulation(plan, model, q, qd, ja, ma, h, None)
            saved += [q0, qd0, *HL]
            for _ in range(mm - 1):
                saved += [q, qd]
                q, qd, _, _ = _articulation(plan, model, q, qd, ja, ma, h,
                                            HL)
        return q, qd, saved

    @staticmethod
    def forward(ctx, model, h, nblocks, mm, q, qd, ja, ma):
        q, qd, saved = _SimulateManual.run(model, h, nblocks, mm, q, qd, ja,
                                           ma)
        ctx.model, ctx.h, ctx.nblocks, ctx.mm = model, h, nblocks, mm
        ctx.save_for_backward(ja, ma, *saved)
        return q, qd

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gq, gqd):
        model, h, mm = ctx.model, ctx.h, ctx.mm
        ja, ma, *saved = ctx.saved_tensors
        plan = _plan(model, ja)
        per_block = 4 + 2 * (mm - 1)
        ctrl = [ja] + ([ma] if ma is not None else [])
        gctrl = [torch.zeros_like(x) for x in ctrl]

        def vjp(fn, xs, cots):
            leaves = [x.detach().requires_grad_() for x in xs]
            with torch.enable_grad():
                return torch.autograd.grad(fn(*leaves), leaves, cots)

        def controls(c):
            return c[0], (c[1] if ma is not None else None)

        for b in reversed(range(ctx.nblocks)):
            q0, qd0, H, Hinv, *states = saved[b * per_block:
                                              (b + 1) * per_block]
            gH = torch.zeros_like(H)
            for i in reversed(range(mm - 1)):
                def cached(q, qd, H_, *c):
                    return _articulation(plan, model, q, qd, *controls(c), h,
                                         (H_, Hinv))[:2]
                gq, gqd, dH, *dc = vjp(cached, [states[2 * i],
                                                states[2 * i + 1], H, *ctrl],
                                       (gq, gqd))
                gH = gH + dH
                gctrl = [a + d for a, d in zip(gctrl, dc)]

            def refresh(q, qd, *c):
                q1, qd1, (H1, _), _ = _articulation(plan, model, q, qd,
                                                    *controls(c), h, None)
                return q1, qd1, H1
            gq, gqd, *dc = vjp(refresh, [q0, qd0, *ctrl], (gq, gqd, gH))
            gctrl = [a + d for a, d in zip(gctrl, dc)]
        return (None, None, None, None, gq, gqd, gctrl[0],
                gctrl[1] if ma is not None else None)


def simulate(
    model: Model,
    state: State,
    joint_act=None,
    muscle_act=None,
    dt: float = 1.0 / 60.0,
    substeps: int = 16,
    mass_matrix_freq: int = 1,
    remat: bool = True,
    remat_granularity: int = 1,
    backward: str = "remat",
) -> State:
    """Advance every env one step of ``substeps`` substeps of dt / substeps.

    state holds env-leading tensors (joint_q [E, C], joint_qd [E, D],
    particle_q/qd [E, P, 3] or None); joint_act [E, D] | None, muscle_act
    [E, M] | None. The mass matrix is rebuilt every ``mass_matrix_freq``
    substeps and reused (frozen) in between.

    The backward is autograd. With ``remat`` every substep runs under
    ``torch.utils.checkpoint`` (non-reentrant): the backward keeps only the
    carried state per substep and recomputes each substep with its
    backward; ``remat_granularity`` > 1 groups that many cached substeps
    into one recomputed region. ``backward="manual"`` takes the JAX
    package's hand-written reverse pass (``_SimulateManual``) for
    articulations alone; with particles it takes the remat path, as in the
    JAX package.
    """
    if backward not in ("remat", "manual"):
        raise ValueError(f"unknown backward {backward!r}")
    if substeps % mass_matrix_freq != 0:
        raise ValueError("substeps must be a multiple of mass_matrix_freq")
    if backward == "manual" and state.particle_q is None:
        q, qd = state.joint_q.T, state.joint_qd.T
        ja = (q.new_zeros((model.dof_count, q.shape[-1]))
              if joint_act is None else joint_act.T)
        ma = None if muscle_act is None else muscle_act.T
        args = (model, dt / float(substeps), substeps // mass_matrix_freq,
                mass_matrix_freq, q, qd, ja, ma)
        if _needs_grad(q, qd, ja, ma):
            q, qd = _SimulateManual.apply(*args)
        else:
            with torch.no_grad():
                q, qd, _ = _SimulateManual.run(*args)
        return State(q.T, qd.T, state.particle_q, state.particle_qd)
    n_inner = mass_matrix_freq - 1
    g = max(1, int(remat_granularity))
    if n_inner % g:
        raise ValueError(
            "mass_matrix_freq - 1 must be divisible by remat_granularity")
    h = dt / float(substeps)

    q, qd = state.joint_q.T, state.joint_qd.T
    px, pv = state.particle_q, state.particle_qd
    ja = (q.new_zeros((model.dof_count, q.shape[-1])) if joint_act is None
          else joint_act.T)
    ma = None if muscle_act is None else muscle_act.T
    ckpt = remat and _needs_grad(q, qd, px, pv, ja, ma)

    def refresh(q, qd, px, pv):
        return _coupled(model, q, qd, px, pv, ja, ma, h, None)

    def cached(q, qd, px, pv, H, Hinv):
        HL = None if H is None else (H, Hinv)
        for _ in range(g):
            q, qd, px, pv, _ = _coupled(model, q, qd, px, pv, ja, ma, h, HL)
        return q, qd, px, pv

    def run(fn, *args):
        if ckpt:
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    for _ in range(substeps // mass_matrix_freq):
        q, qd, px, pv, HL = run(refresh, q, qd, px, pv)
        H, Hinv = (None, None) if HL is None else HL
        for _ in range(n_inner // g):
            q, qd, px, pv = run(cached, q, qd, px, pv, H, Hinv)
    return State(q.T, qd.T, px, pv)


def simulate_xpbd(
    model: Model,
    state: State,
    dt: float = 1.0 / 60.0,
    substeps: int = 16,
    remat: bool = True,
) -> State:
    """Advance every env one step with the XPBD position-based integrator
    (particles only), each substep under ``torch.utils.checkpoint`` with
    ``remat``."""
    h = dt / float(substeps)
    px, pv = state.particle_q, state.particle_qd
    ckpt = remat and _needs_grad(px, pv)

    def sub(x, v):
        return part.xpbd_substep(model, x, v, h, relaxation=model.relaxation)

    for _ in range(substeps):
        px, pv = (checkpoint(sub, px, pv, use_reentrant=False,
                              preserve_rng_state=False) if ckpt
                  else sub(px, pv))
    return State(state.joint_q, state.joint_qd, px, pv)
