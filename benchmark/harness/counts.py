"""Floating-point operations and bytes of the work, counted from the
model's topology and the networks' sizes: the yardstick of the kernels'
roofline shares and of the whole step's share of the card's peak.

``substep_forward_*`` and ``substep_vjp_*`` are frozen copies of the port's
counts for its kernels K1 and K2 (``sim/substep_kernels.py``), applied to
the reference's model; the refresh, the networks, the observations and
Adam are counted here. Every count is of the work the function needs, the
same whatever implements it: the step counts each substep's forward once,
each reverse once, and no recomputation."""

from __future__ import annotations

from ..reference.articulation import _fk, _plan_for, _tpoint
from ..reference.model import (JOINT_BALL, JOINT_FIXED, JOINT_FREE,
                               JOINT_PRISMATIC, JOINT_REVOLUTE)

#: NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_FLOPS_FP32 = 67e12          # float32 outside the tensor cores
PEAK_BYTES = 3.35e12             # HBM3

_LINK_STRIDE, _CONTACT_STRIDE = 34, 8


def _const_words(model) -> int:
    plan = _plan_for(model, "cpu")
    return (model.topology.link_count * _LINK_STRIDE + 3
            + len(plan.contact_rows) * _CONTACT_STRIDE + 6 * len(plan.seg_m))


def substep_forward_bytes(model, E: int) -> int:
    C, D = model.coord_count, model.dof_count
    M = model.topology.muscle_count
    return 4 * (E * (C + 2 * D + M + D * D + C + D) + _const_words(model))


_CROSS, _DOT3 = 9, 5
_QROT = 3 + 3 + _CROSS + 6 + _DOT3 + 6 + 6
_QMUL = 28
_TMUL = _QROT + 3 + _QMUL
_TINV = _QROT
_TWIST = 2 * _QROT + _CROSS + 3
_INERTIA = _TINV + _TWIST + 15 + 3 + _TWIST
_SCROSS = 3 * _CROSS + 3
_SEGMENT = 2 * (_QROT + 3) + 3 + 5 + 2 + 3 + 3 + 2 * (_CROSS + 6)


def substep_forward_flops(model, E: int) -> int:
    topo = model.topology
    plan = _plan_for(model, "cpu")
    n = 0
    for link in range(topo.link_count):
        t = topo.joint_type[link]
        n += 4 * _TMUL
        n += 2 * _INERTIA + _SCROSS + 3 + _CROSS + 12 + 6 + _SCROSS + 6
        if t == JOINT_REVOLUTE:
            n += 6 + _QROT + _CROSS + 6
        elif t == JOINT_PRISMATIC:
            n += 3 + _QROT + 6
        if t in (JOINT_REVOLUTE, JOINT_PRISMATIC):
            n += 11 + 14
            n += 4
        elif t == JOINT_BALL:
            n += 3 * (_QROT + _CROSS) + 30
            n += 3 * (11 + 5)
            n += 6 + _QMUL + 12 + 12
        elif t == JOINT_FREE:
            n += 6 + 6 + _CROSS + 6 + _QMUL + 12 + 12 + 4
        if topo.joint_parent[link] >= 0:
            n += 6
    n += len(plan.contact_rows) * (
        _QROT + 3 + 3 + _CROSS + 3 + 1 + 4 + _DOT3 + 1 + 3 + 5 + 3 + 7
        + _CROSS + 6 + 6)
    n += len(plan.seg_m) * _SEGMENT
    n += 2 * topo.dof_count ** 2
    return n * E


def substep_vjp_bytes(model, E: int) -> int:
    C, D = model.coord_count, model.dof_count
    M = model.topology.muscle_count
    return 4 * (E * ((C + 2 * D + M + D * D + C + D)
                     + (C + 2 * D + M + D * D)) + _const_words(model))


_ADJ_CROSS = 2 * _CROSS + 6
_ADJ_QROT_V = 37
_ADJ_QROT_Q = 31 + 23 + 4
_ADJ_QROT = _ADJ_QROT_V + _ADJ_QROT_Q
_ADJ_QMUL_ONE = 4 * 7 + 4
_ADJ_QMUL = 2 * _ADJ_QMUL_ONE
_ADJ_QNORMALIZE = 34
_ADJ_TMUL = 3 + _ADJ_QROT + _ADJ_QMUL
_ADJ_TMUL_T = 3 + _ADJ_QROT_Q + _ADJ_QMUL_ONE
_ADJ_TMUL_U = _ADJ_QROT_V + _ADJ_QMUL_ONE
_ADJ_TINV = 3 + _ADJ_QROT + 4
_ADJ_TWIST = _ADJ_CROSS + 2 * _ADJ_QROT
_ADJ_INERTIA = _ADJ_TWIST + 15 + 3 + _ADJ_TWIST + _ADJ_TINV
_ADJ_SCROSS = 3 * _ADJ_CROSS
_CONTACT_ADJ = 2 * _ADJ_CROSS + _ADJ_QROT_Q + 65
_MUSCLE_ADJ = 27 + 3 + 19 + 24 + 2 * (3 + _ADJ_QROT_Q) + 9


def active_contacts(model, q) -> int:
    """(env, contact) pairs below the ground at joint coordinates q
    [C, E]: the contacts whose adjoint K2 runs."""
    plan = _plan_for(model, q.device, q.dtype)
    if len(plan.contact_rows) == 0:
        return 0
    X_sc, _ = _fk(plan, q)
    p = (_tpoint(X_sc[plan.contact_rows_t], plan.contact_point)
         - plan.ground_normal * plan.contact_dist)
    return int((p[:, 1, :] < 0).sum())


def substep_vjp_flops(model, E: int, n_active: int) -> int:
    """K2's function: the forward once and the adjoint arithmetic."""
    return substep_forward_flops(model, E) + adjoint_flops(model, E,
                                                           n_active)


def adjoint_flops(model, E: int, n_active: int) -> int:
    """The adjoint arithmetic of one cached substep, without its forward."""
    topo = model.topology
    D = topo.dof_count
    n = 0
    for link in range(topo.link_count):
        t = topo.joint_type[link]
        root = topo.joint_parent[link] < 0
        n += (2 * _ADJ_INERTIA + _ADJ_SCROSS + _ADJ_CROSS + 3
              + _ADJ_TMUL_T)
        n += _ADJ_SCROSS + (0 if root else 12) + 6
        if t in (JOINT_REVOLUTE, JOINT_PRISMATIC):
            n += 12 + 12
            n += _ADJ_CROSS if t == JOINT_REVOLUTE else 0
            n += _ADJ_QROT_Q + (0 if root else _ADJ_TMUL_T)
            n += 21 + 5
            n += 10 if t == JOINT_REVOLUTE else 6
        elif t == JOINT_BALL:
            n += 3 * (12 + 12 + _ADJ_CROSS + _ADJ_QROT_Q)
            n += 0 if root else _ADJ_TMUL_T
            n += 3 * 23
            n += _ADJ_QNORMALIZE + 12 + _ADJ_QMUL + 6
            n += 4
        elif t == JOINT_FREE:
            n += 6 + 6 + 7
            n += (_ADJ_QNORMALIZE + 12 + _ADJ_QMUL + 3 + 3 + 3 + _ADJ_CROSS
                  + 7 + 6 + 6)
        if not root:
            n += _ADJ_TMUL + 6
        if t != JOINT_FIXED:
            n += _ADJ_TMUL_U
    n += len(_plan_for(model, "cpu").seg_m) * _MUSCLE_ADJ
    n += 3 * D * D
    return n * E + n_active * _CONTACT_ADJ


# -- the refresh substep ---------------------------------------------------------

def refresh_flops(model, E: int) -> int:
    """One refresh substep: the cached substep's dynamics (forward
    kinematics, inverse dynamics, contacts, the torques, the solve and the
    integration) plus the composite-rigid-body mass matrix and its
    inverse: each link's spatial inertia in world axes (two 6 x 6 products,
    432 flops), the subtree sums (36 per child link), U = I^C S and the
    entries S^T U of every ancestor pair (11 each), and the Cholesky
    factor, its triangular inverse and their product (D^3 in all)."""
    topo = model.topology
    D = topo.dof_count
    mask, link = topo.ancestor_dof_mask(), topo.dof_link()
    pairs = sum(1 for i in range(D) for j in range(D)
                if mask[link[j], i] or mask[link[i], j])
    n = (topo.link_count * 432
         + sum(36 for p in topo.joint_parent if p >= 0)
         + D * 72 + pairs * 11 + D ** 3)
    return substep_forward_flops(model, E) + n * E


# -- the env and the networks ----------------------------------------------------

#: the free-base observation (torso frame, heading, up vector: a quaternion
#: product, two rotations, a cross product, a normalize) and the reward, per
#: env, counted from envs/locomotion.py and envs/{ant,humanoid}.py; the
#: reset's start state (a product and a normalize) beside them
OBS_REWARD_FLOPS = 28 + 2 * 38 + 9 + 3 + 12 + 5 + 20
RESET_FLOPS = 28 + 12 + 30


def mlp_flops(dims, rows: int, layer_norm: bool) -> int:
    """Forward flops of an MLP over ``rows`` rows: 2 in x out per layer and
    the bias, and per hidden unit the activation (4) and, with it, the
    LayerNorm (8)."""
    n = 0
    for i in range(len(dims) - 1):
        n += (2 * dims[i] + 1) * dims[i + 1]
        if i < len(dims) - 2:
            n += dims[i + 1] * (4 + (8 if layer_norm else 0))
    return n * rows


def adam_flops(params: int) -> int:
    """One Adam step with the clip: moments, bias corrections, the update
    and the norm (16 per parameter)."""
    return 16 * params


# -- one epoch -------------------------------------------------------------------

def _dims(section, key, obs, out, default):
    units = section.get("network", {}).get(key, {}).get("units", default)
    return [obs] + list(units) + [out]


def _params(dims) -> int:
    return sum((dims[i] + 1) * dims[i + 1] for i in range(len(dims) - 1))


def _sim_forward(model, E, substeps, mm):
    blocks = substeps // mm
    return (blocks * refresh_flops(model, E)
            + (substeps - blocks) * substep_forward_flops(model, E))


def shac_epoch_flops(model, cfg, facts, E, n_active_per_launch):
    """One SHAC epoch: the window's simulator forward and reverse (each
    refresh's reverse counted as twice its forward), observations and
    rewards forward and reverse, the actor forward and backward, the
    target critic's two forwards and their input cotangents per step, the
    critic's minibatch steps, and the Adam steps."""
    p = cfg["params"]
    c, env = p["config"], p["diff_env"]
    H, S, mm = c["steps_num"], facts["sim_substeps"], env[
        "MM_caching_frequency"]
    obs, act = facts["num_obs"], facts["num_acts"]
    actor = _dims(p, "actor_mlp", obs, act, [64, 64])
    critic = _dims(p, "critic_mlp", obs, 1, [64, 64])
    blocks = S // mm
    sim = H * (_sim_forward(model, E, S, mm)
               + blocks * 2 * refresh_flops(model, E)
               + (S - blocks) * adjoint_flops(model, E, n_active_per_launch))
    rows = H * E
    iters, nb = c.get("critic_iterations", 16), c.get("num_batch", 4)
    return (sim + 3 * rows * (OBS_REWARD_FLOPS + RESET_FLOPS)
            + 3 * mlp_flops(actor, rows, True)
            + 4 * mlp_flops(critic, rows, True)
            + iters * 3 * mlp_flops(critic, rows, True)
            + adam_flops(_params(actor)) + iters * nb * adam_flops(
                _params(critic)))


def ppo_epoch_flops(model, cfg, facts, E, n_active_per_launch=0):
    """One PPO epoch: the rollout's simulator forward, observations and
    rewards, the network's forward at every step and on the last
    observation, and every minibatch's forward, backward and Adam step."""
    p = cfg["params"]
    c, env = p["config"], p["diff_env"]
    H, S, mm = c["steps_num"], facts["sim_substeps"], env[
        "MM_caching_frequency"]
    obs, act = facts["num_obs"], facts["num_acts"]
    units = p["network"]["mlp"]["units"]
    trunk = [obs] + list(units)
    heads = [units[-1], act + 1]
    net = (mlp_flops(trunk, 1, False) + 4 * units[-1]
           + mlp_flops(heads, 1, False))
    rows = H * E
    mini = c.get("mini_epochs", 5)
    steps = mini * rows // min(c.get("minibatch_size", rows), rows)
    params = _params(trunk) + _params(heads)
    return (H * _sim_forward(model, E, S, mm)
            + rows * (OBS_REWARD_FLOPS + RESET_FLOPS)
            + (rows + E) * net + mini * 3 * rows * net
            + steps * adam_flops(params))


EPOCH_FLOPS = {"shac": shac_epoch_flops, "ppo": ppo_epoch_flops}
