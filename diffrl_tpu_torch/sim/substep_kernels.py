"""Hand-written Hopper kernels of the cached articulation substep and its
VJP (counterparts of diffrl_tpu/sim/pallas_substep.py).

``substep_forward`` wraps ``diffrl_tpu_torch/csrc/substep_forward.cu``,
which replaces the TPU kernel ``substep_forward_batched``: one cached
substep for the whole batch, a team of threads per env with the env's
intermediates in shared memory. ``substep_vjp`` wraps
``csrc/substep_vjp.cu``, which replaces ``substep_vjp_batched``: the VJP of
that substep with the frozen-factor convention, written by hand as an
adjoint sweep. On a CPU tensor each wrapper runs its kernel's plain
PyTorch version (``articulation_lb.substep_lb`` and ``substep_vjp_lb``); on
a CUDA tensor it launches the kernel or raises. ``substep_forward.launches``
and ``substep_vjp.launches`` count the kernel launches.

Both kernels are specialized to one model topology and share its tables:
sizes, the team size, the level spans and per-link tables go into a
generated header (built at first use by ``_build.py``), the float constants
into one packed device buffer. They
cover free, revolute and prismatic joints and ground contacts; a model with
ball or fixed joints or muscles raises NotImplementedError when a kernel is
prepared.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .. import _build
from .articulation_lb import _plan_for, substep_lb, substep_vjp_lb
from .model import JOINT_FREE, JOINT_PRISMATIC, JOINT_REVOLUTE, Model

_SUPPORTED_JOINTS = (JOINT_FREE, JOINT_PRISMATIC, JOINT_REVOLUTE)
_LINK_STRIDE = 34      # floats per link row in the packed buffer (.cuh)
_CONTACT_STRIDE = 8    # floats per contact
_BLOCK_THREADS = 128   # threads per block of both kernels
_MIN_TEAM = 8          # fewest threads per env (team_layout)
_SMEM_PER_BLOCK = 232448   # shared memory one block may take on sm_90


@dataclass(frozen=True)
class SubstepKernel:
    """One built kernel library (forward or adjoint) for one model on one
    device."""

    name: str                 # "substep_forward" or "substep_vjp"
    built: _build.BuiltLibrary
    consts: torch.Tensor      # packed constant buffer, on the device
    coord_count: int
    dof_count: int


@dataclass(frozen=True)
class TeamLayout:
    """How both kernels spread one model's envs over the card's threads."""

    threads_per_env: int      # T, the lanes of one env's team
    envs_per_block: int
    block_threads: int
    forward_words: int        # floats of shared memory per env in K1
    vjp_words: int            # ... in K2
    const_words: int          # the packed constant buffer, once per block

    def smem_bytes(self, name: str) -> int:
        """Dynamic shared memory per block of kernel ``name``."""
        words = self.forward_words if name == "substep_forward" \
            else self.vjp_words
        return 4 * (self.envs_per_block * words + self.const_words)


def team_layout(model: Model) -> TeamLayout:
    """The team size and the per-env shared-memory slots of both kernels.

    T is the smallest power of two that is at least the widest level of the
    tree and at least 8 (at most 32, one warp), doubled while the adjoint
    kernel's block would not fit the card's shared memory: every link of a
    level has its own lane in the sweeps, and at the main path's 4096 envs
    the card holds at least 1,024 warps. Ant, Humanoid, Hopper and Cheetah
    all get T = 8 and 16 envs per 128-thread block. The lanes of a warp run
    one instruction stream, so a larger team finishes the phases that take
    every link, contact or row at once in fewer rounds, but leaves more
    lanes idle in the level sweeps and, with fewer envs per block, needs
    more blocks. On the H100 (tools/bench_substep_teams.py, PERF.md): on
    Ant T = 4, 8 and 16 came within 10 % of each other and T = 32 took half
    as long again; on Humanoid the adjoint took 94 µs at T = 8, 151 at 16
    and 135 at 32: its 116 KB (T = 16) or 228 KB (T = 8) block fits once
    per SM either way, and 4096 envs make 512 blocks, 4 waves, at T = 16
    against 256, 2 waves, at T = 8. Hopper's 6 dofs once gave T = 4, which
    leaves 3.9 warps per SM at 4096 envs. A slot holds the fields that
    ``csrc/substep_forward.cuh`` (fw::) and ``csrc/substep_vjp.cuh`` (bw::)
    lay out, rounded up to an odd count of floats so that the lanes of a
    warp reading one field of several envs hit different banks; the
    headers check these counts at compile time.
    """
    topo = model.topology
    plan = _plan_for(model, "cpu")
    L, C, D = topo.link_count, topo.coord_count, topo.dof_count
    K = len(plan.contact_rows)
    widest = max((e - s for s, e in plan.levels), default=1)
    fwd = C + 4 * D + D * D + 31 * L + 6 * K
    vjp = fwd + 2 * C + 5 * D + 50 * L + 13 * K
    consts = L * _LINK_STRIDE + 3 + K * _CONTACT_STRIDE
    # the int tables' static shared memory (csrc/substep_forward.cuh Tables)
    nchild = sum(1 for p in topo.joint_parent if p >= 0)
    tables = 4 * (6 * L + 2 * max(K, 1) + max(nchild, 1) + 2
                  + len(plan.levels) + 1)
    T = 1
    while T < 32 and (T < max(widest, _MIN_TEAM) or 4 * (
            _BLOCK_THREADS // T * (vjp | 1) + consts) + tables
            > _SMEM_PER_BLOCK):
        T *= 2
    return TeamLayout(threads_per_env=T,
                      envs_per_block=_BLOCK_THREADS // T,
                      block_threads=_BLOCK_THREADS,
                      forward_words=fwd | 1, vjp_words=vjp | 1,
                      const_words=consts)


def kernel_tables(model: Model):
    """(generated header text, packed constants [n] f32) for ``model``.

    Tables are in the engine plan's processing order (level-major, parents
    before children), with the plan's level spans, each link's children
    (descending rows) and contacts (ascending contact order), and the team
    layout of ``team_layout``. Raises NotImplementedError for features the
    kernel lacks.
    """
    topo = model.topology
    if topo.muscle_count:
        raise NotImplementedError(
            "the substep CUDA kernels have no muscles yet")
    jtype = np.asarray(topo.joint_type, np.int64)
    bad = sorted(set(jtype.tolist()) - set(_SUPPORTED_JOINTS))
    if bad:
        raise NotImplementedError(
            f"the substep CUDA kernels support free, revolute and "
            f"prismatic joints; this model has joint types {bad}")
    plan = _plan_for(model, "cpu")
    order = plan.order
    L = topo.link_count
    qs = np.asarray(topo.joint_q_start, np.int64)[order]
    ds = np.asarray(topo.joint_qd_start, np.int64)[order]
    parent = np.where(plan.parent_row == L, -1, plan.parent_row)
    K = len(plan.contact_rows)

    f32 = np.float32
    links = np.zeros((L, _LINK_STRIDE), f32)
    links[:, 0:7] = np.asarray(model.joint_X_pj, f32)[order]
    links[:, 7:14] = np.asarray(model.joint_X_cm, f32)[order]
    links[:, 14:17] = np.asarray(model.joint_axis, f32)[order]
    I_m = np.asarray(model.body_I_m, f32)[order]
    links[:, 17:26] = I_m[:, 0:3, 0:3].reshape(L, 9)
    links[:, 26] = I_m[:, 3, 3]
    links[:, 27] = np.asarray(model.joint_target_ke, f32)[order]
    links[:, 28] = np.asarray(model.joint_target_kd, f32)[order]
    links[:, 29] = np.asarray(model.joint_limit_ke, f32)[order]
    links[:, 30] = np.asarray(model.joint_limit_kd, f32)[order]
    scalar = np.isin(jtype[order], (JOINT_PRISMATIC, JOINT_REVOLUTE))
    for col, arr in ((31, model.joint_target), (32, model.joint_limit_lower),
                     (33, model.joint_limit_upper)):
        links[:, col] = np.where(scalar, np.asarray(arr, f32)[
            np.where(scalar, qs, 0)], 0.0)
    contacts = np.zeros((K, _CONTACT_STRIDE), f32)
    if K:
        contacts[:, 0:3] = np.asarray(model.contact_point, f32)
        contacts[:, 3] = np.asarray(model.contact_dist, f32)
        contacts[:, 4:8] = np.asarray(model.contact_mat, f32)
    consts = np.concatenate([
        links.ravel(), np.asarray(model.gravity, f32).reshape(3),
        contacts.ravel()])

    def table(xs):
        return "{" + ", ".join(str(int(x)) for x in xs) + "}" if len(xs) \
            else "{0}"

    children = [[c for c in range(L - 1, -1, -1) if parent[c] == r]
                for r in range(L)]
    link_contacts = [np.nonzero(plan.contact_rows == r)[0] for r in range(L)]
    layout = team_layout(model)

    header = "\n".join([
        "// generated by diffrl_tpu_torch/sim/substep_kernels.py",
        "#pragma once",
        f"#define DRL_NL {L}",
        f"#define DRL_NC {topo.coord_count}",
        f"#define DRL_ND {topo.dof_count}",
        f"#define DRL_NK {K}",
        f"#define DRL_TYPE {table(jtype[order])}",
        f"#define DRL_PARENT {table(parent)}",
        f"#define DRL_QSTART {table(qs)}",
        f"#define DRL_DSTART {table(ds)}",
        f"#define DRL_CONTACT_ROW {table(plan.contact_rows)}",
        f"#define DRL_NLEV {len(plan.levels)}",
        f"#define DRL_LEVEL_START "
        f"{table([s for s, _ in plan.levels] + [L])}",
        f"#define DRL_CHILD_START "
        f"{table(np.cumsum([0] + [len(c) for c in children]))}",
        f"#define DRL_CHILDREN {table(sum(children, []))}",
        f"#define DRL_LINK_CONTACT_START "
        f"{table(np.cumsum([0] + [len(c) for c in link_contacts]))}",
        f"#define DRL_LINK_CONTACTS "
        f"{table(np.concatenate(link_contacts) if L else [])}",
        f"#define DRL_NCHILD {sum(map(len, children))}",
        f"#define DRL_T {layout.threads_per_env}",
        f"#define DRL_BLOCK_THREADS {layout.block_threads}",
        f"#define DRL_FWD_ENV_WORDS {layout.forward_words}",
        f"#define DRL_VJP_ENV_WORDS {layout.vjp_words}",
        "",
    ])
    return header, consts


def kernel_source(model: Model, name: str = "substep_forward"
                  ) -> _build.KernelSource:
    """The library ``name`` ("substep_forward" or "substep_vjp") for
    ``model``: both kernels share the generated topology header and the
    packed constant buffer."""
    if name not in _POINTER_ARGS:
        raise ValueError(f"no kernel named {name!r}")
    header, _ = kernel_tables(model)
    return _build.KernelSource(
        name=name, source=f"{name}.cu",
        headers={"substep_topology.h": header})


# pointer arguments of each library's C launch function, before (E, dt,
# stream): substep_forward (q, qd, joint_act, hinv, consts, q_out, qd_out),
# substep_vjp (q, qd, joint_act, hinv, gq, gqd, consts, dq, dqd, djoint_act,
# dh)
_POINTER_ARGS = {"substep_forward": 7, "substep_vjp": 11}

# one built kernel per (Model object, kernel, device); a Model is immutable
# and hashed by identity
_KERNELS: "weakref.WeakKeyDictionary[Model, Dict[tuple, SubstepKernel]]" = (
    weakref.WeakKeyDictionary())


def _prepare(name: str, model: Model, device,
             built: Optional[_build.BuiltLibrary]) -> SubstepKernel:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on CUDA, not {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    per_model = _KERNELS.setdefault(model, {})
    k = per_model.get((name, device))
    if k is not None:
        return k
    header, consts = kernel_tables(model)
    if built is None:
        built = _build.build(kernel_source(model, name))
    lib = built.lib
    launch = getattr(lib, f"drl_{name}")
    launch.argtypes = [ctypes.c_void_p] * _POINTER_ARGS[name] + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    count = getattr(lib, f"drl_{name}_const_count")
    count.argtypes = []
    count.restype = ctypes.c_int
    attrs = getattr(lib, f"drl_{name}_attributes")
    attrs.argtypes = [ctypes.POINTER(ctypes.c_int)]
    attrs.restype = ctypes.c_int
    if count() != consts.size:
        raise RuntimeError(f"{name} expects {count()} constants, the model "
                           f"packs {consts.size}")
    k = per_model[(name, device)] = SubstepKernel(
        name=name, built=built,
        consts=torch.as_tensor(consts, device=device),
        coord_count=model.coord_count, dof_count=model.dof_count)
    return k


def prepare_substep_forward(model: Model, device,
                            built: Optional[_build.BuiltLibrary] = None
                            ) -> SubstepKernel:
    """Build (at first use) and load the forward kernel for ``model`` on a
    CUDA ``device``. ``built`` passes in a library from
    ``_build.build_all``."""
    return _prepare("substep_forward", model, device, built)


def prepare_substep_vjp(model: Model, device,
                        built: Optional[_build.BuiltLibrary] = None
                        ) -> SubstepKernel:
    """Build (at first use) and load the adjoint kernel for ``model`` on a
    CUDA ``device``."""
    return _prepare("substep_vjp", model, device, built)


@dataclass(frozen=True)
class KernelAttributes:
    """What the card reports for one loaded kernel."""

    registers: int            # per thread
    local_bytes: int          # spill + stack per thread
    threads_per_env: int
    envs_per_block: int
    smem_bytes: int           # dynamic shared memory per block
    max_blocks_per_sm: int    # cudaOccupancyMaxActiveBlocksPerMultiprocessor
    sm_count: int

    def resident(self, E: int):
        """(blocks, warps) resident per SM, on average over the card's SMs,
        in a launch over E envs: the grid's blocks spread over the SMs, at
        most ``max_blocks_per_sm`` each."""
        grid = -(-E // self.envs_per_block)
        blocks = min(float(self.max_blocks_per_sm), grid / self.sm_count)
        warps = blocks * self.envs_per_block * self.threads_per_env / 32
        return blocks, warps


def kernel_attributes(k: SubstepKernel) -> KernelAttributes:
    """Registers, local memory, team layout and occupancy of ``k`` as
    loaded on the current device."""
    out = (ctypes.c_int * 7)()
    err = getattr(k.built.lib, f"drl_{k.name}_attributes")(out)
    if err:
        raise RuntimeError(f"{k.name}: attribute query failed: cudaError "
                           f"{err}")
    return KernelAttributes(*out)


def _check(kernel, name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous float32 tensor of "
            f"shape {shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def _kernel_for(name, model, q, muscle_act):
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA, not {q.device}")
    if muscle_act is not None and muscle_act.shape[0]:
        raise NotImplementedError(f"the {name} CUDA kernel has no muscles yet")
    return _prepare(name, model, q.device, None)


def substep_forward(model: Model, q, qd, joint_act, muscle_act, dt, H, Hinv):
    """One cached substep for the whole batch, env-minor.

    q [C, E], qd / joint_act [D, E], muscle_act [M, E] | None,
    H / Hinv [D, D, E] (the frozen factorization of the last refresh
    substep; the forward reads only Hinv). Returns (q' [C, E], qd' [D, E]).
    CPU tensors run the plain version (substep_lb); CUDA tensors launch the
    kernel.
    """
    if q.device.type == "cpu":
        return substep_lb(model, q, qd, joint_act, muscle_act, dt, H, Hinv)
    k = _kernel_for("substep_forward", model, q, muscle_act)
    C, D, E = k.coord_count, k.dof_count, q.shape[-1]
    for name, t, shape in (("q", q, (C, E)), ("qd", qd, (D, E)),
                           ("joint_act", joint_act, (D, E)),
                           ("Hinv", Hinv, (D, D, E))):
        _check("substep_forward", name, t, shape, q.device)
    q_out = torch.empty_like(q)
    qd_out = torch.empty_like(qd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = k.built.lib.drl_substep_forward(
        q.data_ptr(), qd.data_ptr(), joint_act.data_ptr(), Hinv.data_ptr(),
        k.consts.data_ptr(), q_out.data_ptr(), qd_out.data_ptr(),
        int(E), float(dt), stream)
    if err:
        raise RuntimeError(f"substep_forward launch failed: cudaError {err}")
    substep_forward.launches += 1
    return q_out, qd_out


substep_forward.launches = 0


def substep_vjp(model: Model, q, qd, joint_act, muscle_act, dt, H, Hinv,
                gq, gqd):
    """VJP of one cached substep for the whole batch, env-minor.

    Inputs as ``substep_forward`` plus the cotangents gq [C, E], gqd [D, E]
    of its outputs. Returns (dq [C, E], dqd [D, E], djoint_act [D, E],
    dmuscle_act [M, E] | None, dH [D, D, E]) with the frozen-factor
    convention (dH = -lam qdd^T, lam = Hinv adj_qdd; Hinv gets nothing).
    CPU tensors run the plain version (substep_vjp_lb); CUDA tensors launch
    the adjoint kernel, which reads Hinv and not H.
    """
    if q.device.type == "cpu":
        return substep_vjp_lb(model, q, qd, joint_act, muscle_act, dt, H,
                              Hinv, gq, gqd)
    k = _kernel_for("substep_vjp", model, q, muscle_act)
    C, D, E = k.coord_count, k.dof_count, q.shape[-1]
    for name, t, shape in (("q", q, (C, E)), ("qd", qd, (D, E)),
                           ("joint_act", joint_act, (D, E)),
                           ("Hinv", Hinv, (D, D, E)), ("gq", gq, (C, E)),
                           ("gqd", gqd, (D, E))):
        _check("substep_vjp", name, t, shape, q.device)
    dq = torch.empty_like(q)
    dqd = torch.empty_like(qd)
    dja = torch.empty_like(joint_act)
    dH = torch.empty_like(Hinv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = k.built.lib.drl_substep_vjp(
        q.data_ptr(), qd.data_ptr(), joint_act.data_ptr(), Hinv.data_ptr(),
        gq.data_ptr(), gqd.data_ptr(), k.consts.data_ptr(), dq.data_ptr(),
        dqd.data_ptr(), dja.data_ptr(), dH.data_ptr(), int(E), float(dt),
        stream)
    if err:
        raise RuntimeError(f"substep_vjp launch failed: cudaError {err}")
    substep_vjp.launches += 1
    return dq, dqd, dja, None, dH


substep_vjp.launches = 0


def substep_forward_bytes(model: Model, E: int) -> int:
    """Bytes one launch must move: each input read once (q, qd, joint_act,
    Hinv and the constant buffer), each output written once."""
    C, D = model.coord_count, model.dof_count
    _, consts = kernel_tables(model)
    return 4 * (E * (C + 2 * D + D * D + C + D) + consts.size)


# flops of the kernel's primitives, counted from substep_forward.cuh
_CROSS, _DOT3 = 9, 5
_QROT = 3 + 3 + _CROSS + 6 + _DOT3 + 6 + 6           # 38
_QMUL = 28
_TMUL = _QROT + 3 + _QMUL                             # 69
_TINV = _QROT                                         # 38
_TWIST = 2 * _QROT + _CROSS + 3                       # 88
_INERTIA = _TINV + _TWIST + 15 + 3 + _TWIST           # 232
_SCROSS = 3 * _CROSS + 3                              # 30


def substep_forward_flops(model: Model, E: int) -> int:
    """Floating-point operations of one launch, counted primitive by
    primitive from the kernel source (sin, cos, sqrt and divide count 1)."""
    topo = model.topology
    plan = _plan_for(model, "cpu")
    n = 0
    for link in range(topo.link_count):
        t = topo.joint_type[link]
        n += 4 * _TMUL                            # X_local, X_sc, X_sm, X_sj
        n += 2 * _INERTIA + _SCROSS + 3 + _CROSS + 12 + 6 + _SCROSS + 6
        if t == JOINT_REVOLUTE:
            n += 6 + _QROT + _CROSS + 6           # joint, S, v_j
        elif t == JOINT_PRISMATIC:
            n += 3 + _QROT + 6                    # joint, S (no cross), v_j
        if t in (JOINT_REVOLUTE, JOINT_PRISMATIC):
            n += 11 + 14                          # S.f and the torque terms
            n += 4                                # integrate
        else:                                     # free
            n += 6 + 6 + _CROSS + 6 + _QMUL + 12 + 12 + 4
        if topo.joint_parent[link] >= 0:
            n += 6                                # subtree sum
    n += len(plan.contact_rows) * (
        _QROT + 3 + 3 + _CROSS + 3 + 1 + 4 + _DOT3 + 1 + 3 + 5 + 3 + 7
        + _CROSS + 6 + 6)
    n += 2 * topo.dof_count ** 2                  # Hinv tau
    return n * E


def substep_vjp_bytes(model: Model, E: int) -> int:
    """Bytes one adjoint launch must move: q, qd, joint_act, Hinv, gq, gqd
    and the constant buffer read once; dq, dqd, djoint_act and dH written
    once (H is not read)."""
    C, D = model.coord_count, model.dof_count
    _, consts = kernel_tables(model)
    return 4 * (E * ((C + 2 * D + D * D + C + D) + (C + 2 * D + D * D))
                + consts.size)


# flops of the adjoint arithmetic alone, counted from substep_vjp.cuh. The
# forward values that the kernel recomputes inside its adjoint (the qrot of
# twist_xform and wrench_xform, tinv and u of inertia_matvec, the X_sm, X_sj
# and X_local frames, Iv, S, the contact point) are the forward's work,
# counted once by substep_forward_flops; the adjoints that the kernel takes
# of constants (X_cm, X_pj, the joint axis, a contact point) are work the
# function does not need. Neither is counted here.
_ADJ_CROSS = 2 * _CROSS + 6                           # 24
_ADJ_QROT_V = 37                                      # cotangent of v
_ADJ_QROT_Q = 31 + 23 + 4                             # cotangent of q: 58
_ADJ_QROT = _ADJ_QROT_V + _ADJ_QROT_Q                 # 95
_ADJ_QMUL_ONE = 4 * 7 + 4                             # one factor: 32
_ADJ_QMUL = 2 * _ADJ_QMUL_ONE                         # 64
_ADJ_QNORMALIZE = 34
_ADJ_TMUL = 3 + _ADJ_QROT + _ADJ_QMUL                 # 162
_ADJ_TMUL_T = 3 + _ADJ_QROT_Q + _ADJ_QMUL_ONE         # u constant: 93
_ADJ_TMUL_U = _ADJ_QROT_V + _ADJ_QMUL_ONE             # t constant: 69
_ADJ_TINV = 3 + _ADJ_QROT + 4                         # 102
_ADJ_TWIST = _ADJ_CROSS + 2 * _ADJ_QROT               # 214, wrench alike
_ADJ_INERTIA = _ADJ_TWIST + 15 + 3 + _ADJ_TWIST + _ADJ_TINV   # 548
_ADJ_SCROSS = 3 * _ADJ_CROSS                          # 72
# wrench, friction, normal force, velocity and point adjoints of one
# contact below the ground
_CONTACT_ADJ = 2 * _ADJ_CROSS + _ADJ_QROT_Q + 65      # 171


def active_contacts(model: Model, q) -> int:
    """Ground contacts below the ground (c < 0) over the batch at joint
    coordinates q [C, E]: the contacts whose adjoint the kernel runs."""
    from .articulation_lb import _fk, _tpoint

    plan = _plan_for(model, q.device, q.dtype)
    if len(plan.contact_rows) == 0:
        return 0
    X_sc, _ = _fk(plan, q)
    p = (_tpoint(X_sc[plan.contact_rows_t], plan.contact_point)
         - plan.ground_normal * plan.contact_dist)
    return int((p[:, 1, :] < 0).sum())


def substep_vjp_flops(model: Model, E: int, n_active: int) -> int:
    """Floating-point operations the adjoint launch's function needs: the
    forward once (substep_forward_flops) and the adjoint arithmetic of the
    reverse sweep, counted primitive by primitive from the kernel source.
    ``n_active`` is the number of (env, contact) pairs below the ground,
    the contacts whose adjoint runs."""
    topo = model.topology
    D = topo.dof_count
    n = 0
    for link in range(topo.link_count):
        t = topo.joint_type[link]
        root = topo.joint_parent[link] < 0
        # wrench adjoint: Ia and Iv adjoints, scross_dual, gravity,
        # X_sm -> X_sc
        n += (2 * _ADJ_INERTIA + _ADJ_SCROSS + _ADJ_CROSS + 3
              + _ADJ_TMUL_T)
        n += _ADJ_SCROSS + (0 if root else 12) + 6  # acc, vel
        if t in (JOINT_REVOLUTE, JOINT_PRISMATIC):
            n += 12 + 12                          # aS, aqd
            n += _ADJ_CROSS if t == JOINT_REVOLUTE else 0
            n += _ADJ_QROT_Q + (0 if root else _ADJ_TMUL_T)  # S, X_sj
            n += 21 + 5                           # torque and integrate
            n += 10 if t == JOINT_REVOLUTE else 6   # joint transform
        else:                                     # free
            n += 6 + 6 + 7                        # aqd, -atau, aq
            n += (_ADJ_QNORMALIZE + 12 + _ADJ_QMUL + 3 + 3 + 3 + _ADJ_CROSS
                  + 7 + 6 + 6)                    # integrate
        if not root:
            n += _ADJ_TMUL + 6                    # X_sc, subtree sum
        n += _ADJ_TMUL_U                          # X_local -> X_jc
    n += 3 * D * D                                # lam = Hinv adj_qdd, dH
    return (substep_forward_flops(model, E) + n * E
            + n_active * _CONTACT_ADJ)
