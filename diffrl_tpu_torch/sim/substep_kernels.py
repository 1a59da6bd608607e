"""Hand-written Hopper kernel of the cached articulation substep
(counterpart of diffrl_tpu/sim/pallas_substep.py).

``substep_forward`` is the wrapper of the kernel in
``diffrl_tpu_torch/csrc/substep_forward.cu``, which replaces the TPU kernel
``substep_forward_batched`` (pallas_substep.py): one cached substep for the
whole batch, one CUDA thread per env. On a CPU tensor the wrapper runs the
kernel's plain PyTorch version, ``articulation_lb.substep_lb``; on a CUDA
tensor it launches the kernel or raises. ``substep_forward.launches``
counts the kernel launches.

The kernel is specialized to one model topology: sizes and per-link tables
go into a generated header (built at first use by ``_build.py``), the float
constants into one packed device buffer. It covers free, revolute and
prismatic joints and ground contacts; a model with ball or fixed joints or
muscles raises NotImplementedError when the kernel is prepared.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .. import _build
from .articulation_lb import _plan_for, substep_lb
from .model import JOINT_FREE, JOINT_PRISMATIC, JOINT_REVOLUTE, Model

SOURCE = "substep_forward.cu"
_SUPPORTED_JOINTS = (JOINT_FREE, JOINT_PRISMATIC, JOINT_REVOLUTE)
_LINK_STRIDE = 34      # floats per link row in the packed buffer (.cuh)
_CONTACT_STRIDE = 8    # floats per contact


@dataclass(frozen=True)
class SubstepForwardKernel:
    """The built kernel for one model on one device."""

    built: _build.BuiltLibrary
    consts: torch.Tensor      # packed constant buffer, on the device
    coord_count: int
    dof_count: int


def kernel_tables(model: Model):
    """(generated header text, packed constants [n] f32) for ``model``.

    Tables are in the engine plan's processing order (level-major, parents
    before children). Raises NotImplementedError for features the kernel
    lacks.
    """
    topo = model.topology
    if topo.muscle_count:
        raise NotImplementedError(
            "the substep_forward CUDA kernel has no muscles yet")
    jtype = np.asarray(topo.joint_type, np.int64)
    bad = sorted(set(jtype.tolist()) - set(_SUPPORTED_JOINTS))
    if bad:
        raise NotImplementedError(
            f"the substep_forward CUDA kernel supports free, revolute and "
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
        "",
    ])
    return header, consts


def kernel_source(model: Model) -> _build.KernelSource:
    header, _ = kernel_tables(model)
    return _build.KernelSource(
        name="substep_forward", source=SOURCE,
        headers={"substep_topology.h": header})


# one built kernel per (Model object, device); a Model is immutable and
# hashed by identity
_KERNELS: "weakref.WeakKeyDictionary[Model, Dict[torch.device, SubstepForwardKernel]]" = (
    weakref.WeakKeyDictionary())


def prepare_substep_forward(model: Model, device,
                            built: Optional[_build.BuiltLibrary] = None
                            ) -> SubstepForwardKernel:
    """Build (at first use) and load the kernel for ``model`` on a CUDA
    ``device``. ``built`` passes in a library from ``_build.build_all``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the substep_forward kernel runs on CUDA, not "
                         f"{device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    per_model = _KERNELS.setdefault(model, {})
    k = per_model.get(device)
    if k is not None:
        return k
    header, consts = kernel_tables(model)
    if built is None:
        built = _build.build(kernel_source(model))
    lib = built.lib
    lib.drl_substep_forward.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.drl_substep_forward.restype = ctypes.c_int
    lib.drl_substep_forward_const_count.argtypes = []
    lib.drl_substep_forward_const_count.restype = ctypes.c_int
    lib.drl_substep_forward_attributes.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.drl_substep_forward_attributes.restype = ctypes.c_int
    expect = lib.drl_substep_forward_const_count()
    if expect != consts.size:
        raise RuntimeError(f"kernel expects {expect} constants, the model "
                           f"packs {consts.size}")
    k = per_model[device] = SubstepForwardKernel(
        built=built,
        consts=torch.as_tensor(consts, device=device),
        coord_count=model.coord_count, dof_count=model.dof_count)
    return k


def kernel_attributes(k: SubstepForwardKernel):
    """(registers per thread, local bytes per thread) as loaded on the card."""
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = k.built.lib.drl_substep_forward_attributes(
        ctypes.byref(regs), ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
    return regs.value, local.value


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"substep_forward: {name} must be a contiguous float32 tensor of "
            f"shape {shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


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
    if q.device.type != "cuda":
        raise ValueError(f"substep_forward runs on CPU or CUDA, not "
                         f"{q.device}")
    if muscle_act is not None and muscle_act.shape[0]:
        raise NotImplementedError(
            "the substep_forward CUDA kernel has no muscles yet")
    k = prepare_substep_forward(model, q.device)
    C, D, E = k.coord_count, k.dof_count, q.shape[-1]
    for name, t, shape in (("q", q, (C, E)), ("qd", qd, (D, E)),
                           ("joint_act", joint_act, (D, E)),
                           ("Hinv", Hinv, (D, D, E))):
        _check(name, t, shape, q.device)
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
        if t in (JOINT_REVOLUTE, JOINT_PRISMATIC):
            n += 6 + _QROT + _CROSS + 6           # joint, S, v_j
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
