#!/usr/bin/env python3
"""Replays a failed kernel check's witness on the CPU.

    python3 tools/replay_witness.py build/witness/<check>-<ns>.npz [--no-jax]

A check of diffrl_tpu_torch/testing.py given a ``witness`` (the kernel
checks of chip_smoke.py and tests/test_torch_cuda.py) saves, when it fails,
the failing env's inputs (q, qd, ja, ma, H, Hinv and for the adjoint gq,
gqd), the model's name, the kernel (``kind``), the output's index, dt and
the entries that were off with the kernel's, the reference's and the plain
version's values. This reruns that one env (E = 1) on the CPU through the
port's plain version in float32 and in float64 and, where the JAX package
is importable and the model is one of its envs (MJCF, URDF or SNU), through
JAX's plain version (``diffrl_tpu.sim.articulation_lb.substep_lb`` and its
``jax.vjp``), and prints each off entry beside those answers and the env's
selects nearest their boundaries (articulation_lb.select_margins).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffrl_tpu_torch import envs  # noqa: E402
from diffrl_tpu_torch.sim import articulation_lb as lb  # noqa: E402

INPUTS = ("q", "qd", "ja", "ma", "H", "Hinv")
COTANGENTS = ("gq", "gqd")


def _inputs(w, dtype):
    """The witness's inputs as env-minor tensors with one env (None where
    absent)."""
    return {k: torch.as_tensor(w[k], dtype=dtype)[..., None]
            if k in w else None for k in INPUTS + COTANGENTS}


def _port(model, kind, x, dt):
    args = (model, x["q"], x["qd"], x["ja"], x["ma"], dt, x["H"], x["Hinv"])
    if kind == "substep_forward":
        return lb.substep_lb(*args)
    return lb.substep_vjp_lb(*args, x["gq"], x["gqd"])


def _jax(name, kind, x, dt):
    """JAX's plain version at the witness's float32 inputs; None where JAX
    or the env is missing."""
    try:
        import jax
        import diffrl_tpu.envs as jenvs
        from diffrl_tpu.sim import articulation_lb as jlb
    except ImportError:
        return None
    jax.config.update("jax_platforms", "cpu")
    model = jenvs.make(name, num_envs=1).model
    a = {k: None if v is None else v.numpy() for k, v in x.items()}
    fixed = (a["Hinv"],)

    def fwd(q, qd, ja, ma, H):
        return jlb.substep_lb(model, q, qd, ja, ma, dt, H, *fixed)

    if kind == "substep_forward":
        return [np.asarray(t) for t in jax.jit(fwd)(
            a["q"], a["qd"], a["ja"], a["ma"], a["H"])]
    out, vjp = jax.vjp(fwd, a["q"], a["qd"], a["ja"], a["ma"], a["H"])
    dq, dqd, dja, dma, dH = vjp((a["gq"], a["gqd"]))
    return [np.asarray(t) if t is not None else None
            for t in (dq, dqd, dja, dma, dH)]


def replay(path, use_jax=True):
    """Reruns the witness at ``path``. Returns a dict: the model, kind,
    output index, off entries (indices within the env), the saved values
    (got, want, plain) and the replayed ones (plain32, plain64, jax or
    None), each at the off entries, and the env's select margins."""
    w = dict(np.load(path))
    name, kind = str(w["model"]), str(w["kind"])
    out_i, dt = int(w["output"]), float(w["dt"])
    model = envs.make(name, num_envs=1, device="cpu").model
    x32, x64 = _inputs(w, torch.float32), _inputs(w, torch.float64)
    entries = [tuple(int(j) for j in e) for e in w["entries"]]

    def at(t):
        return np.array([float(t[(*e, 0)]) for e in entries])

    res = {"model": name, "kind": kind, "output": out_i, "entries": entries,
           "got": w.get("got"), "want": w.get("want"),
           "plain": w.get("plain"),
           "plain32": at(_port(model, kind, x32, dt)[out_i]),
           "plain64": at(_port(model, kind, x64, dt)[out_i]), "jax": None}
    if use_jax:
        j = _jax(name, kind, x32, dt)
        if j is not None and j[out_i] is not None:
            res["jax"] = at(j[out_i])
    res["margins"] = {k: float(v[0]) for k, v in lb.select_margins(
        model, x64["q"], x64["qd"]).items()}
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("witness")
    parser.add_argument("--no-jax", action="store_true")
    args = parser.parse_args(argv)
    r = replay(args.witness, use_jax=not args.no_jax)
    print(f"{r['model']} {r['kind']} output {r['output']}: "
          f"{len(r['entries'])} entries off")
    cols = [k for k in ("got", "want", "plain", "plain32", "plain64", "jax")
            if r[k] is not None]
    print("entry " + " ".join(f"{c:>16}" for c in cols))
    for i, e in enumerate(r["entries"]):
        print(f"{e} " + " ".join(f"{float(r[c][i]):16.9g}" for c in cols))
    for k, v in sorted(r["margins"].items(), key=lambda kv: kv[1]):
        print(f"select {k}: {v:.4g} float32 units from its boundary")
    return 0


if __name__ == "__main__":
    sys.exit(main())
