"""Build hand-written CUDA kernels at first use and load them with ctypes.

Each kernel source under ``diffrl_tpu_torch/csrc/`` exposes a plain C
interface (no PyTorch headers), so one ``nvcc`` call per source builds a
shared library in seconds. Per-model sizes and tables arrive as generated
headers. A build lands in ``build/torch_ext/<name>-<hash>/`` inside the
repository checkout (git-ignored), keyed by the hash of the source files,
the generated headers and the compiler flags, so a second process reuses
it. Nothing here runs at import time; nothing falls back when ``nvcc`` or
the card is missing: the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "torch_ext"

# sm_90a: Hopper with its architecture-specific instructions. No
# --use_fast_math: the contact branches, sqrt and divides stay IEEE.
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


@dataclass(frozen=True)
class BuiltLibrary:
    """A loaded kernel library and what its build reported."""

    name: str
    lib: ctypes.CDLL
    seconds: float           # wall time of the nvcc call; 0.0 when reused
    registers: int           # per thread, from ptxas
    spill_store_bytes: int
    spill_load_bytes: int
    stack_bytes: int


@dataclass(frozen=True)
class KernelSource:
    """One library to build: a .cu file under csrc/ plus generated headers
    (file name -> text) placed in the build directory."""

    name: str
    source: str
    headers: Dict[str, str]


def _nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = []
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from source at first use")


def _build_dir(spec: KernelSource, nvcc: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    for name in sorted(spec.headers):
        h.update(name.encode())
        h.update(spec.headers[name].encode())
    h.update(spec.source.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_ROOT / f"{spec.name}-{h.hexdigest()[:16]}"


_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
    r"(\d+) bytes spill loads")


def _parse_ptxas(log: str):
    regs = [int(m) for m in _PTXAS_REGS.findall(log)]
    spills = [tuple(int(x) for x in m) for m in _PTXAS_SPILL.findall(log)]
    stack, st, ld = (max(s[i] for s in spills) for i in range(3)) if spills \
        else (0, 0, 0)
    return (max(regs) if regs else 0), st, ld, stack


class _PendingBuild:
    def __init__(self, spec: KernelSource, nvcc: str):
        self.spec = spec
        self.dir = _build_dir(spec, nvcc)
        self.lib_path = self.dir / f"lib{spec.name}.so"
        self.log_path = self.dir / "ptxas.log"
        self.proc: Optional[subprocess.Popen] = None
        self.t0 = time.perf_counter()
        if self.lib_path.exists() and self.log_path.exists():
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        for name, text in spec.headers.items():
            (self.dir / name).write_text(text)
        self.tmp = self.dir / f"lib{spec.name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", f"-I{self.dir}",
               "-o", str(self.tmp), str(CSRC / spec.source)]
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(self) -> BuiltLibrary:
        seconds = 0.0
        if self.proc is not None:
            out, _ = self.proc.communicate()
            seconds = time.perf_counter() - self.t0
            if self.proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {self.spec.source} "
                    f"(exit {self.proc.returncode}):\n{out}")
            self.log_path.write_text(out)
            os.replace(self.tmp, self.lib_path)
        log = self.log_path.read_text()
        regs, st, ld, stack = _parse_ptxas(log)
        return BuiltLibrary(
            name=self.spec.name, lib=ctypes.CDLL(str(self.lib_path)),
            seconds=seconds, registers=regs, spill_store_bytes=st,
            spill_load_bytes=ld, stack_bytes=stack)


def build_all(specs: Sequence[KernelSource]) -> Sequence[BuiltLibrary]:
    """Build (or reuse) every library, all nvcc processes started together."""
    nvcc = _nvcc_path()
    pending = []
    try:
        for s in specs:
            pending.append(_PendingBuild(s, nvcc))
        return [p.finish() for p in pending]
    finally:
        for p in pending:  # on failure, stop the builds still running
            if p.proc is not None and p.proc.poll() is None:
                p.proc.kill()
                p.proc.wait()


def build(spec: KernelSource) -> BuiltLibrary:
    return build_all([spec])[0]
