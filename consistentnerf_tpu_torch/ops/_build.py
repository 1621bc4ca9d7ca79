"""Build and load the port's hand-written CUDA kernels.

Each `csrc/*.cu` source exposes a plain C interface. It is compiled with
`nvcc` for Hopper (`sm_90a`) into a shared library under
`build/torch_kernels/` at the repository root, at first use, and loaded
with `ctypes`. The library name carries a hash of the source and flags,
and of every `csrc/*.cuh` header, so an edited source rebuilds and a stale
library is never loaded. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    data = src.read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        data += header.read_bytes()
    digest = hashlib.sha1(data + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile csrc/{name}.cu unless its library is already built.

    The compiler's `-Xptxas -v` report (registers, shared memory, spills)
    is kept beside the library as `.log`."""
    return build_all([name])[0]


def build_all(names: Sequence[str]) -> list:
    """Compile the named sources that are not built yet, one `nvcc` per
    source, all started together; returns their library paths."""
    outs = [library_path(name) for name in names]
    procs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu ({proc.returncode}):"
                          f"\n{stdout}\n{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def build_log(name: str) -> str:
    """The ptxas report of the built library (empty if it was not built
    by this checkout's build step)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/{name}.cu; cached per process."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
