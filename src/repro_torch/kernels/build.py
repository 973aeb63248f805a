"""Build plumbing shared by the hand-written Hopper kernels.

Every kernel of the port is CUDA C++ under ``repro_torch/csrc``, compiled
with ``nvcc`` into a shared library with a plain C interface (one per
``.cu`` source) and loaded with ``ctypes`` (no PyTorch headers: a build
takes seconds, not minutes).  Builds go to the checkout's ``build/``, so a
run writes nothing outside its checkout.

Everything here runs at a kernel's first launch, never at import: the CPU
tests import every module on hosts that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
# <checkout>/build — listed in .gitignore
BUILD_DIR = PACKAGE_DIR.parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()                       # guards _source_locks
_source_locks: Dict[str, threading.Lock] = {}  # one build at a time per source
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report per source (registers, shared memory, spills)
BUILD_LOGS: Dict[str, str] = {}


class LaunchCounter:
    """Launches of one kernel since the last reset.  The kernel's wrapper
    adds one where it launches and nowhere else, so a run can show that
    its main path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def load_cuda_library(source_name: str) -> ctypes.CDLL:
    """Compile ``csrc/<source_name>`` for sm_90a (once per content of the
    source and the shared headers) and return the loaded library.
    Different sources may build concurrently from several threads."""
    with _lock:
        lock = _source_locks.setdefault(source_name, threading.Lock())
    with lock:
        lib = _libs.get(source_name)
        if lib is not None:
            return lib
        src = CSRC_DIR / source_name
        h = hashlib.sha256(src.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        digest = h.hexdigest()[:12]
        out = BUILD_DIR / f"{src.stem}_{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
            BUILD_LOGS[source_name] = proc.stdout + proc.stderr
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _libs[source_name] = lib
        return lib

