"""Builds the port's CUDA sources with ``nvcc`` and loads them with ctypes.

Each ``csrc/*.cu`` file exposes a plain C interface and compiles on its own
into ``build/torch_kernels/lib<name>_<hash>.so`` at the root of the
checkout. The hash is of every file under ``csrc/`` (sources and the
headers they include) and the flags, so an edit to any of them rebuilds.
Building happens at the first CUDA use, never at import; nothing here
falls back to anything when ``nvcc`` is missing or the build fails.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, Sequence

_OPS_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_OPS_DIR, "csrc")
# <checkout>/build/torch_kernels, beside the package
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_OPS_DIR)), "build",
                         "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("cluster", "lsap")


@dataclass
class BuildResult:
    name: str
    path: str
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's output, ptxas register/spill report included


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _library_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, fname), "rb") as fh:
            digest.update(fname.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def _start(name: str):
    out = _library_path(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    return out, (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))


def build(names: Sequence[str] = SOURCES) -> Dict[str, BuildResult]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together. Raises if any build fails."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in names}
    results = {}
    for name, (out, job) in started.items():
        if job is None:
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        tmp, proc = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        results[name] = BuildResult(name, out, time.perf_counter() - t0, log)
    return results


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built first if needed)."""
    return ctypes.CDLL(build([name])[name].path)
