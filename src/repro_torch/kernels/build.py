"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, compiled by
``nvcc`` into a shared library and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. Libraries are built at first use from
the sources in the checkout into ``build/repro_torch_kernels/`` at the repo
root, named by a hash of the source and the flags so that an edited source
is never served a stale library. A missing ``nvcc`` raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v") + ARCH_FLAGS


@dataclasses.dataclass
class BuiltKernel:
    """A loaded kernel library and what its build printed."""
    name: str
    lib: ctypes.CDLL
    path: Path
    ptxas_log: str            # nvcc -Xptxas -v: registers, shared memory, spills
    build_s: float            # 0.0 when the library was already built


_LOADED: Dict[str, BuiltKernel] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ at first use and need the "
        "CUDA toolkit")


def load(name: str) -> BuiltKernel:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.
    Thread-safe per name, so several kernels can be built in parallel."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = out.with_suffix(".log")
    t0 = time.perf_counter()
    build_s = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} (rc {proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)                   # atomic: no half-written library
        build_s = time.perf_counter() - t0
    built = BuiltKernel(name=name, lib=ctypes.CDLL(str(out)), path=out,
                        ptxas_log=log_path.read_text() if log_path.exists() else "",
                        build_s=build_s)
    with _LOCK:
        return _LOADED.setdefault(name, built)
