"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, compiled by
``nvcc`` into a shared library and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. Libraries are built at first use from
the sources in the checkout into ``build/repro_torch_kernels/`` at the repo
root, named by a hash of the source and the flags so that an edited source
is never served a stale library. A missing ``nvcc`` raises.

A launch on fake tensors (``torch._subclasses.fake_tensor``: a dry run,
``launch/dryrun.py``) is abstract: the wrapper decides its route and
allocates its outputs as on the card, then ``abstract`` records the
launch's work from the kernel module's cost function and nothing is built,
launched or read. ``as_card`` lets a dry run on a host whose PyTorch has no
CUDA take the card's routes on fake CPU tensors (the CPU stand-in); real
tensors keep their own routes inside it.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

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


# the open launch audits (``analysis/launch_audit.py``): each is called
# with (kernel name, True for the kernel / False for the plain version) at
# every route decision. Process-wide, not per thread: the autograd engine
# runs a CUDA backward (flash dQ and dK/dV, the RWKV backward) on a device
# thread of its own.
AUDITS: List[Callable[[str, bool], None]] = []

# the open cost records (``launch/dryrun.py``): each is called with (kernel
# name, operations, bytes) for every abstract launch
COSTS: List[Callable[[str, float, float], None]] = []

# > 0 while a dry run traces the card's routes on fake CPU tensors
_AS_CARD = [0]


@contextlib.contextmanager
def as_card():
    """Within it, fake tensors on any device take the card's routes: for a
    dry run where PyTorch has no CUDA (its autograd engine needs a CUDA
    device guard for a fake CUDA tensor). Real tensors are not touched.
    Process-wide, as ``AUDITS``."""
    _AS_CARD[0] += 1
    try:
        yield
    finally:
        _AS_CARD[0] -= 1


def on_card(where) -> bool:
    """Whether work on ``where`` (a tensor, or a device) takes the card's
    routes: a CUDA device, or a fake tensor inside ``as_card``."""
    if isinstance(where, torch.Tensor):
        return where.device.type == "cuda" or (_AS_CARD[0] > 0 and is_fake(where))
    return torch.device(where).type == "cuda"


def placement(name: str, *tensors) -> bool:
    """True for the kernel (all CUDA, one device), False for the plain
    version (all CPU); anything else raises. Fake tensors inside
    ``as_card`` take the kernel. Not counted: see ``route``."""
    if _AS_CARD[0] and tensors and all(is_fake(t) for t in tensors):
        return True
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{name} runs on CUDA or CPU tensors on one device, got "
                     f"{sorted(str(t.device) for t in tensors)}")


def route(name: str, *tensors) -> bool:
    """``placement``, counted: every wrapper calls it once for each launch
    of kernel ``name`` (or each call of its plain version), so that the
    launch audit counts where the route is decided."""
    on_kernel = placement(name, *tensors)
    for audit in AUDITS:
        audit(name, on_kernel)
    return on_kernel


def abstract(name: str, cost: Callable[[], Tuple[int, int]], operand) -> bool:
    """True when kernel ``name``'s launch is abstract (``operand`` is a fake
    tensor): ``cost()`` → (operations, bytes) goes to the open cost records
    and the wrapper returns its outputs unlaunched. False on real tensors,
    where ``cost`` is not called."""
    if not is_fake(operand):
        return False
    flops, nbytes = cost()
    for record in COSTS:
        record(name, flops, nbytes)
    return True


def check_kernel_operands(**tensors) -> None:
    """What the float32 kernels take: float32, contiguous."""
    for arg, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{arg} must be float32 (got {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")


def call(fn, what: str, device, pointers, args) -> None:
    """Call the C entry point ``fn`` with the tensors' device pointers (None
    → a null pointer), then ``args``, then the current CUDA stream of
    ``device``; a nonzero cudaError it returns raises."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[0 if t is None else t.data_ptr() for t in pointers], *args, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


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
    t0 = time.perf_counter()  # lint: allow build seconds, off the step path
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
        build_s = time.perf_counter() - t0  # lint: allow build seconds
    built = BuiltKernel(name=name, lib=ctypes.CDLL(str(out)), path=out,
                        ptxas_log=log_path.read_text() if log_path.exists() else "",
                        build_s=build_s)
    with _LOCK:
        return _LOADED.setdefault(name, built)
