"""Build and load the port's CUDA kernels (``csrc/``) on first use.

The sources are compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/torch_ext/`` in the checkout, and
loaded with ``ctypes``; no PyTorch header is compiled, which keeps the build
to seconds.  The library's name carries a hash of the sources and flags, so
an edited source is rebuilt.  Nothing here runs at import: the CPU-only
install (no ``nvcc``, no card) imports the package freely.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run resets
it with ``reset_launches()`` to show which kernels a path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fused_step.cu",)
HEADERS = ("step_block.cuh", "fsm_block.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_ext"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("fused_step_kernel", "rollout_chunk_kernel",
           "rollout_chunk_simple_kernel", "fsm_act_kernel")

LAUNCHES = dict.fromkeys(KERNELS, 0)

_lib = None
build_log = ""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels if this exact source set has no library yet."""
    global build_log
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    out = BUILD_DIR / f"libpomcpp_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


class StateView(ctypes.Structure):
    """Device pointers of the 14 kernel-side state arrays (csrc StateView)."""

    _fields_ = [("f", ctypes.c_void_p * 14)]


class FsmView(ctypes.Structure):
    """Device pointers of the ten FSM state arrays (csrc FsmView)."""

    _fields_ = [("f", ctypes.c_void_p * 10)]


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        handle.pomcpp_fused_step.argtypes = [StateView, StateView, p, i, p]
        handle.pomcpp_fused_step.restype = i
        handle.pomcpp_rollout_chunk.argtypes = [
            StateView, StateView, i, i, i, u, u, p, p, p, i, p, p, p,
        ]
        handle.pomcpp_rollout_chunk.restype = i
        handle.pomcpp_rollout_chunk_simple.argtypes = [
            StateView, StateView, FsmView, FsmView, i, i, u, u, p, i, i, p, p,
            i, p, p, p,
        ]
        handle.pomcpp_rollout_chunk_simple.restype = i
        handle.pomcpp_fsm_act.argtypes = [StateView, FsmView, FsmView, p, p,
                                          i, p]
        handle.pomcpp_fsm_act.restype = i
        handle.pomcpp_error_string.argtypes = [i]
        handle.pomcpp_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        msg = lib().pomcpp_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({err})")


def _view(cls, arrays):
    view = cls()
    for k, t in enumerate(arrays):
        view.f[k] = t.data_ptr()
    return view


def state_view(arrays) -> StateView:
    """StateView over 14 contiguous int32 CUDA tensors (kept alive by the
    caller for the duration of the launch)."""
    return _view(StateView, arrays)


def fsm_view(arrays) -> FsmView:
    """FsmView over the ten FSM state arrays, as ``state_view``."""
    return _view(FsmView, arrays)
