"""Build and load the port's CUDA kernels (``csrc/``) on first use.

Each source file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface under ``build/torch_ext/`` in
the checkout, and loaded with ``ctypes``; no PyTorch header is compiled,
which keeps the build to seconds, and ``build()`` starts every compiler at
once.  A library's name carries a hash of its sources and flags, so an
edited source is rebuilt; the compiler's ``-Xptxas -v`` output is kept
beside the library (``.log``), so that ``build_log()`` describes the
library that is loaded even when an earlier run built it.  Nothing here
runs at import: the CPU-only install (no ``nvcc``, no card) imports the
package freely.

``LAUNCHES`` counts, per kernel, the launches made on the card (the dict is
``trace.LAUNCHES``; for the engine and feature libraries ``launch`` counts
them, the one module that calls their entries); a run resets it with
``reset_launches()`` to show which kernels a path went through.  The chunk
kernel's clocked instance, which ``trace`` samples, counts under its own
names.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path

from . import trace

CSRC = Path(__file__).resolve().parent / "csrc"
# One shared library per source file, so that they build side by side.
LIBRARIES = {
    "kernels": ("fused_step.cu", ("common.cuh", "step_warp.cuh",
                                  "fsm_warp.cuh", "env_warp.cuh")),
    "probes": ("probes.cu", ("probe_warp.cuh",)),
    "features": ("features.cu", ("common.cuh",)),
}
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_ext"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("fused_step_kernel", "fused_env_step_kernel", "env_merge_kernel",
           "rollout_chunk_kernel", "rollout_chunk_simple_kernel",
           "rollout_chunk_clocked_kernel", "rollout_chunk_clocked_simple_kernel",
           "fsm_act_kernel", "probe_elem_kernel", "probe_shift_kernel",
           "probe_reduce_kernel", "probe_dot_kernel", "probe_dot_tc_kernel",
           "ego_features_kernel")

LAUNCHES = trace.LAUNCHES
LAUNCHES.update(dict.fromkeys(KERNELS, 0))

_libs: dict = {}    # library -> loaded handle


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


def _target(name: str) -> Path:
    source, headers = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (source,) + headers:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"libpomcpp_{name}_{h.hexdigest()[:16]}.so"


def build(names=tuple(LIBRARIES)) -> dict:
    """Compile the named libraries that have no file for their exact
    sources yet, all ``nvcc`` runs started together; returns their paths."""
    outs = {name: _target(name) for name in names}
    procs = []
    for name, out in outs.items():
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / LIBRARIES[name][0])]
        procs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, out, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name} ({proc.returncode}):\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build_log(names=tuple(LIBRARIES)) -> str:
    """What ``nvcc`` printed when it built the named libraries' current
    files, whichever run built them ("" for one not built yet)."""
    logs = (_target(name).with_suffix(".log") for name in names)
    return "".join(p.read_text() for p in logs if p.exists())


def _load(name: str) -> tuple:
    """(handle, loaded just now) of a library, built if need be."""
    fresh = name not in _libs
    if fresh:
        _libs[name] = ctypes.CDLL(str(build((name,))[name]))
    return _libs[name], fresh


class StateView(ctypes.Structure):
    """Device pointers of the 14 kernel-side state arrays (csrc StateView)."""

    _fields_ = [("f", ctypes.c_void_p * 14)]


class GameView(ctypes.Structure):
    """Device pointers of a CellState's 16 arrays in their own dtypes, in
    field order (csrc GameView); all null: no game (the unused test hook)."""

    _fields_ = [("f", ctypes.c_void_p * 16)]


class EnvView(ctypes.Structure):
    """Device pointers of an EnvState's done, winner, is_draw and key
    (csrc EnvView)."""

    _fields_ = [("f", ctypes.c_void_p * 4)]


class FsmView(ctypes.Structure):
    """Device pointers of the ten FSM state arrays (csrc FsmView)."""

    _fields_ = [("f", ctypes.c_void_p * 10)]


class FeatureView(ctypes.Structure):
    """Device pointers of the arrays the features read (csrc
    ``feat::FeatureView``): five planes, five int32 agent fields, then
    ``agent_can_kick`` as bool bytes."""

    _fields_ = [("f", ctypes.c_void_p * 11)]


def bind_kernels(handle: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``fused_step.cu``."""
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    g, e = GameView, EnvView
    handle.pomcpp_fused_step.argtypes = [g, g, p, i, p]
    handle.pomcpp_fused_step.restype = i
    handle.pomcpp_env_step.argtypes = [g, e, g, e, g, p, i, i, i, i, p]
    handle.pomcpp_env_step.restype = i
    handle.pomcpp_env_merge.argtypes = [g, e, e, g, i, i, i, i, p]
    handle.pomcpp_env_merge.restype = i
    handle.pomcpp_rollout_chunk.argtypes = [
        StateView, StateView, i, i, i, u, u, p, p, p, i, p, p, p, p,
    ]
    handle.pomcpp_rollout_chunk.restype = i
    handle.pomcpp_rollout_chunk_simple.argtypes = [
        StateView, StateView, FsmView, FsmView, i, i, u, u, p, i, i, p, p,
        i, p, p, p, p,
    ]
    handle.pomcpp_rollout_chunk_simple.restype = i
    handle.pomcpp_fsm_act.argtypes = [g, FsmView, FsmView, p, p, i, p]
    handle.pomcpp_fsm_act.restype = i
    handle.pomcpp_chunk_warps.argtypes = []
    handle.pomcpp_chunk_warps.restype = i
    handle.pomcpp_chunk_grid.argtypes = [i]
    handle.pomcpp_chunk_grid.restype = i
    handle.pomcpp_ctas_per_sm.argtypes = [i]
    handle.pomcpp_ctas_per_sm.restype = i
    handle.pomcpp_error_string.argtypes = [i]
    handle.pomcpp_error_string.restype = ctypes.c_char_p
    return handle


def lib() -> ctypes.CDLL:
    """The loaded engine kernels (``fused_step.cu``), built on first call."""
    handle, fresh = _load("kernels")
    return bind_kernels(handle) if fresh else handle


def bind_probes(handle: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``probes.cu`` (or, in the
    tests, of the host build of ``probe_warp.cuh``, which has the elem and
    shift entries only)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    entries = {
        "pomcpp_probe_elem": [i, i, i, p, p, i, i, i, i, i, p],
        "pomcpp_probe_shift": [i, i, i, p, p, p, p, i, i, i, i, p],
        "pomcpp_probe_reduce": [i, i, p, p, p, p, i, i, i, i, p],
        "pomcpp_probe_dot": [i, i, p, p, p, i, i, i, i, p],
    }
    for name, argtypes in entries.items():
        if hasattr(handle, name):
            fn = getattr(handle, name)
            fn.argtypes, fn.restype = argtypes, i
    handle.pomcpp_probes_error_string.argtypes = [i]
    handle.pomcpp_probes_error_string.restype = ctypes.c_char_p
    return handle


def probes_lib() -> ctypes.CDLL:
    """The loaded probe kernels (``probes.cu``), built on first call."""
    handle, fresh = _load("probes")
    return bind_probes(handle) if fresh else handle


def bind_features(handle: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``features.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.pomcpp_ego_features.argtypes = [FeatureView, p, i, i, i, i, p]
    handle.pomcpp_ego_features.restype = i
    handle.pomcpp_features_error_string.argtypes = [i]
    handle.pomcpp_features_error_string.restype = ctypes.c_char_p
    return handle


def features_lib() -> ctypes.CDLL:
    """The loaded feature kernel (``features.cu``), built on first call."""
    handle, fresh = _load("features")
    return bind_features(handle) if fresh else handle


def check(err: int, error_string) -> None:
    """Raise if a launcher reported a CUDA error; ``error_string`` is the
    ``pomcpp_error_string`` / ``pomcpp_probes_error_string`` /
    ``pomcpp_features_error_string`` of the library
    that launched."""
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel launch failed: {error_string(err).decode()} ({err})")


# The pointer arrays of the views as ``struct`` layouts: a view built from a
# list of pointers is one copy of packed bytes.
_PACKED = {cls: struct.Struct(f"{cls._fields_[0][1]._length_}P")
           for cls in (StateView, GameView, EnvView, FsmView, FeatureView)}


def view(cls, ptrs):
    """A ``cls`` view over the data pointers ``ptrs`` (ints, in field
    order), built in one constructor call."""
    return cls.from_buffer_copy(_PACKED[cls].pack(*ptrs))


def row_ptrs(t) -> list:
    """The data pointers of ``t[0], t[1], ...`` of a contiguous tensor,
    without making the rows."""
    base, step = t.data_ptr(), t.stride(0) * t.element_size()
    return [base + k * step for k in range(t.shape[0])]
