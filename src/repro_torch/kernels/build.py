"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point ``<name>_launch`` and is
compiled on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so csrc/<name>.cu

into ``src/repro_torch/_build/`` (git-ignored), then loaded with ``ctypes``.
The file name carries a hash of the source, the shared headers and the
flags, so an edited source rebuilds and a stale library is never loaded.
Nothing is compiled at import: ``library(name)`` builds on first use, and
``build()`` compiles several sources in parallel (one ``nvcc`` each).
Each build counts in ``kernel_builds_total{program=}`` (the program whose
call triggered it, ``telemetry/accounting.py:tagged_program``) and
``kernel_build_seconds`` once telemetry points the accounting registry at
a live one.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch.telemetry.accounting import note_kernel_build

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("landmark_summary", "query_side", "paged_row_stats",
           "landmark_summary_bwd", "query_side_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Storage-type codes of csrc/common.cuh.
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Argument types of each <name>_launch (pointers and the stream as c_void_p,
# so ctypes never truncates them to 32 bits).
ARGTYPES = {
    "landmark_summary": [_P] * 7 + [_I] * 5 + [_F] + [_I] * 7 + [_P],
    "query_side": [_P] * 6 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
    "paged_row_stats": [_P] * 10 + [_I] * 10 + [_F] + [_I] + [_P],
    "landmark_summary_bwd": [_P] * 12 + [_I] * 5 + [_F] + [_I] * 7 + [_P],
    "query_side_bwd": [_P] * 16 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME or PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes at once. Returns ``{name: {"seconds", "ptxas"}}``
    for the ones compiled (``ptxas`` = the register/spill report). Raises
    with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path() if any(not library_path(n).exists() for n in names) else ""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc={proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a half-written .so
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        note_kernel_build(report[name]["seconds"])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if needed),
    with ``<name>_launch``'s argtypes and restype declared."""
    build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ARGTYPES[name]
    fn.restype = ctypes.c_int
    return lib


def check_operands(name: str, tensors: dict, dtypes=None) -> None:
    """Raise unless every tensor of ``tensors`` lies on the first one's
    device, is contiguous and (with ``dtypes``) has one of those dtypes."""
    dev = next(iter(tensors.values())).device
    for arg, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if dtypes is not None and str(t.dtype) not in dtypes:
            raise ValueError(f"{name}: {arg} dtype {t.dtype} not in {sorted(dtypes)}")


def launch(name: str, *args) -> None:
    """Call ``<name>_launch(*args)``; raise if the launch was refused."""
    err = getattr(library(name), f"{name}_launch")(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
