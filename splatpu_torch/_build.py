"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  No PyTorch headers
are included, so a build takes seconds; compiling a source that includes
them through PyTorch's extension tooling takes minutes.

At first use the build directory ``splatpu_torch/_build/`` is deleted and
made anew, so no stale library or lock from an earlier, interrupted run can
be picked up.  Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import signal
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIBRARY = BUILD_DIR / "libsplatpu_kernels.so"
NVCC_TIMEOUT_S = 180

_lib: ctypes.CDLL | None = None
build_log: str = ""        # nvcc's output (ptxas register / smem / spill lines)
build_seconds: float = 0.0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def nvcc_command() -> list[str]:
    sources = sorted(str(p) for p in CSRC_DIR.glob("*.cu"))
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(LIBRARY), *sources,
    ]


def _run(cmd: list[str]) -> str:
    """Run cmd in its own process group; on timeout kill the whole group
    (nvcc's cicc/ptxas children included) and raise."""
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True,
    )
    try:
        out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(
            f"nvcc timed out after {NVCC_TIMEOUT_S} s: {' '.join(cmd)}\n{out}"
        )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built from the sources on first call."""
    global _lib, build_log, build_seconds
    if _lib is None:
        t0 = time.perf_counter()
        shutil.rmtree(BUILD_DIR, ignore_errors=True)
        BUILD_DIR.mkdir(parents=True)
        build_log = _run(nvcc_command())
        lib = ctypes.CDLL(str(LIBRARY))
        lib.splatpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.splatpu_cuda_error_string.restype = ctypes.c_char_p
        build_seconds = time.perf_counter() - t0
        _lib = lib
    return _lib


def check_status(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.splatpu_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
