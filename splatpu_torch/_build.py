"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``.  No PyTorch headers are included,
so a build takes seconds; compiling a source that includes them through
PyTorch's extension tooling takes minutes.

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


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def compile_command(source: Path, build_dir: Path) -> list[str]:
    """nvcc of one source into a position-independent object."""
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(build_dir / f"{source.stem}.o"), str(source),
    ]


def link_command(objects: list[Path], library: Path) -> list[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
        "-o", str(library), *(str(o) for o in objects),
    ]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once, each in its own process group; on timeout
    kill every group (nvcc's cicc/ptxas children included) and raise."""
    procs = [
        subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True,
        )
        for cmd in cmds
    ]
    deadline = time.monotonic() + NVCC_TIMEOUT_S
    outs, failed = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 0.1))
            outs.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    except subprocess.TimeoutExpired:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def build_library(srcs: list[Path], library: Path) -> tuple[ctypes.CDLL, str]:
    """Compile ``srcs`` and link them into ``library``, in its directory,
    which is deleted and made anew; return the loaded library and nvcc's
    log."""
    build_dir = library.parent
    shutil.rmtree(build_dir, ignore_errors=True)
    build_dir.mkdir(parents=True)
    log = _run_all([compile_command(src, build_dir) for src in srcs])
    log += _run_all([link_command([build_dir / f"{src.stem}.o" for src in srcs], library)])
    return ctypes.CDLL(str(library)), log


def load_library() -> ctypes.CDLL:
    """The kernel library, built from the sources on first call."""
    global _lib, build_log, build_seconds
    if _lib is None:
        t0 = time.perf_counter()
        lib, build_log = build_library(sources(), LIBRARY)
        lib.splatpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.splatpu_cuda_error_string.restype = ctypes.c_char_p
        build_seconds = time.perf_counter() - t0
        _lib = lib
    return _lib


def require_cuda(name: str, tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    if not all(x.is_cuda for x in tensors):
        raise ValueError(f"{name} takes CUDA tensors only")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} takes contiguous tensors only")


def check_status(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.splatpu_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
