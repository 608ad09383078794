"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``.  No PyTorch headers are included,
so a build takes seconds; compiling a source that includes them through
PyTorch's extension tooling takes minutes.

At first use the build directory ``splatpu_torch/_build/`` (or
``$SPLATPU_TORCH_BUILD_DIR``) is deleted and made anew, so no stale library
or lock from an earlier, interrupted run can be picked up.  Under a
``torch.distributed`` process group of several ranks, rank 0 of each host
(``LOCAL_RANK`` 0) removes the kernel library's own files and builds it
while the other ranks wait at a barrier; then every rank loads the same
library and no rank deletes the directory, so the native kNN library in
``_build/knn/`` survives every rank.  Nothing is built when this module is
imported.
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
BUILD_DIR = Path(os.environ.get("SPLATPU_TORCH_BUILD_DIR", PACKAGE_DIR / "_build"))
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


def build_library(srcs: list[Path], library: Path, fresh: bool = True) -> tuple[ctypes.CDLL, str]:
    """Compile ``srcs`` and link them into ``library``, in its directory;
    return the loaded library and nvcc's log.  ``fresh``: the directory is
    deleted and made anew; otherwise only the files this build writes are
    removed first."""
    build_dir = library.parent
    objects = [build_dir / f"{src.stem}.o" for src in srcs]
    if fresh:
        shutil.rmtree(build_dir, ignore_errors=True)
    for f in ([] if fresh else [*objects, library]):
        f.unlink(missing_ok=True)
    build_dir.mkdir(parents=True, exist_ok=True)
    log = _run_all([compile_command(src, build_dir) for src in srcs])
    log += _run_all([link_command(objects, library)])
    return ctypes.CDLL(str(library)), log


def _ranks() -> tuple[bool, bool]:
    """(several ranks in a process group, this rank builds for its host)."""
    try:
        import torch.distributed as dist
    except ImportError:
        return False, True
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return False, True
    return True, int(os.environ.get("LOCAL_RANK", dist.get_rank())) == 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    global _lib
    lib.splatpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.splatpu_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, built from the sources on first call (under a
    process group: every rank must call it, as a barrier does)."""
    global build_log, build_seconds
    if _lib is None:
        t0 = time.perf_counter()
        ranked, builds = _ranks()
        if builds:
            lib, build_log = build_library(sources(), LIBRARY, fresh=not ranked)
        if ranked:
            import torch.distributed as dist

            dist.barrier()
        if not builds:
            lib = ctypes.CDLL(str(LIBRARY))
        build_seconds = time.perf_counter() - t0
        _bind(lib)
    return _lib


def adopt_library(path) -> ctypes.CDLL:
    """Load the library that the parent process of this run built at
    ``path`` (``dist.launch`` hands it to its ranks), building nothing."""
    return _lib if _lib is not None else _bind(ctypes.CDLL(str(path)))


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
