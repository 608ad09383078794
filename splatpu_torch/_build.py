"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``.  No PyTorch headers are included,
so a build takes seconds; compiling a source that includes them through
PyTorch's extension tooling takes minutes.

Without the persistent cache, at first use the build directory
``splatpu_torch/_build/`` (or ``$SPLATPU_TORCH_BUILD_DIR``) is deleted and
made anew, so no stale library or lock from an earlier, interrupted run can
be picked up.  Under a ``torch.distributed`` process group of several
ranks, rank 0 of each host (``LOCAL_RANK`` 0) removes the kernel library's
own files and builds it while the other ranks wait at a barrier; then every
rank loads the same library and no rank deletes the directory, so the
native kNN library in ``_build/knn/`` survives every rank.

With the persistent cache on (``enable_cache``, which
``obs.cache.enable_compilation_cache`` calls), the library lives in
``<cache>/<key>/`` beside nvcc's log and a ``meta.json``; ``key`` is the
sha256 of every file in ``csrc/``, the nvcc flags, ``nvcc --version`` and
``CACHE_FORMAT`` (``cache_key``).  A process that finds the entry loads it
and compiles nothing; one that does not builds into a directory of its own
and publishes it with one ``os.rename``, so no process loads a
half-written library.  An entry that does not load is removed and built
again, once.  Under a process group local rank 0 of each host loads or
builds the entry while the others wait at the barrier, then load it; no
rank deletes anything outside its own temporary directory.

The launchers' ``ctypes`` signatures (``LAUNCHERS``) are bound once, when
the library loads.  Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import secrets
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = Path(os.environ.get("SPLATPU_TORCH_BUILD_DIR", PACKAGE_DIR / "_build"))
LIBRARY = BUILD_DIR / "libsplatpu_kernels.so"
NVCC_TIMEOUT_S = 180
CACHE_FORMAT = 1  # raised when what a cache entry holds changes
# Each launcher's C signature: its pointers, then its ints, then its floats,
# then the stream; it returns a CUDA error code.  Pointers and the stream as
# c_void_p: ctypes would otherwise pass each Python int as a 32-bit int and
# cut the pointer.
LAUNCHERS = {
    "splatpu_composite_fwd": (9, 9, 0),
    "splatpu_composite_bwd": (11, 9, 0),
    "splatpu_composite_manual_fwd": (9, 9, 0),
    "splatpu_composite_manual_bwd": (11, 9, 0),
    "splatpu_padded_fwd": (8, 7, 0),
    "splatpu_padded_bwd": (10, 7, 0),
    "splatpu_route_pairs": (5, 6, 0),
    "splatpu_project_fwd": (13, 8, 4),
    "splatpu_project_bwd": (15, 7, 4),
}

_lib: ctypes.CDLL | None = None
_library_path: Path | None = None
cache_dir: Path | None = None  # the persistent cache (``enable_cache``); None: off
build_log: str = ""        # nvcc's output (ptxas register / smem / spill lines)
build_seconds: float = 0.0  # load_library's: the build and load, or the cache entry's load
build_cached: bool = False  # the library came from the cache: nothing compiled
build_meta: dict = {}       # the cache entry's meta.json (the key's inputs, nvcc's seconds)
source_seconds: dict[str, float] = {}  # the last compile's nvcc wall seconds, by source


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


def _run_all(cmds: list[list[str]]) -> tuple[str, list[float]]:
    """Run the commands at once, each in its own process group; on timeout
    kill every group (nvcc's cicc/ptxas children included) and raise.
    Returns their output and each one's wall seconds from the common start."""
    t0 = time.monotonic()
    procs = [
        subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True,
        )
        for cmd in cmds
    ]
    outs, secs = [""] * len(cmds), [0.0] * len(cmds)

    def drain(i: int, proc: subprocess.Popen) -> None:
        outs[i] = proc.stdout.read()
        proc.wait()
        secs[i] = time.monotonic() - t0

    threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(t0 + NVCC_TIMEOUT_S - time.monotonic(), 0.0))
    if any(t.is_alive() for t in threads):
        for proc in procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for t in threads:
            t.join()
        raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s")
    failed = [f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}"
              for cmd, p, out in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs), secs


def _compile(srcs: list[Path], library: Path, fresh: bool) -> str:
    """Compile ``srcs`` and link them into ``library``, in its directory;
    return nvcc's log.  ``fresh``: the directory is deleted and made anew;
    otherwise only the files this build writes are removed first."""
    global source_seconds
    build_dir = library.parent
    objects = [build_dir / f"{src.stem}.o" for src in srcs]
    if fresh:
        shutil.rmtree(build_dir, ignore_errors=True)
    for f in ([] if fresh else [*objects, library]):
        f.unlink(missing_ok=True)
    build_dir.mkdir(parents=True, exist_ok=True)
    log, secs = _run_all([compile_command(src, build_dir) for src in srcs])
    source_seconds = {src.name: s for src, s in zip(srcs, secs)}
    return log + _run_all([link_command(objects, library)])[0]


def build_library(srcs: list[Path], library: Path, fresh: bool = True) -> tuple[ctypes.CDLL, str]:
    """Compile ``srcs`` and link them into ``library``, in its directory;
    return the loaded library and nvcc's log.  ``fresh``: the directory is
    deleted and made anew; otherwise only the files this build writes are
    removed first."""
    log = _compile(srcs, library, fresh)
    return ctypes.CDLL(str(library)), log


def cache_key(csrc: Path = CSRC_DIR) -> tuple[str, dict]:
    """(key, its inputs): the sha256 of every file under ``csrc`` by its
    relative name, the compile and link commands with each path cut to its
    last part, ``nvcc --version`` and ``CACHE_FORMAT``."""
    version = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    inputs = {
        "format": CACHE_FORMAT,
        "files": {p.relative_to(csrc).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
                  for p in sorted(csrc.rglob("*")) if p.is_file()},
        "compile": [os.path.basename(a) for a in compile_command(Path("src.cu"), Path("."))],
        "link": [os.path.basename(a) for a in link_command([Path("src.o")], LIBRARY)],
        "nvcc_version": version,
    }
    return hashlib.sha256(json.dumps(inputs, sort_keys=True).encode()).hexdigest(), inputs


def enable_cache(directory) -> None:
    """From the next ``load_library`` on, load the kernel library from the
    persistent cache in ``directory``, building into it on a miss."""
    global cache_dir
    cache_dir = Path(directory).resolve()


def _load_entry(entry: Path) -> tuple[ctypes.CDLL, str, dict]:
    """(library, nvcc's log, meta) of a published cache entry; OSError or
    ValueError where it is incomplete or does not load."""
    log = (entry / "build_log.txt").read_text()
    meta = json.loads((entry / "meta.json").read_text())
    return ctypes.CDLL(str(entry / LIBRARY.name)), log, meta


def _publish(entry: Path, inputs: dict) -> tuple[ctypes.CDLL, str, dict]:
    """Build into a directory of this process's own beside ``entry``, with
    nvcc's log and meta.json, and rename it to ``entry``; where another
    process published first, drop this build and load theirs."""
    tmp = entry.with_name(f"{entry.name}.tmp-{os.getpid()}-{secrets.token_hex(4)}")
    try:
        t0 = time.perf_counter()
        log = _compile(sources(), tmp / LIBRARY.name, fresh=True)
        meta = dict(inputs, key=entry.name, nvcc_seconds=source_seconds,
                    build_seconds=time.perf_counter() - t0)
        (tmp / "build_log.txt").write_text(log)
        (tmp / "meta.json").write_text(json.dumps(meta, indent=1))
        for obj in tmp.glob("*.o"):
            obj.unlink()
        try:
            os.rename(tmp, entry)
        except OSError:
            if not entry.is_dir():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _load_entry(entry)


def _cached_library(cache: Path) -> tuple[ctypes.CDLL, Path, str, dict, bool]:
    """(library, its entry, nvcc's log, meta, loaded from the cache): the
    entry of the sources' key if it loads, else built and published; an
    entry that does not load is removed and built again, once."""
    key, inputs = cache_key()
    entry = cache / key
    if entry.is_dir():
        try:
            lib, log, meta = _load_entry(entry)
            return lib, entry, log, meta, True
        except (OSError, ValueError) as e:
            print(f"splatpu_torch: kernel cache entry {entry} does not load ({e}); removing it"
                  " and building again", file=sys.stderr, flush=True)
            shutil.rmtree(entry, ignore_errors=True)
    cache.mkdir(parents=True, exist_ok=True)
    lib, log, meta = _publish(entry, inputs)
    return lib, entry, log, meta, False


def _ranks() -> tuple[bool, bool]:
    """(several ranks in a process group, this rank builds for its host)."""
    try:
        import torch.distributed as dist
    except ImportError:
        return False, True
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return False, True
    return True, int(os.environ.get("LOCAL_RANK", dist.get_rank())) == 0


def _bind(lib: ctypes.CDLL, path: Path) -> ctypes.CDLL:
    """Bind the error string's and every launcher's signature (a library
    without one of them, as the tests' stubs, leaves it unbound: calling it
    raises) and keep the library as this process's."""
    global _lib, _library_path
    lib.splatpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.splatpu_cuda_error_string.restype = ctypes.c_char_p
    for name, (n_ptr, n_int, n_float) in LAUNCHERS.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_float] * n_float + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    _lib, _library_path = lib, Path(path)
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, built from the sources on first call, or loaded
    from the persistent cache where it is on (under a process group: every
    rank must call it, as a barrier does)."""
    global build_log, build_seconds, build_cached, build_meta
    if _lib is None:
        t0 = time.perf_counter()
        ranked, builds = _ranks()
        cache, path = cache_dir, LIBRARY
        if builds and cache is not None:
            lib, entry, build_log, build_meta, build_cached = _cached_library(cache)
            path = entry / LIBRARY.name
        elif builds:
            lib, build_log = build_library(sources(), LIBRARY, fresh=not ranked)
        if ranked:
            import torch.distributed as dist

            dist.barrier()
        if not builds and cache is not None:
            entry = cache / cache_key()[0]
            lib, build_log, build_meta = _load_entry(entry)
            path, build_cached = entry / LIBRARY.name, True
        elif not builds:
            lib = ctypes.CDLL(str(LIBRARY))
        build_seconds = time.perf_counter() - t0
        _bind(lib, path)
    return _lib


def library_path() -> Path | None:
    """The path of the library this process loaded (None before it did):
    ``LIBRARY``, or its cache entry's."""
    return _library_path


def adopt_library(path) -> ctypes.CDLL:
    """Load the library that the parent process of this run loaded from
    ``path`` (``dist.launch`` hands it to its ranks), building nothing."""
    return _lib if _lib is not None else _bind(ctypes.CDLL(str(path)), path)


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
