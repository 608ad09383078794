"""Start ranks on this host and collect what each returns.

    results = launch(fn, nprocs, args, rendezvous_dir, device="cpu")

Starts ``nprocs`` processes with ``torch.multiprocessing`` (start method
``spawn``), each one rank of a process group met through a ``file://``
rendezvous in ``rendezvous_dir``; each runs ``fn(*args)`` and sends its
return value (plain host objects: numbers, numpy arrays, dicts) back.  The
backend is ``mesh.default_backend``'s: NCCL when each rank has a card of
its own, gloo when ranks share one and on the CPU.  On a CUDA device each
rank computes on ``cuda:{rank % cards}`` and loads the kernels before
``fn`` runs: the library the calling process has loaded, if it has, else
one build per host (``_build.load_library``: rank 0 builds, the other ranks
wait at a barrier), so that no rank reads the build directory while
another writes it.  Where the calling process turned the persistent kernel
cache on, every rank has it on too.

``fn`` must live at module level in an importable module (a child imports
its module and nothing of the caller's).  Each rank's standard output and
error go to ``rank<r>.log`` in ``rendezvous_dir``.  The parent waits at
most ``timeout_s`` for every result; when a rank raises, exits without a
result or outlives the timeout, every rank is killed and ``RankFailure``
is raised with every rank's output.  On success the outputs are printed,
each line prefixed with its rank, and the results returned in rank
order.
"""

from __future__ import annotations

import os
import queue as queue_mod
import signal
import sys
import time
import traceback
import uuid
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from splatpu_torch.dist.mesh import TIMEOUT, default_backend


class RankFailure(RuntimeError):
    """A rank raised, died or hung; the message holds every rank's output."""


def _die_with_parent() -> None:
    """On Linux, have this rank killed when the launching process dies (a
    parent killed by its own watchdog leaves no rank behind)."""
    try:
        import ctypes

        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _rank_main(fn, args, rank, nprocs, init_method, backend, device, log_path, results, library,
               cache):
    _die_with_parent()
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    sys.stdout.reconfigure(line_buffering=True)
    sys.stderr.reconfigure(line_buffering=True)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(nprocs))
    torch.set_num_threads(1)
    try:
        from splatpu_torch import _build

        if cache:
            _build.enable_cache(cache)
        on_card = torch.device(device).type == "cuda"
        if on_card:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=nprocs,
                                timeout=TIMEOUT)
        if on_card:
            _build.adopt_library(library) if library else _build.load_library()
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        traceback.print_exc()
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        sys.stdout.flush()
        sys.stderr.flush()


def launch(fn, nprocs: int, args=(), rendezvous_dir=None, device="cuda",
           timeout_s: float = 600.0) -> list:
    """``fn(*args)`` on ``nprocs`` ranks, one thread each; the return
    values in rank order."""
    if rendezvous_dir is None:
        raise ValueError("launch needs a rendezvous directory")
    rdv = Path(rendezvous_dir).resolve()
    rdv.mkdir(parents=True, exist_ok=True)
    backend = default_backend(device, nprocs)
    from splatpu_torch import _build

    on_card = torch.device(device).type == "cuda"
    library = str(_build.library_path()) if on_card and _build._lib else None
    cache = str(_build.cache_dir) if _build.cache_dir is not None else None
    init_method = f"file://{rdv / ('rendezvous-' + uuid.uuid4().hex)}"
    logs = [rdv / f"rank{r}.log" for r in range(nprocs)]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(fn, tuple(args), r, nprocs, init_method, backend,
                                             str(device), str(logs[r]), results, library, cache))
        for r in range(nprocs)
    ]
    for p in procs:
        p.start()
    got, failure = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < nprocs and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"timed out after {timeout_s:.0f} s"
                break
            try:
                rank, ok, payload = results.get(timeout=min(1.0, left))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in got]
                if dead:
                    failure = "rank(s) exited without a result: " + ", ".join(
                        f"{r} (exit code {procs[r].exitcode})" for r in dead)
                continue
            got[rank] = payload
            if not ok:
                failure = f"rank {rank} raised"
        if failure is None:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 30.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    outputs = [log.read_text(errors="replace") if log.exists() else "" for log in logs]
    if failure is not None:
        raise RankFailure(f"{failure}\n" + "".join(
            f"--- rank {r} (exit code {p.exitcode}) ---\n{out}" for r, (p, out) in
            enumerate(zip(procs, outputs))))
    for r, out in enumerate(outputs):
        for line in out.splitlines():
            print(f"[rank {r}] {line}", flush=True)
    return [got[r] for r in range(nprocs)]


CLI_TIMEOUT_S = 7 * 24 * 3600.0  # a command line's ranks: a week's run


def main_on_ranks(main, argv, nprocs: int, device, timeout_s: float = CLI_TIMEOUT_S):
    """A command line's ``main(argv)`` on ``nprocs`` ranks of a new process
    group on this host, met in a temporary directory; rank 0's return."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="splatpu_ranks_") as rdv:
        return launch(main, nprocs, (list(argv),), rdv, device=device, timeout_s=timeout_s)[0]
