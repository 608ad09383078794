"""Persistent kernel cache setup (port of ``splatpu/obs/cache.py``).

Building the CUDA kernels takes nvcc tens of seconds per process; the
on-disk cache, keyed by the kernels' sources, the nvcc flags and nvcc's
version (``_build.cache_key``), makes repeat runs (benchmarks, CLIs
restarted after a crash, the ranks of a run) load them in under a second.
Off until called, as JAX's: a caller of ``render`` alone builds once per
process.  The directory is ``$SPLATPU_TORCH_COMPILE_CACHE``, else
``~/.cache/splatpu_torch_kernels``; delete it to clear the cache.
"""

from __future__ import annotations

import os
from pathlib import Path

from splatpu_torch import _build

DEFAULT_DIR = os.environ.get(
    "SPLATPU_TORCH_COMPILE_CACHE", str(Path.home() / ".cache" / "splatpu_torch_kernels")
)


def enable_compilation_cache(directory: str | None = None):
    d = directory or DEFAULT_DIR
    Path(d).mkdir(parents=True, exist_ok=True)
    _build.enable_cache(d)
