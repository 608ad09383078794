"""The persistent kernel cache (``splatpu_torch/obs/cache.py`` and
``_build``'s cache path), with a stub nvcc: it logs each compile and link
with the process that ran it, writes empty objects, and links a stub
library with every launcher's symbol through gcc.  Each test sets its own
``CUDA_HOME``, build and cache directories.

- the key: stable across two computations; another when one byte of a
  source or a header, a flag or nvcc's version changes;
- a second ``load_library`` of the process runs no nvcc and loads the
  published entry, its log kept;
- two processes building at once (the stub holds each compile until both
  compile) leave one entry and load it;
- an entry whose library is cut short is removed and built once more; a
  failed rebuild raises;
- with the cache off, the build directory holds what it held before the
  cache existed, and nothing is cached;
- three ranks under ``dist.launch`` with the cache on: one builds, every
  rank loads the published entry;
- ``enable_compilation_cache`` has the JAX function's signature, makes its
  directory, turns the cache on; ``$SPLATPU_TORCH_COMPILE_CACHE`` names it;
- every launcher's ``argtypes`` are bound when the library loads.

The JAX package's ``enable_compilation_cache`` is not called: it sets
``jax.config`` for the whole worker.
"""

from __future__ import annotations

import ctypes
import inspect
import json
import os
import shutil
import stat
import subprocess
import sys
from pathlib import Path

import pytest

import splatpu.obs.cache as jax_cache
from splatpu_torch import _build
from splatpu_torch.dist import ranks
from splatpu_torch.dist.launch import launch
from splatpu_torch.obs import cache

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120

STUB_NVCC = r'''#!@PYTHON@
import os, subprocess, sys, time
if "--version" in sys.argv:
    print("stub nvcc: release " + os.environ.get("STUB_NVCC_VERSION", "1.0"))
    sys.exit(0)
link = "-shared" in sys.argv
with open(@LOG@, "a") as f:
    f.write(f"{os.getppid()} {'link' if link else 'compile'}\n")
if os.path.exists(@FAIL@):
    sys.exit(1)
rdv = os.environ.get("STUB_NVCC_RENDEZVOUS")
if rdv and not link:  # hold every compile until two processes compile
    open(os.path.join(rdv, str(os.getppid())), "w").close()
    t0 = time.monotonic()
    while len(os.listdir(rdv)) < 2 and time.monotonic() - t0 < 60:
        time.sleep(0.02)
out = sys.argv[sys.argv.index("-o") + 1]
if link:
    src = out + ".c"
    with open(src, "w") as f:
        f.write(@STUB_C@)
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", out, src], check=True)
    os.unlink(src)
else:
    print("stub ptxas: " + os.path.basename(sys.argv[-1]))
    open(out, "w").close()
'''

STUB_C = "".join(
    ['const char *splatpu_cuda_error_string(int c) { return "stub"; }\n']
    + [f"int {name}(void) {{ return 0; }}\n" for name in _build.LAUNCHERS])

CHILD = """
import json, sys
from splatpu_torch import _build
from splatpu_torch.obs.cache import enable_compilation_cache
enable_compilation_cache(sys.argv[1])
_build.load_library()
print(json.dumps({"path": str(_build.library_path()), "cached": _build.build_cached}))
"""


@pytest.fixture
def state(tmp_path, monkeypatch):
    """This process's _build state reset, restored after the test; a build
    directory of the test's own."""
    build = tmp_path / "build"
    for name, value in (("_lib", None), ("_library_path", None), ("cache_dir", None),
                        ("build_log", ""), ("build_seconds", 0.0), ("build_cached", False),
                        ("build_meta", {}), ("source_seconds", {}), ("BUILD_DIR", build),
                        ("LIBRARY", build / "libsplatpu_kernels.so")):
        monkeypatch.setattr(_build, name, value)
    monkeypatch.setenv("SPLATPU_TORCH_BUILD_DIR", str(build))


@pytest.fixture
def stub(state, tmp_path, monkeypatch):
    """A stub nvcc under CUDA_HOME and a cache directory of the test's own."""
    if shutil.which("gcc") is None:
        pytest.skip("the stub nvcc links its library with gcc")
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    log, fail = tmp_path / "nvcc.log", tmp_path / "nvcc.fail"
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(STUB_NVCC.replace("@PYTHON@", sys.executable).replace("@LOG@", repr(str(log)))
                    .replace("@FAIL@", repr(str(fail))).replace("@STUB_C@", repr(STUB_C)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(cuda))

    class Stub:
        cache = tmp_path / "cache"

        @staticmethod
        def calls() -> list[tuple[str, str]]:
            """(process id, compile or link) of every nvcc run so far."""
            return [tuple(x.split()) for x in log.read_text().splitlines()] if log.exists() else []

        @staticmethod
        def fail(on: bool = True) -> None:
            fail.write_text("") if on else fail.unlink(missing_ok=True)

        @staticmethod
        def reset() -> None:
            """Forget this process's library, as a new process would."""
            monkeypatch.setattr(_build, "_lib", None)

    return Stub


def child_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))


def build_in_child(cache_dir: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, str(cache_dir)], cwd=ROOT, env=child_env(),
                         capture_output=True, text=True, timeout=TIMEOUT_S, check=True)
    return json.loads(out.stdout.splitlines()[-1])


def entries(cache_dir: Path) -> list[str]:
    return sorted(p.name for p in cache_dir.iterdir())


@pytest.mark.parametrize("change", ["source", "header", "flag", "nvcc"])
def test_key_is_stable_and_follows_every_input(stub, tmp_path, monkeypatch, change):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    key, inputs = _build.cache_key(csrc)
    assert _build.cache_key(csrc) == (key, inputs)
    assert sorted(inputs["files"]) == sorted(p.name for p in _build.CSRC_DIR.iterdir())
    assert not any(os.sep in a for a in inputs["compile"] + inputs["link"])
    if change in ("source", "header"):
        f = csrc / ("composite_fwd.cu" if change == "source" else "composite_common.cuh")
        b = bytearray(f.read_bytes())
        b[len(b) // 2] ^= 1
        f.write_bytes(bytes(b))
    elif change == "flag":
        plain = _build.compile_command
        monkeypatch.setattr(_build, "compile_command", lambda s, d: [*plain(s, d), "-lineinfo"])
    else:
        monkeypatch.setenv("STUB_NVCC_VERSION", "1.1")
    assert _build.cache_key(csrc)[0] != key


def test_second_load_runs_no_nvcc_and_keeps_the_log(stub):
    cache.enable_compilation_cache(str(stub.cache))
    _build.load_library()
    first = (_build.library_path(), _build.build_log)
    n_src = len(_build.sources())
    assert [kind for _, kind in stub.calls()] == ["compile"] * n_src + ["link"]
    assert not _build.build_cached
    key = _build.cache_key()[0]
    assert entries(stub.cache) == [key]
    assert first[0] == stub.cache / key / "libsplatpu_kernels.so"
    assert sorted(p.name for p in (stub.cache / key).iterdir()) == [
        "build_log.txt", "libsplatpu_kernels.so", "meta.json"]
    meta = json.loads((stub.cache / key / "meta.json").read_text())
    assert meta["key"] == key and set(meta["nvcc_seconds"]) == {s.name for s in _build.sources()}
    assert "stub ptxas: composite_fwd.cu" in first[1]
    stub.reset()
    _build.load_library()
    assert len(stub.calls()) == n_src + 1
    assert _build.build_cached and (_build.library_path(), _build.build_log) == first
    assert _build.build_meta == meta


def test_two_processes_building_at_once_publish_one_entry(stub, tmp_path, monkeypatch):
    rdv = tmp_path / "rdv"
    rdv.mkdir()
    monkeypatch.setenv("STUB_NVCC_RENDEZVOUS", str(rdv))
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(stub.cache)], cwd=ROOT,
                              env=child_env(), stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [json.loads(p.communicate(timeout=TIMEOUT_S)[0].splitlines()[-1]) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    compiled_by = {pid for pid, kind in stub.calls() if kind == "compile"}
    assert compiled_by == {str(p.pid) for p in procs}  # both missed and built
    key = _build.cache_key()[0]
    assert entries(stub.cache) == [key]  # one entry, no temporary directory left
    assert {o["path"] for o in outs} == {str(stub.cache / key / "libsplatpu_kernels.so")}
    assert not any(o["cached"] for o in outs)


def test_an_entry_that_does_not_load_is_built_once_more(stub, capfd):
    built = build_in_child(stub.cache)
    lib = Path(built["path"])
    lib.write_bytes(lib.read_bytes()[:100])
    n = len(stub.calls())
    cache.enable_compilation_cache(str(stub.cache))
    _build.load_library()
    assert "does not load" in capfd.readouterr().err
    assert len(stub.calls()) == 2 * n and not _build.build_cached
    assert str(_build.library_path()) == built["path"]
    assert entries(stub.cache) == [lib.parent.name]


def test_a_failed_rebuild_raises(stub):
    built = build_in_child(stub.cache)
    lib = Path(built["path"])
    lib.write_bytes(lib.read_bytes()[:100])
    stub.fail()
    cache.enable_compilation_cache(str(stub.cache))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load_library()
    assert _build._lib is None and _build.library_path() is None
    assert entries(stub.cache) == []  # the broken entry and the failed build are gone


def test_cache_off_builds_into_the_build_directory_as_before(stub):
    _build.load_library()
    assert _build.cache_dir is None and not stub.cache.exists()
    assert _build.library_path() == _build.LIBRARY
    assert sorted(p.name for p in _build.BUILD_DIR.iterdir()) == sorted(
        [f"{s.stem}.o" for s in _build.sources()] + ["libsplatpu_kernels.so"])
    assert not _build.build_cached and "stub ptxas" in _build.build_log
    assert set(_build.source_seconds) == {s.name for s in _build.sources()}


def test_ranks_with_the_cache_on_load_one_published_entry(stub, tmp_path):
    cache.enable_compilation_cache(str(stub.cache))
    got = launch(ranks.library_on_rank, 3, (), tmp_path / "rdv", device="cpu",
                 timeout_s=TIMEOUT_S)
    key = _build.cache_key()[0]
    compiled_by = {pid for pid, kind in stub.calls()}
    assert compiled_by == {str(got[0]["pid"])}
    assert len(stub.calls()) == len(_build.sources()) + 1
    assert {r["path"] for r in got} == {str(stub.cache / key / "libsplatpu_kernels.so")}
    assert [r["cached"] for r in got] == [False, True, True]
    assert entries(stub.cache) == [key]
    assert not _build.BUILD_DIR.exists()


def test_enable_compilation_cache_matches_jax_and_turns_the_cache_on(state, tmp_path):
    assert (inspect.signature(cache.enable_compilation_cache)
            == inspect.signature(jax_cache.enable_compilation_cache))
    d = tmp_path / "a" / "b"
    cache.enable_compilation_cache(str(d))
    assert d.is_dir() and _build.cache_dir == d.resolve()
    env = dict(child_env(), SPLATPU_TORCH_COMPILE_CACHE=str(tmp_path / "env"))
    out = subprocess.run([sys.executable, "-c", "from splatpu_torch.obs import cache;"
                          " print(cache.DEFAULT_DIR)"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=TIMEOUT_S, check=True)
    assert out.stdout.strip() == str(tmp_path / "env")
    env.pop("SPLATPU_TORCH_COMPILE_CACHE")
    env["HOME"] = str(tmp_path / "home")
    out = subprocess.run([sys.executable, "-c", "from splatpu_torch.obs import cache;"
                          " print(cache.DEFAULT_DIR)"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=TIMEOUT_S, check=True)
    assert out.stdout.strip() == str(tmp_path / "home" / ".cache" / "splatpu_torch_kernels")


def test_every_launcher_is_bound_when_the_library_loads(stub):
    lib = _build.load_library()
    assert lib.splatpu_cuda_error_string.restype is ctypes.c_char_p
    for name, (n_ptr, n_int) in _build.LAUNCHERS.items():
        fn = getattr(lib, name)
        assert fn.argtypes == [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        assert fn.restype is ctypes.c_int
