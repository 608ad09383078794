"""``obs.profiling.time_fn`` of the port against the JAX package's.

- the same ``fn`` and ``args_fn`` through both on the CPU: the same index
  sequence handed to ``args_fn`` (``-(warmup + 1) .. iters - 1``), the same
  calls, the same number of calls between the two clock reads of each
  batch, and the same keys;
- the card path, run on the CPU with ``torch.cuda`` stubbed: a device
  synchronize right before each batch's first clock read and right after
  its last call, then the second read; no ``torch.cuda._sleep`` and no CUDA
  event; ``timer`` is ``"host_clock"``.
"""

from types import SimpleNamespace

import pytest
import torch

from splatpu.obs import profiling as jax_profiling
from splatpu_torch.obs import profiling


def clocked(log):
    """A ``time`` stand-in whose ``perf_counter`` logs each read."""
    def perf_counter():
        log.append(("clock",))
        return float(len(log))
    return SimpleNamespace(perf_counter=perf_counter)


def batches(log):
    """The number of calls between each batch's two clock reads."""
    reads = [i for i, e in enumerate(log) if e[0] == "clock"]
    return [sum(e[0] == "call" for e in log[a:b]) for a, b in zip(reads[::2], reads[1::2])]


@pytest.mark.parametrize("warmup,iters,n_batches", [(2, 5, 2), (0, 3, 3), (1, 4, 1)])
def test_time_fn_matches_jax(monkeypatch, warmup, iters, n_batches):
    runs = {}
    for name, module, kw in [("jax", jax_profiling, {}),
                             ("torch", profiling, {"device": "cpu"})]:
        log, asked = [], []
        monkeypatch.setattr(module, "time", clocked(log))

        def args_fn(i, asked=asked):
            asked.append(i)
            return (i, 10 * i)

        def fn(a, b, log=log):
            log.append(("call", a, b))
            return a

        stats = module.time_fn(fn, warmup=warmup, iters=iters, args_fn=args_fn,
                               batches=n_batches, **kw)
        runs[name] = (asked, [e for e in log if e[0] == "call"], batches(log), stats)
    (j_asked, j_calls, j_batches, j_stats), (asked, calls, per, stats) = runs["jax"], runs["torch"]
    assert asked == j_asked == list(range(-(warmup + 1), iters))
    assert calls == j_calls == [("call", i, 10 * i) for i in range(-(warmup + 1), iters)]
    assert per == j_batches and sum(per) == iters and len(per) == n_batches
    assert set(stats) - {"timer"} == set(j_stats) == {"mean_ms", "spread_ms", "iters"}
    assert stats["iters"] == j_stats["iters"] == iters
    assert stats["mean_ms"] == pytest.approx(j_stats["mean_ms"])
    assert stats["spread_ms"] == pytest.approx(j_stats["spread_ms"])


def test_time_fn_card_path_reads_the_host_clock(monkeypatch):
    log = []

    def refuse(*a, **k):
        raise AssertionError("time_fn must not sleep the card or record events")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: log.append(("sync",)))
    monkeypatch.setattr(torch.cuda, "_sleep", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(profiling, "time", clocked(log))
    stats = profiling.time_fn(lambda i: log.append(("call", i)), warmup=2, iters=5,
                              args_fn=lambda i: (i,), batches=2, device="cuda")
    assert stats["timer"] == "host_clock" and stats["iters"] == 5
    warm = [("call", i) for i in range(-3, 0)]
    assert log[:3] == warm
    assert log[3:] == [("sync",), ("clock",), *[("call", i) for i in range(3)], ("sync",),
                       ("clock",), ("sync",), ("clock",), ("call", 3), ("call", 4), ("sync",),
                       ("clock",)]
    assert stats["mean_ms"] > 0 and stats["spread_ms"] >= 0
