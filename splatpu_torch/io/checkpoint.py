"""Reading what the JAX package writes (port of ``splatpu/io/checkpoint.py``).

- ``load_cloud``: the stage-1 -> stage-2 npz cloud.
- ``msgpack_restore``: a reader of flax's msgpack checkpoints, in pure
  Python on numpy (no ``msgpack`` or ``flax`` package needed).  flax packs
  ndarrays as msgpack ext type 1 holding ``packb((shape, dtype_name,
  bytes))``, numpy scalars as ext type 3 (the same payload, unpacked to a
  scalar), Python complex as ext type 2, lists / tuples as maps keyed "0",
  "1", ..., and arrays over 1 GiB as "chunked" maps.
- ``load_stage2_net``: a stage-2 checkpoint's ``net_params`` as a
  ``DeformationNet`` state dict; ``load_stage2_run``: the network of a
  stage-2 run directory with the head settings its result file records;
  ``load_stage2_opt_state``: its Adam state (count, first and second moments).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

from splatpu_torch.core.types import CLOUD_PARAMS, GaussianCloud
from splatpu_torch.dynamics.network import DeformationNet, net_config_for, state_dict_from_jax

HEAD_KNOBS = ("delta_scale", "double_residual", "zero_init_head", "time_gate_head")


def load_cloud(path, device="cuda") -> GaussianCloud:
    with np.load(Path(path)) as data:
        return GaussianCloud(
            **{k: torch.from_numpy(data[k]).to(device) for k in CLOUD_PARAMS + ("alive",)}
        )


class _Reader:
    """Decoder of the msgpack subset flax writes (the whole spec but
    timestamps)."""

    def __init__(self, data: bytes, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map_(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext_hook(code, bytes(self.take(n)))

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", lambda n: bytes(self.take(n))),
            0xC5: (">H", lambda n: bytes(self.take(n))),
            0xC6: (">I", lambda n: bytes(self.take(n))),
            0xC7: (">B", self.ext), 0xC8: (">H", self.ext), 0xC9: (">I", self.ext),
            0xD9: (">B", self.str_), 0xDA: (">H", self.str_), 0xDB: (">I", self.str_),
            0xDC: (">H", self.array), 0xDD: (">I", self.array),
            0xDE: (">H", self.map_), 0xDF: (">I", self.map_),
        }
        if b in sized:
            fmt, fn = sized[b]
            return fn(self.unpack(fmt))
        scalars = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in scalars:
            return self.unpack(scalars[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")


def unpackb(data: bytes, raw: bool = False):
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack value")
    return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    return np.frombuffer(buffer, dtype=np.dtype(name), count=-1, offset=0).reshape(
        shape, order="C"
    )


def _ext_hook(code: int, data: bytes):
    if code == 1:
        return _ndarray_from_bytes(data)
    if code == 2:
        re, im = unpackb(data)
        return complex(re, im)
    if code == 3:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore, without flax: nested dicts with
    numpy leaves."""
    return _unchunk(unpackb(data))


def load_stage2_net(path) -> dict[str, torch.Tensor]:
    """A stage-2 checkpoint's ``net_params`` -> ``DeformationNet`` state dict."""
    tree = msgpack_restore(Path(path).read_bytes())
    return state_dict_from_jax(tree["net_params"])


def load_stage2_run(run_dir, device="cuda") -> tuple[DeformationNet, dict]:
    """``stage2_ckpt.msgpack`` + ``stage2_result.json`` of a run directory ->
    (the network on ``device``, with the run's head settings; the result's
    ``head`` dict, which also holds ``quirk_compat``)."""
    run_dir = Path(run_dir)
    head = json.loads((run_dir / "stage2_result.json").read_text())["head"]
    sd = load_stage2_net(run_dir / "stage2_ckpt.msgpack")
    net = DeformationNet(net_config_for(sd, **{k: head[k] for k in HEAD_KNOBS}))
    net.load_state_dict(sd)
    return net.to(device), head


def load_stage2_opt_state(path) -> dict:
    """A stage-2 checkpoint's optax Adam state -> ``{"count": int, "mu": ...,
    "nu": ...}`` with ``mu`` / ``nu`` as ``DeformationNet`` state dicts
    (weights transposed like the parameters), ready for
    ``Stage2Adam.load_state``.  optax's ``adam`` state is a pair: the moments
    with their update count, and the schedule's own count (the same number).
    """
    tree = msgpack_restore(Path(path).read_bytes())["opt_state"]
    adam, schedule = tree["0"], tree["1"]
    count = int(adam["count"])
    if int(schedule["count"]) != count:
        raise ValueError("Adam and schedule counts differ in the checkpoint")
    return {
        "count": count,
        "mu": state_dict_from_jax(adam["mu"]),
        "nu": state_dict_from_jax(adam["nu"]),
    }
