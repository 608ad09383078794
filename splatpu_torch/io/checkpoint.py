"""Reading and writing what the JAX package reads and writes (port of
``splatpu/io/checkpoint.py``).

- ``load_cloud`` / ``save_cloud`` / ``compact_cloud``: the stage-1 ->
  stage-2 npz cloud (``CLOUD_KEYS`` order, compacted to a multiple of 256
  rows on save).
- ``msgpack_restore`` / ``to_bytes``: a reader and a writer of flax's
  msgpack checkpoints, in pure Python on numpy (no ``msgpack`` or ``flax``
  package needed).  flax packs ndarrays as msgpack ext type 1 holding
  ``packb((shape, dtype_name, bytes))``, numpy scalars as ext type 3 (the
  same payload, unpacked to a scalar), Python complex as ext type 2, lists,
  tuples and NamedTuples as maps (keyed "0", "1", ... or by field name),
  and arrays over 1 GiB as "chunked" maps.  ``to_bytes`` writes the bytes
  ``flax.serialization.to_bytes`` writes for the same tree.
- ``save_checkpoint`` / ``load_checkpoint``: a whole tree, written
  atomically through ``<path>.tmp``; always msgpack, whatever the suffix
  (the JAX package's orbax backend is not ported).
- ``stage1_checkpoint_tree`` / ``stage1_state_from_tree``: the stage-1
  checkpoint tree of ``splatpu/train/stage1.py`` (cloud, Adam state,
  densification statistics, key, iteration, budget), in both directions,
  so that a stage-1 checkpoint of either package resumes in the other.
- ``load_stage2_net``: a stage-2 checkpoint's ``net_params`` as a
  ``DeformationNet`` state dict; ``load_stage2_run``: the network of a
  stage-2 run directory with the head settings its result file records;
  ``load_stage2_opt_state`` / ``opt_state_from_tree`` /
  ``opt_state_to_tree``: its Adam state (count, first and second moments)
  in both directions.
- ``export_deformation_bundle`` / ``load_deformation_bundle``: the
  inference bundle (cloud npz, ``config.json``, ``network_params.msgpack``
  holding the JAX layout of the network's parameters).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

from splatpu_torch.core.types import CLOUD_PARAMS, GaussianCloud
from splatpu_torch.dynamics.network import (
    DeformationNet,
    net_config_for,
    net_params_to_jax_tree,
    state_dict_from_jax,
)

HEAD_KNOBS = ("delta_scale", "double_residual", "zero_init_head", "time_gate_head")
CLOUD_KEYS = CLOUD_PARAMS + ("alive",)
MAX_CHUNK_SIZE = 1 << 30  # bytes: larger arrays are written as chunked maps, as flax does
BUNDLE_CLOUD = "densified_initial_gaussian_cloud_parameters.npz"


def load_cloud(path, device="cuda") -> GaussianCloud:
    with np.load(Path(path)) as data:
        return GaussianCloud(**{k: torch.from_numpy(data[k]).to(device) for k in CLOUD_KEYS})


def compact_cloud(cloud: GaussianCloud, round_to: int = 256) -> GaussianCloud:
    """The alive rows packed to the front, the capacity shrunk to the
    smallest multiple of ``round_to`` that holds them (never above the
    cloud's own), the rows after them zero and dead."""
    idx = torch.nonzero(cloud.alive, as_tuple=True)[0]
    n = max(idx.numel(), 1)
    cap = min(-(-n // round_to) * round_to, cloud.capacity)

    def take(a):
        out = torch.zeros((cap,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        out[: idx.numel()] = a[idx]
        return out

    alive = torch.zeros((cap,), dtype=torch.bool, device=cloud.alive.device)
    alive[: idx.numel()] = True
    return GaussianCloud(alive=alive, **{k: take(getattr(cloud, k)) for k in CLOUD_PARAMS})


def save_cloud(path, cloud: GaussianCloud, compact: bool = True) -> None:
    if compact:
        cloud = compact_cloud(cloud)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{k: getattr(cloud, k).detach().cpu().numpy() for k in CLOUD_KEYS})


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


def _pack_uint(prefix_small: int, fixed_max: int, n: int, codes: bytes) -> bytes:
    """A length or count header: the fix form below ``fixed_max``, else the
    first of ``codes`` (8-, 16-, 32-bit forms) whose width holds ``n``."""
    if n < fixed_max:
        return bytes([prefix_small | n])
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of {n} entries is too large")


def _pack_int(x: int) -> bytes:
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        return struct.pack(">b" if x < 0 else ">B", x)
    for lo, hi, code, fmt in (
        (0, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"), (0, 0xFFFF, 0xCD, ">H"),
        (-0x8000, -1, 0xD1, ">h"), (0, 0xFFFFFFFF, 0xCE, ">I"), (-(1 << 31), -1, 0xD2, ">i"),
        (0, (1 << 64) - 1, 0xCF, ">Q"), (-(1 << 63), -1, 0xD3, ">q"),
    ):
        if lo <= x <= hi:
            return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError(f"integer {x} does not fit msgpack")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _pack_uint(0, 0, n, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + data


def packb(x) -> bytes:
    """msgpack of ``x`` as ``msgpack.packb(x, use_bin_type=True)`` writes it,
    with numpy arrays and scalars as flax's ext types 1 and 3.  Python
    lists and tuples are msgpack arrays (flax's ndarray payload holds its
    shape as one); nested trees are turned into dicts first
    (``to_state_dict``)."""
    out: list[bytes] = []
    _pack(x, out)
    return b"".join(out)


def _pack(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, np.ndarray):
        out.append(_pack_ext(1, _ndarray_to_bytes(x)))
    elif isinstance(x, np.generic):
        out.append(_pack_ext(3, _ndarray_to_bytes(np.asarray(x))))
    elif isinstance(x, int):
        out.append(_pack_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, complex):
        out.append(_pack_ext(2, packb((x.real, x.imag))))
    elif isinstance(x, str):
        b = x.encode("utf-8")
        out += [_pack_uint(0xA0, 32, len(b), (0xD9, 0xDA, 0xDB)), b]
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        out += [_pack_uint(0, 0, len(b), (0xC4, 0xC5, 0xC6)), b]
    elif isinstance(x, (list, tuple)):
        out.append(_pack_uint(0x90, 16, len(x), (0, 0xDC, 0xDD)))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        out.append(_pack_uint(0x80, 16, len(x), (0, 0xDE, 0xDF)))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack a {type(x).__name__}")


def _ndarray_to_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialised")
    return packb((a.shape, a.dtype.name, a.tobytes("C")))


def to_state_dict(tree):
    """flax.serialization.to_state_dict for the trees the port writes: dicts
    with their keys as strings, in order; lists and tuples as dicts keyed
    "0", "1", ...; NamedTuples as dicts keyed by field; tensors as numpy
    arrays (a 0-d tensor as a 0-d array, as a 0-d jax.Array becomes);
    numpy arrays, numpy scalars and Python scalars as they are."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: to_state_dict(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _chunk_large(tree):
    """Arrays over MAX_CHUNK_SIZE bytes as flax's chunked maps."""
    if isinstance(tree, dict):
        return {k: _chunk_large(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        size = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i : i + size] for i in range(0, flat.size, size)]
        return {
            "__msgpack_chunked_array__": True,
            "shape": {str(i): d for i, d in enumerate(tree.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)},
        }
    return tree


def to_bytes(tree) -> bytes:
    """flax.serialization.to_bytes, without flax."""
    return packb(_chunk_large(to_state_dict(tree)))


def save_checkpoint(path, tree) -> None:
    """Write ``tree`` (``to_bytes``) to ``path`` atomically, through
    ``<path>.tmp`` and a rename.  Always msgpack: a path without a suffix
    is a msgpack file too (the JAX package would take an orbax directory
    there, a backend the port does not have)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(to_bytes(tree))
    tmp.replace(path)


def _restore_into(template, state, path="/"):
    """flax.serialization.from_state_dict for dict / list / tuple templates:
    the state's keys must be the template's, leaf shapes must agree."""
    if isinstance(template, dict) or isinstance(template, (list, tuple)):
        keys = [str(k) for k in (template if isinstance(template, dict) else range(len(template)))]
        if not isinstance(state, dict) or set(state) != set(keys):
            got = sorted(state) if isinstance(state, dict) else type(state).__name__
            raise ValueError(f"checkpoint at {path}: keys {got} where the template has {keys}")
        if isinstance(template, dict):
            return {k: _restore_into(v, state[str(k)], f"{path}{k}/") for k, v in template.items()}
        return type(template)(_restore_into(v, state[k], f"{path}{k}/")
                              for k, v in zip(keys, template))
    shape = tuple(getattr(template, "shape", ()))
    if np.shape(state) != shape:
        raise ValueError(f"checkpoint at {path}: shape {np.shape(state)} where the template"
                         f" has {shape}")
    return state


def load_checkpoint(path, template=None):
    """The tree of a msgpack checkpoint (nested dicts of numpy arrays), or,
    given ``template``, restored into its structure, raising ``ValueError``
    where keys or shapes differ, as flax does."""
    state = msgpack_restore(Path(path).read_bytes())
    return state if template is None else _restore_into(template, state)


STAGE1_STATS = ("grad_accum", "vis_count", "max_radii")


def stage1_checkpoint_tree(cloud: GaussianCloud, adam, stats, key, i: int, max_pairs: int,
                           max_span: int, growths: int) -> dict:
    """A stage-1 checkpoint in the JAX package's layout: ``cloud`` (its
    fields in ``CLOUD_KEYS`` order), ``opt_state`` (optax's
    ``ScaleByAdamState``: ``count`` int32, ``mu`` and ``nu`` keyed in sorted
    order, as JAX's tree maps rebuild dicts), ``stats`` (``STAGE1_STATS``),
    ``key`` (uint32[2]), then ``i``, ``max_pairs``, ``max_span`` and
    ``growths`` (int32, 0-d).  ``adam``: a ``Stage1Adam``; ``stats``: a
    ``DensifyStats``."""
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return {
        "cloud": {k: getattr(cloud, k) for k in CLOUD_KEYS},
        "opt_state": {
            "count": i32(adam.count),
            "mu": {k: adam.mu[k] for k in sorted(adam.mu)},
            "nu": {k: adam.nu[k] for k in sorted(adam.nu)},
        },
        "stats": {k: getattr(stats, k) for k in STAGE1_STATS},
        "key": np.asarray(key, np.uint32),
        "i": i32(i),
        "max_pairs": i32(max_pairs),
        "max_span": i32(max_span),
        "growths": i32(growths),
    }


def stage1_state_from_tree(tree: dict, device="cuda") -> dict:
    """A restored stage-1 tree (``load_checkpoint`` into a
    ``stage1_checkpoint_tree`` template, or the part of one an older
    checkpoint holds) as the port's state: ``cloud`` a ``GaussianCloud``,
    ``opt_state`` the keywords of ``Stage1Adam.load_state``, ``stats`` the
    fields of ``DensifyStats``, ``key`` a uint32[2] array, and ``i``,
    ``max_pairs``, ``max_span``, ``growths`` as ints where present."""
    t = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    opt = tree["opt_state"]
    out = {
        "cloud": GaussianCloud(**{k: t(tree["cloud"][k]) for k in CLOUD_KEYS}),
        "opt_state": {"count": int(opt["count"]), "mu": {k: t(v) for k, v in opt["mu"].items()},
                      "nu": {k: t(v) for k, v in opt["nu"].items()}},
        "stats": {k: t(tree["stats"][k]) for k in STAGE1_STATS},
        "key": np.asarray(tree["key"], np.uint32),
    }
    out.update({k: int(tree[k]) for k in ("i", "max_pairs", "max_span", "growths") if k in tree})
    return out


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
    """A stage-2 checkpoint's optax Adam state -> ``opt_state_from_tree``."""
    return opt_state_from_tree(msgpack_restore(Path(path).read_bytes())["opt_state"])


def opt_state_from_tree(tree) -> dict:
    """optax's ``adam`` state as a checkpoint holds it (a dict keyed "0",
    "1", or the pair restored into a template) -> ``{"count": int,
    "mu": ..., "nu": ...}`` with ``mu`` / ``nu`` as ``DeformationNet`` state
    dicts (weights transposed like the parameters), ready for
    ``Stage2Adam.load_state``.  optax's ``adam`` state is a pair: the
    moments with their update count, and the schedule's own count (the same
    number)."""
    adam, schedule = (tree["0"], tree["1"]) if isinstance(tree, dict) else tree
    count = int(adam["count"])
    if int(schedule["count"]) != count:
        raise ValueError("Adam and schedule counts differ in the checkpoint")
    return {
        "count": count,
        "mu": state_dict_from_jax(adam["mu"]),
        "nu": state_dict_from_jax(adam["nu"]),
    }


def opt_state_to_tree(count: int, mu: dict, nu: dict) -> tuple:
    """The reverse of ``opt_state_from_tree``: the layout optax's ``adam``
    state has in a JAX checkpoint (``(ScaleByAdamState(count, mu, nu),
    ScaleByScheduleState(count))``, counts int32)."""
    c = np.asarray(count, np.int32)
    return (
        {"count": c, "mu": net_params_to_jax_tree(mu), "nu": net_params_to_jax_tree(nu)},
        {"count": c.copy()},
    )


def export_deformation_bundle(directory, net: DeformationNet, net_config: dict,
                              cloud: GaussianCloud) -> None:
    """The inference bundle: the cloud (compacted), ``config.json`` (tab
    indent) and the network's parameters in the JAX layout."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    save_cloud(directory / BUNDLE_CLOUD, cloud)
    with (directory / "config.json").open("w") as f:
        json.dump(net_config, f, indent="\t")
    (directory / "network_params.msgpack").write_bytes(to_bytes(net_params_to_jax_tree(net)))


def load_deformation_bundle(directory, device="cuda") -> tuple[GaussianCloud, dict, dict]:
    """(cloud on ``device``, the bundle's config, the network as a
    ``DeformationNet`` state dict)."""
    directory = Path(directory)
    cloud = load_cloud(directory / BUNDLE_CLOUD, device=device)
    config = json.loads((directory / "config.json").read_text())
    sd = state_dict_from_jax(msgpack_restore((directory / "network_params.msgpack").read_bytes()))
    return cloud, config, sd
