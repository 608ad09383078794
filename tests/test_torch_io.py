"""The port's writers against the JAX package's and flax's, and its image
codec against PIL.

- ``to_bytes`` byte for byte against ``flax.serialization.to_bytes``: on
  runs/config3_100k_r5/stage2_ckpt.msgpack read back and rewritten, on a
  stage-2 checkpoint that a tiny JAX run writes, and on synthetic trees
  (0-d int32 arrays, numpy scalars, empty NamedTuple states, nested
  tuples and lists, every msgpack integer width);
- ``compact_cloud``, ``save_cloud`` and ``load_cloud`` against the JAX
  package's, both ways, arrays bit for bit;
- a deformation bundle exported by each package loads in the other with
  equal arrays and an equal ``config.json``;
- the PNG codec: its decode equals PIL's on seeded images under each of the
  five scanline filters and on PIL's own PNGs; PIL reads its encoding back
  exactly.
"""

import io
import struct
import zlib
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from PIL import Image

import splatpu.data.dataset as jds
import splatpu.io.checkpoint as jckpt
import splatpu.train.stage2 as js2
from splatpu.dynamics.network import DeformationNetConfig as JNetConfig
from splatpu.dynamics.network import init_deformation_net as jinit
from splatpu_torch.core import prng
import splatpu_torch.io.checkpoint as tckpt
from splatpu_torch.dynamics.network import (
    DeformationNet,
    DeformationNetConfig,
    init_deformation_net,
    net_params_to_jax_tree,
    state_dict_from_jax,
)
from splatpu_torch.io.images import decode_png, encode_png
from _torch_scenes import jax_cloud, np_cloud, np_lookat, np_of, torch_cloud

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
STAGE2 = ROOT / "runs" / "config3_100k_r5" / "stage2_ckpt.msgpack"


def test_writer_rewrites_config3_checkpoint_byte_for_byte():
    data = STAGE2.read_bytes()
    assert tckpt.to_bytes(tckpt.msgpack_restore(data)) == data
    assert serialization.to_bytes(serialization.msgpack_restore(data)) == data


def test_writer_matches_flax_on_a_jax_stage2_checkpoint(tmp_path):
    """A tiny JAX stage-2 run's own checkpoint, read back and rewritten by
    the port, byte for byte."""
    rng = np.random.default_rng(4)
    w2c, K = np_lookat((0.3, 0.2, -3.5), 24, 16)
    vs = [[jds.ViewData(camera_index=0, w2c=w2c, K=K, width=24, height=16,
                        image=rng.uniform(size=(3, 16, 24)).astype(np.float32),
                        segmentation=np.zeros((3, 16, 24), np.float32))]]
    ckpt = tmp_path / "ckpt.msgpack"
    cfg = js2.Stage2Config(total_iterations=1, warmup_iterations=1, hidden_dim=8,
                           residual_blocks=1, views_per_step=1, timestep_count=1,
                           renderer="stream", compute_dtype="float32", checkpoint_every=1,
                           checkpoint_path=str(ckpt))
    js2.train(jax_cloud(np_cloud(4, 64)), vs, cfg)
    data = ckpt.read_bytes()
    tree = tckpt.msgpack_restore(data)
    assert list(tree) == ["net_params", "opt_state", "seq_it", "max_pairs", "max_span", "growths"]
    assert tckpt.to_bytes(tree) == data


class Pair(NamedTuple):
    a: object
    b: object


SYNTHETIC_TREES = {
    # jax arrays as numpy (jax.tree.map also sorts the dict keys, as a
    # jitted step's output has them): the port takes no jax.Array.
    "stage2_like": lambda: jax.tree.map(np.asarray, {
        "net_params": jinit(jax.random.key(0), JNetConfig(8, 2)),
        "opt_state": optax.adam(1e-3).init(jinit(jax.random.key(0), JNetConfig(8, 2))),
        "seq_it": jnp.int32(7),
    }),
    "zero_d": lambda: {"a": np.asarray(3, np.int32), "b": np.asarray(-1.5, np.float32),
                       "c": np.int32(-7), "d": np.float32(2.5)},
    "empty_states": lambda: {"empty": optax.EmptyState(), "tuple": (), "dict": {},
                             "chain": (optax.EmptyState(), optax.EmptyState())},
    "nested_tuples": lambda: {"t": (1, (2.5, (np.ones(3, np.float32), [4, "x" * 40]))),
                              "nt": Pair(np.arange(5, dtype=np.int64), Pair(None, True))},
    "scalars": lambda: {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, -1, -32, -33, -128,
                                 -129, -40000, 2**31, 2**32, -(2**40), 2**63],
                        "floats": [0.5, -1e300], "text": "y" * 300, "flags": [True, False],
                        "many": {str(i): i for i in range(20)},
                        "arrays": [np.zeros((0, 3), np.float32), np.arange(70000, dtype=np.uint8),
                                   np.array([True, False]), np.ones((2, 2), np.float16)]},
}


@pytest.mark.parametrize("name", list(SYNTHETIC_TREES))
def test_writer_matches_flax_on_synthetic_trees(name):
    tree = SYNTHETIC_TREES[name]()
    assert tckpt.to_bytes(tree) == serialization.to_bytes(SYNTHETIC_TREES[name]())


def test_checkpoint_round_trip_and_template(tmp_path):
    """save_checkpoint writes through <path>.tmp (none left behind);
    load_checkpoint restores into a template and refuses other keys or
    shapes with ValueError, as flax does."""
    tree = {"w": np.ones((2, 3), np.float32), "blocks": [{"x": np.zeros(2)}], "it": np.int32(1)}
    path = tmp_path / "ckpt"  # no suffix: msgpack all the same
    tckpt.save_checkpoint(path, tree)
    assert path.read_bytes() == serialization.to_bytes(tree)
    assert not list(tmp_path.glob("*.tmp"))
    back = tckpt.load_checkpoint(path, tree)
    assert isinstance(back["blocks"], list) and np.array_equal(back["w"], tree["w"])
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, {"w": tree["w"], "it": tree["it"]})
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, dict(tree, w=np.ones((3, 2), np.float32)))


def assert_cloud_equal(a, b):
    for k in tckpt.CLOUD_KEYS:
        x, y = np_of(getattr(a, k)), np_of(getattr(b, k))
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), k


def test_compact_cloud_matches_jax():
    c = np_cloud(5, 600, n_dead=100)
    c["alive"][::7] = False
    for round_to in (256, 64):
        assert_cloud_equal(tckpt.compact_cloud(torch_cloud(c), round_to),
                           jckpt.compact_cloud(jax_cloud(c), round_to))


def test_cloud_files_cross_both_ways(tmp_path):
    c = np_cloud(6, 600, n_dead=400)  # 200 alive: compacted to 256 rows
    tckpt.save_cloud(tmp_path / "port.npz", torch_cloud(c))
    jckpt.save_cloud(tmp_path / "jax.npz", jax_cloud(c))
    for name in ("port.npz", "jax.npz"):
        assert_cloud_equal(tckpt.load_cloud(tmp_path / name, device="cpu"),
                           jckpt.load_cloud(tmp_path / name))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files == list(tckpt.CLOUD_KEYS)
        assert a["means"].shape[0] == 256


BUNDLE_CONFIG = {"timestep_count": 3, "residual_block_count": 2, "hidden_dimension": 16}


def test_bundles_cross_both_ways(tmp_path):
    c = np_cloud(7, 300)
    jcfg = JNetConfig(hidden_dim=16, residual_blocks=2)
    j_params = jinit(jax.random.key(1), jcfg)
    jckpt.export_deformation_bundle(tmp_path / "jax", j_params, BUNDLE_CONFIG, jax_cloud(c))
    net = init_deformation_net(prng.key(2), DeformationNetConfig(hidden_dim=16, residual_blocks=2),
                               device="cpu")
    tckpt.export_deformation_bundle(tmp_path / "port", net, BUNDLE_CONFIG, torch_cloud(c))
    assert ((tmp_path / "jax" / "config.json").read_bytes()
            == (tmp_path / "port" / "config.json").read_bytes())

    # The JAX bundle in the port.
    cloud, cfg, sd = tckpt.load_deformation_bundle(tmp_path / "jax", device="cpu")
    assert cfg == BUNDLE_CONFIG
    assert_cloud_equal(cloud, jckpt.load_cloud(tmp_path / "jax" / tckpt.BUNDLE_CLOUD))
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_params))
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)
    DeformationNet(DeformationNetConfig(hidden_dim=16, residual_blocks=2)).load_state_dict(sd)

    # The port's bundle in the JAX package.
    j_cloud, j_cfg, j_back = jckpt.load_deformation_bundle(tmp_path / "port", j_params)
    assert j_cfg == BUNDLE_CONFIG
    assert_cloud_equal(tckpt.load_cloud(tmp_path / "port" / tckpt.BUNDLE_CLOUD, device="cpu"),
                       j_cloud)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(net_params_to_jax_tree(net)),
                            jax.tree.leaves(j_back)):
        assert np.array_equal(np.asarray(g), w), jax.tree_util.keystr(path)


def _filtered_png(img: np.ndarray, filter_type: int) -> bytes:
    """A PNG of ``img`` whose every row uses ``filter_type`` (encoded here,
    per the PNG specification, to drive the decoder's filters)."""
    h = img.shape[0]
    bpp = 1 if img.ndim == 2 else 3
    rows = img.reshape(h, -1).astype(np.int64)
    out = []
    for y in range(h):
        x, up = rows[y], rows[y - 1] if y else np.zeros_like(rows[0])
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if filter_type == 0:
            f = x
        elif filter_type == 1:
            f = x - left
        elif filter_type == 2:
            f = x - up
        elif filter_type == 3:
            f = x - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            f = x - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([filter_type]) + (f % 256).astype(np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", img.shape[1], h, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


def seeded_images():
    rng = np.random.default_rng(8)
    smooth = np.clip(np.cumsum(rng.integers(-3, 4, (23, 31, 3)), axis=1) + 128, 0, 255)
    return {"rgb_noise": rng.integers(0, 256, (17, 29, 3), dtype=np.uint8),
            "rgb_smooth": smooth.astype(np.uint8),
            "grey": rng.integers(0, 256, (19, 13), dtype=np.uint8),
            "mask": (rng.uniform(size=(16, 21)) > 0.5).astype(np.uint8)}


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_decode_matches_pil_under_each_filter(filter_type):
    for name, img in seeded_images().items():
        data = _filtered_png(img, filter_type)
        want = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(want, img, err_msg=name)
        np.testing.assert_array_equal(decode_png(data), want, err_msg=name)


def test_png_codec_against_pil_files():
    for name, img in seeded_images().items():
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        np.testing.assert_array_equal(decode_png(buf.getvalue()), img, err_msg=name)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(img)))), img,
                                      err_msg=name)
