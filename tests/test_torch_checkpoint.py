"""The port's flax-msgpack reader and npz cloud loader against flax and the
JAX package, bit for bit."""

from pathlib import Path

import numpy as np
import pytest
import torch
from flax import serialization

from splatpu.io.checkpoint import load_cloud as jax_load_cloud
from splatpu_torch.dynamics.network import DeformationNet, net_config_for
from splatpu_torch.io.checkpoint import load_cloud, load_stage2_net, load_stage2_run, msgpack_restore
from _torch_scenes import np_of

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
STAGE2 = ROOT / "runs" / "config3_100k_r5" / "stage2_ckpt.msgpack"
CLOUD = ROOT / "runs" / "s1_ceiling_r4b" / "densified_cloud.npz"


def assert_same_tree(a, b, path="/"):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}{k}/")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}{i}/")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, np.generic):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


def test_stage2_checkpoint_bit_exact():
    data = STAGE2.read_bytes()
    assert_same_tree(msgpack_restore(data), serialization.msgpack_restore(data))


def test_synthetic_tree_bit_exact():
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "f64": rng.normal(size=(2,)),
        "i8": np.arange(-4, 4, dtype=np.int8),
        "u16": np.arange(7, dtype=np.uint16).reshape(7, 1),
        "bool": np.array([True, False]),
        "scalar_i32": np.int32(-7),
        "scalar_f32": np.float32(2.5),
        "empty": np.zeros((0, 3), np.float32),
        "big": rng.normal(size=(70000,)).astype(np.float32),
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, -1, -32, -33, -129, -40000,
                 2**32, -(2**40)],
        "floats": [0.5, -1e300],
        "text": "x" * 40,
        "none": None,
        "flags": [True, False],
        "nested": {"deep": {"list": [np.ones(2, np.float32), {"k": 3}]}},
        "many": {str(i): i for i in range(20)},
        "complex": 1.5 - 2j,
    }
    data = serialization.msgpack_serialize(tree)
    assert_same_tree(msgpack_restore(data), serialization.msgpack_restore(data))


def test_truncated_data_raises():
    data = serialization.msgpack_serialize({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError):
        msgpack_restore(data[:-3])


def test_load_stage2_net_full_width():
    sd = load_stage2_net(STAGE2)
    net = DeformationNet(net_config_for(sd))
    net.load_state_dict(sd)
    cfg = net.config
    assert (cfg.hidden_dim, cfg.residual_blocks, cfg.input_dim, cfg.output_dim) == (128, 3, 192, 7)
    ref = serialization.msgpack_restore(STAGE2.read_bytes())["net_params"]
    np.testing.assert_array_equal(np_of(net.fc_in.weight), ref["fc_in"]["w"].T)
    np.testing.assert_array_equal(np_of(net.blocks[2].bn2.weight), ref["blocks"]["2"]["bn2"]["gamma"])


def test_load_cloud_matches_jax():
    got = load_cloud(CLOUD, device="cpu")
    ref = jax_load_cloud(CLOUD)
    for k in ("means", "colors", "segmentation_masks", "rotation_quaternions",
              "opacity_logits", "log_scales", "alive"):
        a, b = np_of(getattr(got, k)), np_of(getattr(ref, k))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert int(got.alive.sum()) == 100585


def test_load_stage2_run_head_settings():
    net, head = load_stage2_run(STAGE2.parent, device="cpu")
    cfg = net.config
    assert head["quirk_compat"] is False
    assert (cfg.delta_scale, cfg.double_residual, cfg.zero_init_head, cfg.time_gate_head) == (
        head["delta_scale"], head["double_residual"], head["zero_init_head"], head["time_gate_head"])
    sd = load_stage2_net(STAGE2)
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k
