"""The port's bench entry (``bench_torch.py``) and the pieces it needs.

- bench_torch's forward + backward at bench.py's CPU size (2,000 Gaussians,
  256x256, ``default_config(n)``): the loss against ``bench.py``'s loss
  built from the JAX package (``make_random_cloud(jax.random.key(0), ...)``,
  ``impl="stream"`` as bench.py runs off the TPU), 1e-5 relative, and the
  gradients of the five parameter groups against ``jax.grad`` of it, scaled
  by the reference's largest gradient, atol 1e-4 (the tolerance of
  ``tests/test_torch_grad.py``);
- ``main(device="cpu")``'s output: a last line with exactly the keys of
  ``bench.py``'s JSON line (read from its source), and with ``chained`` a
  second line with the keys of its chained line;
- no card and no ``--device cpu``: ``main`` and the script exit non-zero;
- ``obs.profiling.time_fn``'s ``args_fn`` gets every call's index;
- ``io.video.write_video`` without imageio: the GIF imageio writes, byte
  for byte, its frames, duration and loop.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from splatpu.core.types import activate_cloud as jax_activate_cloud
from splatpu.data.synthetic import make_lookat_camera as jax_lookat_camera
from splatpu.data.synthetic import make_random_cloud as jax_random_cloud
from splatpu.render.api import default_config as jax_default_config
from splatpu.render.api import render as jax_render
from splatpu_torch.io import video
from splatpu_torch.obs import profiling

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench_torch  # noqa: E402

torch.set_num_threads(1)

GRAD_ATOL = 1e-4
LOSS_RTOL = 1e-5


def bench_py_keys() -> list[set]:
    """The key sets of the dicts that ``bench.py`` prints, in order."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    return [{k.value for k in node.args[0].keys}
            for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"]


@pytest.fixture(scope="module")
def jax_bench():
    """bench.py's loss and gradients off the TPU, from the JAX package."""
    n, (w, h) = bench_torch.CPU_GAUSSIANS, bench_torch.CPU_SIZE
    cloud = jax_random_cloud(jax.random.key(0), n, extent=1.2, scale_range=(0.005, 0.02))
    cam = jax_lookat_camera(eye=(0, 0, -4.0), width=w, height=h, focal=0.8 * w)
    config = jax_default_config(n)
    target = jnp.zeros((3, h, w))

    def loss(params):
        c = cloud.replace(**params)
        out = jax_render(jax_activate_cloud(c), cam, impl="stream", config=config)
        return jnp.mean(jnp.abs(out.image - target)) + 0.1 * jnp.mean(out.depth)

    value, grads = jax.jit(jax.value_and_grad(loss))(cloud.param_dict())
    return float(value), {k: np.asarray(v) for k, v in grads.items()}, config


def test_bench_gradients_match_jax(jax_bench):
    ref_loss, ref_grads, jax_config = jax_bench
    cloud, cam, config = bench_torch.scene("cpu")
    assert (config.tile, config.chunk_pairs, config.max_pairs, config.max_span) == (
        jax_config.tile, jax_config.chunk_pairs, jax_config.max_pairs, jax_config.max_span)
    target = torch.zeros((3, cam.height, cam.width))
    loss, out, grads = bench_torch.loss_and_grads(cloud, cloud.param_dict(), cam, config, target)
    assert not bool(out.overflowed.any())
    assert float(loss) == pytest.approx(ref_loss, rel=LOSS_RTOL)
    assert set(grads) == set(bench_torch.GRADS)
    for k, g in grads.items():
        ref = ref_grads[k]
        scale = np.abs(ref).max()
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy() / scale, ref / scale, rtol=0, atol=GRAD_ATOL,
                                   err_msg=k)


def test_main_prints_bench_py_lines(monkeypatch, capsys):
    """At a cut size (the lines' form, not the numbers, is under test)."""
    for name, value in (("CPU_GAUSSIANS", 100), ("CPU_SIZE", (64, 64)), ("WARMUP", 1),
                        ("ITERS", 2), ("CHAIN", 2), ("CHAIN_ITERS", 1)):
        monkeypatch.setattr(bench_torch, name, value)
    headline_keys, chained_keys = bench_py_keys()
    result = bench_torch.main(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == headline_keys
    assert last["metric"] == "rasterize_fwd_bwd_ms_per_frame" and last["unit"] == "ms"
    assert last["chain_length"] == 2 and last["value"] > 0 and last["chained_ms_per_frame"] > 0
    assert "overflowed false" in lines and result["overflowed"] is False
    assert all(v == 0 for v in result["launches"].values())  # plain versions count nothing

    bench_torch.main(chained=2, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert set(json.loads(lines[-2])) == headline_keys
    second = json.loads(lines[-1])
    assert set(second) == chained_keys
    assert second["metric"] == "rasterize_fwd_bwd_ms_per_frame_chained"
    assert second["chain_length"] == 2


def test_no_card_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench_torch.main()
    assert exc.value.code not in (0, None) and "CUDA" in str(exc.value.code)
    # The script itself, where this machine has no card.
    if not torch.cuda.is_available():
        run = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode != 0 and "no CUDA device" in run.stderr
        assert not run.stdout.strip()


def test_time_fn_passes_each_call_its_index():
    asked, called = [], []

    def args_fn(i):
        asked.append(i)
        return (i, 10 * i)

    stats = profiling.time_fn(lambda a, b: called.append((a, b)), warmup=2, iters=5,
                              args_fn=args_fn, batches=2, device="cpu")
    assert asked == list(range(-3, 5))
    assert called == [(i, 10 * i) for i in range(-3, 5)]
    assert stats["iters"] == 5 and stats["timer"] == "host_clock"


@pytest.mark.parametrize("fps", [30, 8])
def test_gif_without_imageio_is_imageios(tmp_path, monkeypatch, fps):
    rng = np.random.default_rng(fps)
    frames = [rng.integers(0, 256, (72, 128, 3), dtype=np.uint8) for _ in range(5)]
    ref = tmp_path / "ref.gif"
    imageio.mimwrite(ref, frames, duration=1000.0 / fps, loop=0)
    monkeypatch.setattr(video, "have_imageio", lambda: False)
    path = video.write_video(tmp_path / "out" / "cam.mp4", frames, fps=fps)
    assert path == tmp_path / "out" / "cam.gif"
    assert path.read_bytes() == ref.read_bytes()
    with Image.open(path) as im:
        assert im.n_frames == len(frames)
        assert im.info["loop"] == 0
        assert im.info["duration"] == 10 * int(100 / fps)  # centiseconds in the file
