"""The port's command lines.

- ``cli.train``'s parser has every option of the JAX package's
  (positionals, flags, defaults, choices, types) and one more,
  ``--device``; ``cli.render``'s likewise;
- ``--mesh-tiles`` above 1 without ``--mesh-cameras`` trains in one
  process with the losses of the run without it, as the JAX package's
  ignores it (the distributed step is held in test_torch_dist_train.py and
  test_torch_process.py);
- the JAX package's renderer names: ``resolve_impl`` takes "pallas" and
  "pallas_padded" as the exact and padded paths' CUDA kernels for CUDA
  tensors and their plain versions for CPU tensors; ``cli.densify``,
  ``cli.train`` and ``cli.render`` run on the CPU with ``--renderer pallas``
  and ``--renderer pallas_padded``;
- a port-only run on the CPU of a tiny sequence (3 frames, 3 cameras at
  32x24, 200 Gaussians): ``cli.train`` with host staging and a checkpoint
  every iteration, ``cli.train`` again resumed from that checkpoint with
  device_rotate staging, then ``cli.render`` of the bundle; every artifact
  written, the resumed run's first step the one after the checkpoint, and
  the standalone render's frames equal to the trainer's inference frames.
  The orbit render is shrunk to 64x36 through the inference module's
  ``RENDER_WIDTH`` / ``RENDER_HEIGHT`` (monkeypatched), which
  ``run_inference`` reads at the call.
"""

import argparse
import json

import numpy as np
import pytest
import torch

import splatpu.cli.render as jrender
import splatpu.cli.train as jtrain
import splatpu.obs.cache
import splatpu_torch.cli.densify as tdensify
import splatpu_torch.cli.render as trender
import splatpu_torch.cli.train as ttrain
import splatpu_torch.train.inference as tinference
from splatpu_torch.data.dataset import save_synthetic_sequence
from splatpu_torch.core import prng
from splatpu_torch.data.synthetic import lookat_matrices, make_random_cloud
from splatpu_torch.io.checkpoint import load_checkpoint, save_cloud
from splatpu_torch.io.images import read_image
from splatpu_torch.render.api import resolve_impl

torch.set_num_threads(1)


class Captured(Exception):
    pass


def jax_parser(main, monkeypatch):
    """The parser a JAX CLI's ``main`` builds (its parse_args intercepted,
    the compilation cache left alone)."""
    monkeypatch.setattr(splatpu.obs.cache, "enable_compilation_cache", lambda *a, **kw: None)

    def capture(self, *a, **kw):
        raise Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Captured) as info:
        main([])
    monkeypatch.undo()
    return info.value.args[0]


def options(p: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs,
                     type(a).__name__) for a in p._actions if a.dest != "help"}


@pytest.mark.parametrize("jax_main,port_parser", [(jtrain.main, ttrain.parser),
                                                   (jrender.main, trender.parser)],
                         ids=["train", "render"])
def test_parser_matches_jax(jax_main, port_parser, monkeypatch):
    want = options(jax_parser(jax_main, monkeypatch))
    got = options(port_parser())
    assert list(got) == list(want) + ["device"]
    assert {k: v for k, v in got.items() if k != "device"} == want
    assert got["device"][:2] == (("--device",), "cuda")


def test_mesh_tiles_refused(sequence, monkeypatch):
    """No longer refused: ``--mesh-tiles 2`` without ``--mesh-cameras``
    trains in this one process, as the JAX package's ``cli.train`` does,
    and logs the losses of the same run without the flag."""
    monkeypatch.setattr(tinference, "RENDER_WIDTH", 64)
    monkeypatch.setattr(tinference, "RENDER_HEIGHT", 36)

    def no_ranks(*a, **kw):
        raise AssertionError("ranks started")

    monkeypatch.setattr(ttrain, "main_on_ranks", no_ranks)

    def losses(out, *extra):
        ttrain.main(["seq", str(sequence), "1", "1", "0.001", "16", "1", "-t", "2", "-o",
                     str(out), "--device", "cpu", "--renderer", "plain", *extra])
        rows = (out / "seq" / "train_metrics.jsonl").read_text().splitlines()
        return [r["total"] for r in map(json.loads, rows) if "total" in r]

    tiled = losses(sequence / "tiled", "--mesh-tiles", "2")
    assert len(tiled) == 2 and tiled == losses(sequence / "one")


W, H, T, C = 32, 24, 3, 3


@pytest.fixture
def sequence(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(T, C, 3, H, W)).astype(np.float32)
    segs = (rng.uniform(size=(T, C, H, W)) > 0.5).astype(np.float32)
    cams = [lookat_matrices((3.5 * np.sin(a), 0.3, -3.5 * np.cos(a)), width=W, height=H)
            for a in 2 * np.pi * np.arange(C) / C]
    w2c = np.tile(np.stack([c[0] for c in cams])[None], (T, 1, 1, 1))
    K = np.tile(np.stack([c[1] for c in cams])[None], (T, 1, 1, 1))
    seq = tmp_path / "seq"
    save_synthetic_sequence(seq, images, segs, K, w2c, rng.uniform(size=(50, 7)).astype(np.float32))
    save_cloud(seq / "densified_initial_gaussian_cloud_parameters.npz",
               make_random_cloud(prng.key(0), 200, device="cpu"))
    return tmp_path


def test_train_resume_render_on_cpu(sequence, monkeypatch):
    monkeypatch.setattr(tinference, "RENDER_WIDTH", 64)
    monkeypatch.setattr(tinference, "RENDER_HEIGHT", 36)
    out, ckpt = sequence / "out", sequence / "ckpt.msgpack"
    head = ["--zero-init-head", "--time-gate-head", "--delta-scale", "1.0",
            "--no-double-residual"]
    common = ["-t", "2", "-o", str(out), "--device", "cpu", "--renderer", "plain",
              "--checkpoint-every", "1", "--checkpoint-path", str(ckpt), *head]
    ttrain.main(["seq", str(sequence), "2", "1", "0.001", "16", "1", *common,
                 "--view-staging", "host"])
    run = out / "seq"
    assert int(load_checkpoint(ckpt)["seq_it"]) == 1
    first = [json.loads(x) for x in (run / "train_metrics.jsonl").read_text().splitlines()]
    ttrain.main(["seq", str(sequence), "3", "1", "0.001", "16", "1", *common,
                 "--view-staging", "device_rotate", "--resident-cameras", "2",
                 "--restage-every", "1", "--resume-from", str(ckpt)])
    rows = [json.loads(x) for x in (run / "train_metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in rows if "total" in r]
    assert steps == [1, 2, 3, 4, 5, 6]  # the resumed run starts at step 5
    assert len(first) == 4 + 2  # 4 steps and 2 mean-image-loss rows
    evals = [r for r in rows if "mean-image-loss" in r]
    assert [r["step"] for r in evals] == [5, 6, 7, 8]  # total_iterations * T + t, both runs
    assert all(np.isfinite(r["total"]) for r in rows if "total" in r)
    assert all(np.isfinite(r["mean-image-loss"]) for r in evals)
    assert int(load_checkpoint(ckpt)["seq_it"]) == 2

    bundle = run / "deformation_network"
    for f in ("densified_initial_gaussian_cloud_parameters.npz", "config.json",
              "network_params.msgpack"):
        assert (bundle / f).is_file(), f
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["timestep_count"] == 2 and cfg["device"] == "cpu"
    bundle_cfg = json.loads((bundle / "config.json").read_text())
    assert bundle_cfg["time_gate_head"] is True and bundle_cfg["delta_scale"] == 1.0
    vis = run / "visualizations"
    names = ["000", "090", "180", "270", "top"]
    for name in names:
        assert sorted(p.name for p in (vis / "frames" / name).iterdir()) == [
            "000000.png", "000001.png", "000002.png"]
        assert list(vis.glob(f"{name}.*")), name  # the video (GIF without ffmpeg)

    trender.main([str(bundle), "--timesteps", "2", "--width", "64", "--height", "36",
                  "--device", "cpu", "--renderer", "plain"])
    for name in names:
        for t in range(3):
            a = read_image(bundle / "renders" / "frames" / name / f"{t:06d}.png").astype(int)
            b = read_image(vis / "frames" / name / f"{t:06d}.png").astype(int)
            assert a.shape == (36, 64, 3) and np.abs(a - b).max() <= 1, (name, t)


def test_jax_renderer_names(sequence, monkeypatch):
    for device, exact, padded in (("cpu", "plain", "plain_padded"),
                                  ("cuda", "cuda", "cuda_padded")):
        assert resolve_impl("pallas", torch.device(device)) == exact
        assert resolve_impl("pallas_padded", torch.device(device)) == padded
    monkeypatch.setattr(tinference, "RENDER_WIDTH", 64)
    monkeypatch.setattr(tinference, "RENDER_HEIGHT", 36)
    seq, out = sequence / "seq", sequence / "out"
    for renderer in ("pallas", "pallas_padded"):
        tdensify.main([str(seq), "--iterations", "2", "--device", "cpu", "--renderer", renderer,
                       "--tile", "16"])
        rows = [json.loads(x) for x in (seq / "densify_metrics.jsonl").read_text().splitlines()]
        assert all(np.isfinite(r["total_loss"]) for r in rows[-2:])
        ttrain.main(["seq", str(sequence), "1", "1", "0.001", "16", "1", "-t", "1", "-o",
                     str(out / renderer), "--device", "cpu", "--renderer", renderer,
                     "--tile", "16"])
        bundle = out / renderer / "seq" / "deformation_network"
        trender.main([str(bundle), "--timesteps", "1", "--width", "32", "--height", "24",
                      "--device", "cpu", "--renderer", renderer])
        assert (bundle / "renders" / "frames" / "000" / "000001.png").is_file()
