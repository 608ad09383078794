"""The port's sequence loader and writer against the JAX package's
(mirrors tests/test_dataset_quirks.py and
tests/test_io.py::test_synthetic_sequence_loader_roundtrip).

- the ragged fixture of test_dataset_quirks.py (frame 1 drops a camera):
  metadata, per-timestep views, scene radius and camera subsets identical
  to the JAX loader's, arrays bit for bit;
- a synthetic sequence written by each package loads identically through
  both loaders; the two writers' files are the same bytes;
- a PNG sequence (``image_suffix=".png"``) loads through the port's own
  codec where PIL is hidden, identically to PIL's reading; without PIL a
  JPEG is refused with an ImportError naming PIL.
"""

import builtins
from pathlib import Path

import numpy as np
import pytest
import torch

import splatpu.data.dataset as jds
import splatpu_torch.data.dataset as tds
from test_dataset_quirks import _write_fixture

torch.set_num_threads(1)


def assert_views_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.camera_index, g.width, g.height) == (w.camera_index, w.width, w.height)
        for k in ("w2c", "K", "image", "segmentation"):
            a, b = getattr(g, k), getattr(w, k)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


def assert_metadata_equal(got, want):
    assert (got.width, got.height, got.filenames) == (want.width, want.height, want.filenames)
    assert (got.timestep_count, got.camera_count) == (want.timestep_count, want.camera_count)
    for a, b in zip(got.intrinsics + got.extrinsics, want.intrinsics + want.extrinsics):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_ragged_sequence_matches_jax(tmp_path):
    _write_fixture(tmp_path)
    got, want = tds.load_metadata(tmp_path), jds.load_metadata(tmp_path)
    assert_metadata_equal(got, want)
    assert [len(f) for f in got.filenames] == [3, 2, 3] and got.timestep_count == 2
    for t in range(3):
        assert_views_equal(tds.load_timestep_views(got, t, tmp_path),
                           jds.load_timestep_views(want, t, tmp_path))
    assert tds.get_scene_radius(got) == jds.get_scene_radius(want)
    sub = tds.load_timestep_views(got, 0, tmp_path, camera_indices=[2, 0])
    assert [v.camera_index for v in sub] == [2, 0]
    assert_views_equal(sub, jds.load_timestep_views(want, 0, tmp_path, camera_indices=[2, 0]))


def synthetic(seed=0, t=2, c=3, h=24, w=32):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(t, c, 3, h, w)).astype(np.float32)
    segs = (rng.uniform(size=(t, c, h, w)) > 0.5).astype(np.float32)
    K = np.tile(np.eye(3, dtype=np.float32) * 20, (t, c, 1, 1))
    K[..., 2, 2] = 1
    w2c = np.tile(np.eye(4, dtype=np.float32), (t, c, 1, 1))
    w2c[..., 2, 3] = 4.0
    w2c[..., 0, 3] = np.arange(c, dtype=np.float32)[None, :]
    pc = rng.uniform(size=(50, 7)).astype(np.float32)
    return images, segs, K, w2c, pc


def test_synthetic_sequences_cross_both_ways(tmp_path):
    args = synthetic()
    jds.save_synthetic_sequence(tmp_path / "jax", *args)
    tds.save_synthetic_sequence(tmp_path / "port", *args)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    for f in files:
        if f.suffix != ".npz":  # npz members carry timestamps
            assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f
    for name in ("jax", "port"):
        seq = tmp_path / name
        md_t, md_j = tds.load_metadata(seq), jds.load_metadata(seq)
        assert_metadata_equal(md_t, md_j)
        assert md_t.timestep_count == 1 and md_t.camera_count == 3
        for t in range(2):
            assert_views_equal(tds.load_timestep_views(md_t, t, seq),
                               jds.load_timestep_views(md_j, t, seq))
        np.testing.assert_array_equal(tds.load_initial_point_cloud(seq),
                                      jds.load_initial_point_cloud(seq))
        assert tds.get_scene_radius(md_t) == jds.get_scene_radius(md_j) > 0
    views = tds.load_timestep_views(tds.load_metadata(tmp_path / "port"), 0, tmp_path / "port")
    assert abs(views[0].image.mean() - args[0][0, 0].mean()) < 0.05  # JPEG is lossy


@pytest.fixture
def no_pil(monkeypatch):
    real_import = builtins.__import__

    def fake_import(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(f"no module named {name!r}")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", fake_import)


def test_png_sequence_without_pil(tmp_path, no_pil):
    images, segs, K, w2c, pc = synthetic(1)
    tds.save_synthetic_sequence(tmp_path / "seq", images, segs, K, w2c, pc,
                                image_suffix=".png")
    md = tds.load_metadata(tmp_path / "seq")
    assert md.filenames[0][0].endswith(".png")
    views = tds.load_timestep_views(md, 1, tmp_path / "seq")
    for c, v in enumerate(views):
        # PNG is lossless: the levels written come back exactly.
        want = (np.clip(images[1, c], 0, 1) * 255).astype(np.uint8).astype(np.float32) / 255.0
        np.testing.assert_array_equal(v.image, want)
        np.testing.assert_array_equal(v.segmentation[0], segs[1, c])


def test_jpeg_without_pil_is_refused(tmp_path, no_pil):
    with pytest.raises(ImportError, match="PIL"):
        tds.save_synthetic_sequence(tmp_path / "seq", *synthetic(2))


def test_png_sequence_codec_matches_pil(tmp_path, monkeypatch):
    """The same PNG sequence through PIL and through the codec."""
    import splatpu_torch.io.images as images_mod

    tds.save_synthetic_sequence(tmp_path / "seq", *synthetic(3), image_suffix=".png")
    md = tds.load_metadata(tmp_path / "seq")
    with_pil = tds.load_timestep_views(md, 0, tmp_path / "seq")
    monkeypatch.setattr(images_mod, "have_pil", lambda: False)
    assert_views_equal(tds.load_timestep_views(md, 0, tmp_path / "seq"), with_pil)


def test_jax_loader_reads_port_png_sequence(tmp_path):
    tds.save_synthetic_sequence(tmp_path / "seq", *synthetic(4), image_suffix=".png")
    seq = Path(tmp_path / "seq")
    assert_views_equal(tds.load_timestep_views(tds.load_metadata(seq), 1, seq),
                       jds.load_timestep_views(jds.load_metadata(seq), 1, seq))
