"""The CMU-Panoptic / Dynamic-3D-Gaussians sequence layout (port of
``splatpu/data/dataset.py``).

- ``train_meta.json``: {"fn": [T][C] file names, "w", "h", "k": [T][C]
  intrinsics, "w2c": [T][C] extrinsics}; the camera lists may be ragged
  (dropped frames);
- ``init_pt_cld.npz``: "data", (N, 7) xyz | rgb | seg;
- ``ims/<cam>/<frame>.jpg`` images, ``seg/<cam>/<frame>.png`` binary masks
  (the name of the image with ".jpg" replaced by ".png").

Images are read through PIL where it is installed, else PNGs through the
port's own codec (``splatpu_torch.io.images``).  Everything here is host-side
numpy; the trainer stages it.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from splatpu_torch.io.images import have_pil, read_image, write_png


@dataclasses.dataclass
class ViewData:
    """One (timestep, camera) observation, host-side numpy."""

    camera_index: int
    w2c: np.ndarray           # (4, 4)
    K: np.ndarray             # (3, 3)
    width: int
    height: int
    image: np.ndarray         # (3, H, W) float32 in [0, 1], or uint8
    segmentation: np.ndarray  # (3, H, W) float32 channels (fg, 0, bg)


@dataclasses.dataclass
class SequenceMetadata:
    width: int
    height: int
    filenames: list[list[str]]    # [T][Ct]; Ct may vary per timestep
    intrinsics: list[np.ndarray]  # [T] of (Ct, 3, 3)
    extrinsics: list[np.ndarray]  # [T] of (Ct, 4, 4)

    @property
    def timestep_count(self) -> int:
        """Trainable timesteps: frames - 1."""
        return len(self.filenames) - 1

    @property
    def camera_count(self) -> int:
        return len(self.filenames[0])


def load_metadata(sequence_path) -> SequenceMetadata:
    """Per-timestep arrays, never one (T, C) block: the camera lists of a
    capture with dropped frames are ragged."""
    meta = json.loads((Path(sequence_path) / "train_meta.json").read_text())
    return SequenceMetadata(
        width=int(meta["w"]),
        height=int(meta["h"]),
        filenames=meta["fn"],
        intrinsics=[np.asarray(k, np.float32) for k in meta["k"]],
        extrinsics=[np.asarray(w, np.float32) for w in meta["w2c"]],
    )


def load_initial_point_cloud(sequence_path) -> np.ndarray:
    """(N, 7) xyz | rgb | seg."""
    with np.load(Path(sequence_path) / "init_pt_cld.npz") as data:
        return data["data"].astype(np.float32)


def get_scene_radius(metadata: SequenceMetadata) -> float:
    """1.1 times the largest distance of a timestep-0 camera centre from
    their mean."""
    centers = np.linalg.inv(metadata.extrinsics[0])[:, :3, 3]
    return float(1.1 * np.max(np.linalg.norm(centers - centers.mean(0, keepdims=True), axis=-1)))


def load_timestep_views(metadata: SequenceMetadata, timestep: int, sequence_path,
                        camera_indices: list[int] | None = None) -> list[ViewData]:
    """The views of one frame: image as float (3, H, W) / 255, binary mask
    as the channels (fg, 0, bg).  ``camera_indices`` loads a subset; each
    view keeps its global camera index."""
    sequence_path = Path(sequence_path)
    names = metadata.filenames[timestep]
    selected = (list(enumerate(names)) if camera_indices is None
                else [(c, names[c]) for c in camera_indices])
    views = []
    for camera_index, filename in selected:
        # Channels first in memory too: a transposed view would keep the
        # file's channel-last layout through every later stack and gather.
        img = np.ascontiguousarray(np.transpose(read_image(sequence_path / "ims" / filename),
                                                (2, 0, 1))).astype(np.float32) / 255.0
        seg = read_image(sequence_path / "seg" / filename.replace(".jpg", ".png"))
        seg = seg.astype(np.float32)
        views.append(ViewData(
            camera_index=camera_index,
            w2c=metadata.extrinsics[timestep][camera_index],
            K=metadata.intrinsics[timestep][camera_index],
            width=metadata.width,
            height=metadata.height,
            image=img,
            segmentation=np.stack([seg, np.zeros_like(seg), 1.0 - seg]),
        ))
    return views


def save_synthetic_sequence(path, images: np.ndarray, segmentations: np.ndarray,
                            intrinsics: np.ndarray, extrinsics: np.ndarray,
                            point_cloud: np.ndarray, image_suffix: str = ".jpg") -> None:
    """Write a sequence in the on-disk layout: ``images`` (T, C, 3, H, W) in
    [0, 1] (or uint8, written as they are), ``segmentations`` (T, C, H, W)
    binary, ``intrinsics`` (T, C, 3, 3), ``extrinsics`` (T, C, 4, 4),
    ``point_cloud`` (N, 7).  Images as JPEG (quality 95, through PIL, as the
    JAX package writes them) or, with ``image_suffix=".png"``, as PNG
    (through PIL, or the port's codec without it); masks as PNG."""
    if image_suffix not in (".jpg", ".png"):
        raise ValueError(f"image_suffix must be '.jpg' or '.png', got {image_suffix!r}")
    pil = have_pil()
    if image_suffix == ".jpg" and not pil:
        raise ImportError("writing JPEG images needs PIL (Pillow); pass image_suffix='.png'")
    path = Path(path)
    t_count, c_count = images.shape[:2]
    path.mkdir(parents=True, exist_ok=True)

    def save(file, arr, **kw):
        file.parent.mkdir(parents=True, exist_ok=True)
        if pil:
            from PIL import Image

            Image.fromarray(arr).save(file, **kw)
        else:
            write_png(file, arr)

    for t in range(t_count):
        for c in range(c_count):
            img = images[t, c]
            if img.dtype != np.uint8:
                img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            kw = {"quality": 95} if image_suffix == ".jpg" else {}
            save(path / "ims" / f"{c}" / f"{t:06d}{image_suffix}", img.transpose(1, 2, 0), **kw)
            save(path / "seg" / f"{c}" / f"{t:06d}.png", segmentations[t, c].astype(np.uint8))
    meta = {
        "w": int(images.shape[-1]),
        "h": int(images.shape[-2]),
        "fn": [[f"{c}/{t:06d}{image_suffix}" for c in range(c_count)] for t in range(t_count)],
        "k": np.asarray(intrinsics).tolist(),
        "w2c": np.asarray(extrinsics).tolist(),
    }
    (path / "train_meta.json").write_text(json.dumps(meta))
    np.savez(path / "init_pt_cld.npz", data=point_cloud.astype(np.float32))
