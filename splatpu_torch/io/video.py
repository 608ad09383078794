"""Frame and video export (port of ``splatpu/io/video.py``).

Frames go through imageio where it is installed, as in the JAX package,
else through the port's PNG codec (``splatpu_torch.io.images``).  A video is
an MP4 through imageio, or a GIF where imageio has no MP4 writer or is not
installed: the GIF the JAX package's fallback writes, through PIL.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from splatpu_torch.io.images import write_png


def have_imageio() -> bool:
    try:
        import imageio  # noqa: F401
    except ImportError:
        return False
    return True


def to_uint8_frame(image_chw) -> np.ndarray:
    """(3, H, W) float -> (H, W, 3) uint8, clipped and truncated."""
    return (255.0 * np.clip(np.asarray(image_chw), 0.0, 1.0)).astype(np.uint8).transpose(1, 2, 0)


def write_frame(path, frame: np.ndarray) -> np.ndarray:
    """Write an (H, W, 3) uint8 frame (or a (3, H, W) float image, converted
    by ``to_uint8_frame``) as an image file; returns the uint8 frame."""
    if frame.dtype != np.uint8:
        frame = to_uint8_frame(frame)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if have_imageio():
        import imageio

        imageio.imwrite(path, frame)
    else:
        write_png(path, frame)
    return frame


def write_video(path, frames: list[np.ndarray], fps: int = 30) -> Path:
    """An MP4 of ``frames``, or a GIF beside it (``path`` with the suffix
    ``.gif``, 1000 / fps ms per frame, looping) where imageio writes no MP4
    or is not installed; returns the path written."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    gif = path.with_suffix(".gif")
    if not have_imageio():
        from PIL import Image

        first, *rest = (Image.fromarray(f) for f in frames)
        first.save(gif, save_all=True, append_images=rest, duration=1000.0 / fps, loop=0)
        return gif
    import imageio

    try:
        imageio.mimwrite(path, frames, fps=fps)
        return path
    except Exception:
        imageio.mimwrite(gif, frames, duration=1000.0 / fps, loop=0)
        return gif
