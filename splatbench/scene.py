"""The cells' inputs, made from a configuration's file and the run's seed:
the scene files (checked against their digests), the camera rig, the
motion, and the targets that the benchmark's own renderer draws once per
checkout.  Nothing here imports the program.

- The rig (BASELINE configs 2-4, ``scripts/acceptance_full.py``): 27
  look-at cameras on a ring of radius 4 around the origin, heights
  0.4 + 0.6 N(0, 1) from ``default_rng(1)``, 1280x720, focal 0.8 W.
- The motion: the foreground (segmentation channel 0 > 0.5) turns about the
  vertical axis through its centre by ``rot_rate * t`` and bobs by
  ``bob_amp * sin(2 pi t / 50)``.
- The schedule of views that stage 2 draws from its seed.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np
import torch

from splatbench.reference import render as ref

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CLOUD_KEYS = ("means", "colors", "segmentation_masks", "rotation_quaternions",
              "opacity_logits", "log_scales", "alive")


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def load_cloud(entry: dict, root: Path = ROOT) -> dict:
    """A scene file ``{"path", "sha256"}`` as numpy arrays of its alive rows;
    a file that is not the one the configuration names is refused."""
    path = root / entry["path"]
    if sha256(path) != entry["sha256"]:
        raise SystemExit(f"{path}: not the file this configuration was measured with "
                         f"(sha256 {entry['sha256']})")
    z = np.load(path)
    alive = z["alive"]
    return {k: np.ascontiguousarray(z[k][alive]) for k in CLOUD_KEYS if k != "alive"}


def lookat(eye, width: int, height: int, focal: float):
    eye = np.asarray(eye, np.float64)
    up = np.array([0.0, 1.0, 0.0])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    R = np.stack([right, true_up, fwd])
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    K = np.array([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]])
    return w2c.astype(np.float32), K.astype(np.float32)


def rig(rig_cfg: dict):
    """(w2c (C, 4, 4), K (C, 3, 3)) float32 numpy."""
    w, h, n = rig_cfg["width"], rig_cfg["height"], rig_cfg["cameras"]
    rng = np.random.default_rng(rig_cfg["height_seed"])
    cams = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = (rig_cfg["radius"] * np.sin(a), 0.4 + 0.6 * rng.standard_normal(),
               -rig_cfg["radius"] * np.cos(a))
        cams.append(lookat(eye, w, h, rig_cfg["focal_factor"] * w))
    return np.stack([c[0] for c in cams]), np.stack([c[1] for c in cams])


def moved_means(means: np.ndarray, fg: np.ndarray, t: int, motion: dict) -> np.ndarray:
    center = means[fg].mean(0, keepdims=True)
    a = motion["rot_rate"] * t
    rot = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]], np.float32)
    m = means.copy()
    m[fg] = (means[fg] - center) @ rot.T + center
    m[fg, 1] += motion["bob_amp"] * np.sin(2 * np.pi * t / 50.0)
    return m


def stage2_schedule(seed: int, s2: dict, t_count: int, n_cams: int, seq_it: int = 0):
    """[(timestep, camera indices)] of sequence iteration ``seq_it`` (from the
    start of a run), as stage 2 draws them from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    if s2["view_staging"] == "device_rotate":
        k = min(s2["resident_cameras"], n_cams)
        perm = np.random.default_rng(seed + 7).permutation(n_cams)
        pos = (seq_it // max(1, s2["restage_every"])) % max(1, n_cams // k)
        resident = np.sort(np.take(perm, np.arange(pos * k, (pos + 1) * k), mode="wrap"))
        v = min(s2["views_per_step"], k)
        cams = [resident[rng.choice(k, size=v, replace=False)] for _ in range(t_count)]
    else:
        v = min(s2["views_per_step"], n_cams)
        cams = [rng.choice(n_cams, size=v, replace=False) for _ in range(t_count)]
    if s2["timestep_order"] == "shuffled":
        order = [int(x) + 1 for x in rng.permutation(t_count)]
    else:
        order = list(range(1, t_count + 1))
    return [(t, np.asarray(cams[t - 1], np.int64)) for t in order]


def activated(cloud: dict, device, means=None, quats=None):
    """(means, unit quaternions, scales, opacity (N,)) of numpy or tensor rows."""
    t = {k: torch.as_tensor(v, device=device) for k, v in cloud.items()}
    m = t["means"] if means is None else means
    q = t["rotation_quaternions"] if quats is None else quats
    return (m, ref.quat_normalize(q), torch.exp(t["log_scales"]),
            torch.sigmoid(t["opacity_logits"])[:, 0])


@torch.no_grad()
def render_views(args, colors, w2c, K, width, height, tile):
    """(C, channels, H, W) float32 renders of every camera."""
    means, rot, scales, op = args
    out = []
    for i in range(w2c.shape[0]):
        p = ref.project(means, rot, scales, op, w2c[i], K[i], width, height)
        bins = ref.bin_view(p, width, height, tile)
        out.append(ref.composite(ref.pack_table(p, colors), bins, width, height))
    return torch.stack(out)


def _atomic_save(path: Path, array: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".part{os.getpid()}")
    with open(tmp, "wb") as f:
        np.save(f, array)
    os.replace(tmp, path)


def stage2_targets(name: str, truth: dict, cfg: dict, device, cache: Path,
                   log=print) -> np.ndarray:
    """(T, C, 3, H, W) uint8: the truth moved to t = 1..T at every camera,
    rendered once per checkout and kept under ``.cache/targets/<name>/``."""
    r, steps = cfg["rig"], cfg["timesteps"]
    path = cache / "targets" / name / f"stage2_t{steps}.npy"
    if path.exists():
        return np.load(path)
    w2c, K = (torch.from_numpy(x).to(device) for x in rig(r))
    fg = truth["segmentation_masks"][:, 0] > 0.5
    colors = torch.from_numpy(truth["colors"]).to(device)
    out = np.empty((steps, w2c.shape[0], 3, r["height"], r["width"]), np.uint8)
    for t in range(1, steps + 1):
        m = torch.from_numpy(moved_means(truth["means"], fg, t, cfg["motion"])).to(device)
        img = render_views(activated(truth, device, means=m), colors, w2c, K, r["width"],
                           r["height"], cfg["tile"])
        out[t - 1] = torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
    _atomic_save(path, out)
    log(f"targets: rendered {out.shape} into {path}")
    return out
