"""The CUDA forward composite against its plain PyTorch version, on the card.

Needs an NVIDIA Hopper GPU and nvcc; skipped elsewhere.  Imports nothing of
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernel_gpu.py

(``--noconftest``: tests/conftest.py configures JAX for the other tests.)
"""

import numpy as np
import pytest
import torch

import splatpu_torch.core.types as tt
import splatpu_torch.render.composite as composite
from splatpu_torch.render.binning import BinningConfig
from splatpu_torch.render.exact import composite_inputs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def scene(seed, n, views, width, height, channels, device):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    args = tt.RenderArgs(
        means3d=t(rng.uniform(-1, 1, (n, 3))),
        colors=t(rng.uniform(0, 1, (n, channels))),
        rotations=t(q),
        opacities=t(1 / (1 + np.exp(-rng.uniform(-1, 4, (n, 1))))),
        scales=t(rng.uniform(0.02, 0.15, (n, 3))),
    )
    cams = []
    for v in range(views):
        a = 2 * np.pi * v / max(views, 1)
        eye = np.array([3.5 * np.sin(a), 0.3, -3.5 * np.cos(a)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = R, -R @ eye
        f = 0.8 * max(width, height)
        K = [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]]
        cams.append(tt.Camera(w2c=t(w2c), K=t(K), width=width, height=height))
    return args, tt.stack_cameras(cams)


@pytest.mark.parametrize(
    "n,views,width,height,tile,channels",
    [(300, 1, 48, 32, 16, 3), (3000, 3, 100, 70, 32, 3), (1500, 2, 64, 64, 32, 1)],
)
def test_kernel_matches_plain(cuda, n, views, width, height, tile, channels):
    args, cams = scene(n, n, views, width, height, channels, cuda)
    cfg = BinningConfig(tile=tile, max_span=256, max_pairs=1 << 18, chunk_pairs=256)
    _, k = composite_inputs(args, cams, cfg)
    bg = torch.linspace(0.1, 0.3, channels, device=cuda)
    before = composite.LAUNCHES
    got = composite.composite_fwd_cuda(k["table"], k["gid"], k["start"], k["end"], bg, **k["geometry"])
    torch.cuda.synchronize()
    assert composite.LAUNCHES == before + 1
    ref = composite.composite_fwd_plain(k["table"], k["gid"], k["start"], k["end"], bg, **k["geometry"])
    assert got[0].shape == (views, channels, height, width)
    for a, b, tol in zip(got[:3], ref[:3], (2e-5, 2e-4, 2e-5)):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= tol
    assert float((got[3] == ref[3]).float().mean()) >= 0.9999
    assert bool((got[3] >= 0).any())
