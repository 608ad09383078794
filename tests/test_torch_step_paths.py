"""One stage-2 step through the slice's new render paths, the port against
the JAX package (test_torch_stage2.py's step test, same inputs, same
tolerances):

- the padded path: the port's renderer="plain_padded" (K5's plain versions)
  against JAX "pallas_padded" (interpret mode), 16 px tiles;
- the manual composite: kernel="manual" (K4's plain versions) on both sides.

And the trainer's plumbing for them: ``binning_overrides={"kernel":
"manual"}`` reaches the render of every step, and the padded path refuses
the 32 px budget that ``train`` sizes when no binning is given, as the JAX
package's does.
"""

import numpy as np
import pytest
import torch

from splatpu.render.binning import BinningConfig as JBinningConfig
import splatpu_torch.train.stage2 as ts2
from splatpu_torch.data.dataset import ViewData
from splatpu_torch.render.binning import BinningConfig
from test_torch_stage2 import BCFG, check_one_step, step_inputs  # noqa: F401 (fixture)
from _torch_scenes import np_cloud, np_lookat, torch_cloud

torch.set_num_threads(1)

PADDED = dict(BCFG, tile=16, chunk_pairs=128)
MANUAL = dict(BCFG, kernel="manual")


@pytest.mark.parametrize("jax_renderer,port_renderer,cfg", [
    ("pallas_padded", "plain_padded", PADDED),
    ("pallas", "plain", MANUAL),
], ids=["padded", "manual"])
def test_one_step_matches_jax_new_paths(step_inputs, jax_renderer, port_renderer, cfg):  # noqa: F811
    check_one_step(step_inputs, jax_renderer, JBinningConfig(**cfg), port_renderer,
                   BinningConfig(**cfg))


def tiny_views(w=32, h=24):
    rng = np.random.default_rng(5)
    views = []
    for c in range(2):
        w2c, K = np_lookat((3.5 * np.sin(c), 0.3, -3.5 * np.cos(c)), w, h)
        views.append(ViewData(camera_index=c, w2c=w2c, K=K, width=w, height=h,
                              image=rng.uniform(0, 1, (3, h, w)).astype(np.float32),
                              segmentation=np.zeros((3, h, w), np.float32)))
    return [views]


def tiny_config(**kw):
    return ts2.Stage2Config(total_iterations=1, warmup_iterations=0, hidden_dim=16,
                            residual_blocks=1, views_per_step=2, timestep_count=1, **kw)


def test_train_passes_kernel_override_to_render(monkeypatch):
    seen = []
    real_render = ts2.render

    def spy(*args, **kw):
        seen.append((kw["impl"], kw["config"]))
        return real_render(*args, **kw)

    monkeypatch.setattr(ts2, "render", spy)
    ts2.train(torch_cloud(np_cloud(41, 48)), tiny_views(),
              tiny_config(renderer="plain", binning_overrides={"kernel": "manual"}), device="cpu")
    assert seen and all(impl == "plain" and cfg.kernel == "manual" for impl, cfg in seen)


def test_padded_trainer_needs_16px_binning():
    cloud = torch_cloud(np_cloud(42, 48))
    with pytest.raises(ValueError, match="fixed at 16x16 tiles"):
        ts2.train(cloud, tiny_views(), tiny_config(renderer="plain_padded"), device="cpu")
    cfg = tiny_config(renderer="plain_padded",
                      binning=BinningConfig(tile=16, max_span=64, max_pairs=1 << 12))
    _, _, _, metrics = ts2.train(cloud, tiny_views(), cfg, device="cpu")
    assert np.isfinite(float(metrics["total"])) and float(metrics["grad_norm"]) > 0
