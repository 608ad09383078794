"""The yardstick's inputs repeat for a seed: the rig, the schedule, the
network's draw; the reference renders as the port does."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from splatbench import scene
from splatbench.drivers import train as train_driver
from splatbench.reference import render as ref
from splatbench.tests import tiny

CFG = json.loads((tiny.BENCH / "configs" / "scene120k.json").read_text())
SEED = 2**31 + 1234


def test_rig_is_the_published_ring():
    w2c, K = scene.rig(CFG["rig"])
    assert w2c.shape == (27, 4, 4) and K.shape == (27, 3, 3)
    centers = np.linalg.inv(w2c)[:, :3, 3]
    np.testing.assert_allclose(np.linalg.norm(centers[:, [0, 2]], axis=1), 4.0, rtol=1e-5)
    assert K[0, 0, 0] == pytest.approx(0.8 * 1280)


def test_same_seed_same_schedule_other_seed_other_order():
    s2 = CFG["stage2"]
    s = scene.stage2_schedule(SEED, s2, CFG["timesteps"], 27)
    assert [t for t, _ in s] == [t for t, _ in scene.stage2_schedule(SEED, s2, CFG["timesteps"], 27)]
    assert sorted(t for t, _ in s) == list(range(1, CFG["timesteps"] + 1))
    assert all(len(c) == 5 and len(set(c.tolist())) == 5 for _, c in s)
    # device_rotate: every pick among the 8 resident cameras.
    assert len({int(c) for _, cams in s for c in cams}) <= 8
    other = scene.stage2_schedule(SEED + 1, s2, CFG["timesteps"], 27)
    assert [t for t, _ in s] != [t for t, _ in other]


def test_network_draw_repeats():
    a = train_driver.net_state(CFG, SEED, "cpu")
    b = train_driver.net_state(CFG, SEED, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["fc_out.weight"].abs().max()) == 0.0  # config 3's zero-init head
    assert float(a["fc_in.weight"].abs().max()) <= 1 / np.sqrt(192)
    c = train_driver.net_state(CFG, SEED + 1, "cpu")
    assert not torch.equal(a["fc_in.weight"], c["fc_in.weight"])


def test_reference_renders_as_the_port():
    """The benchmark's renderer against the port's exact path with its plain
    composites: image and every gradient, at 16 and 32 px tiles."""
    from splatpu_torch.core.types import Camera, activate_cloud, cloud_from_arrays
    from splatpu_torch.render.api import demand_binning, measure_binning_demand, render

    z = np.load(tiny.TRUTH)
    idx = np.random.default_rng(3).choice(z["means"].shape[0], 2000, replace=False)
    cloud = {k: z[k][idx] for k in scene.CLOUD_KEYS if k != "alive"}
    w, h = 128, 80
    w2c, K = scene.rig(dict(CFG["rig"], cameras=2, width=w, height=h))
    for tile in (16, 32):
        p = {k: torch.from_numpy(v).clone().requires_grad_(True) for k, v in cloud.items()}
        cam = Camera(w2c=torch.from_numpy(w2c), K=torch.from_numpy(K), width=w, height=h)
        args = activate_cloud(cloud_from_arrays(**p, device="cpu"))
        binning = demand_binning(*measure_binning_demand(args, cam, tile=tile), tile=tile)
        out = render(args, cam, impl="plain", config=binning)
        cot = torch.randn(out.image.shape, generator=torch.Generator().manual_seed(tile))
        (out.image * cot).sum().backward()
        q = {k: torch.from_numpy(v).clone().requires_grad_(True) for k, v in cloud.items()}
        a = (q["means"], ref.quat_normalize(q["rotation_quaternions"]), torch.exp(q["log_scales"]),
             torch.sigmoid(q["opacity_logits"])[:, 0])
        imgs = []
        for i in range(2):
            pr = ref.project(*a, torch.from_numpy(w2c[i]), torch.from_numpy(K[i]), w, h)
            imgs.append(ref.render_table(ref.pack_table(pr, q["colors"]),
                                         ref.bin_view(pr, w, h, tile), w, h, differentiable=True))
        img = torch.stack(imgs)
        (img * cot).sum().backward()
        assert float((img - out.image).abs().max()) < 1e-6
        for k in ("means", "colors", "rotation_quaternions", "opacity_logits", "log_scales"):
            rel = float((p[k].grad - q[k].grad).norm() / q[k].grad.norm())
            assert rel < 1e-5, (tile, k, rel)
