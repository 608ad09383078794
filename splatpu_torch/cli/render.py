"""Render a deformation bundle to free-viewpoint frames and video (port of
``splatpu/cli/render.py``).

    python -m splatpu_torch.cli.render <bundle_dir> [-o OUT_DIR] [-fps N]
        [--timesteps N] [--renderer ...] [--width W] [--height H]
        [--device cuda|cpu]

The bundle is ``cli/train.py``'s ``deformation_network/`` (or the JAX
package's): cloud, ``config.json`` and the network's parameters.  Head
settings the bundle's config records are used; a bundle without them (the
JAX package's) gets the defaults, as the JAX package's renderer gives every
bundle.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="splatpu-torch-render")
    p.add_argument("bundle_dir", type=Path)
    p.add_argument("-o", "--output", type=Path, default=None)
    p.add_argument("-fps", type=int, default=30)
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--renderer", default="auto")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--device", default="cuda", help="torch device (cuda, or cpu for tests)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if torch.device(args.device).type == "cuda":
        from splatpu_torch.obs.cache import enable_compilation_cache

        enable_compilation_cache()

    from splatpu_torch.dynamics.deform import normalize_and_encode_means_and_rotations
    from splatpu_torch.dynamics.network import DeformationNet, net_config_for
    from splatpu_torch.io.checkpoint import HEAD_KNOBS, load_deformation_bundle
    from splatpu_torch.train.inference import run_inference
    from splatpu_torch.train.stage2 import Stage2Config, compact_cloud

    cloud, bundle_cfg, sd = load_deformation_bundle(args.bundle_dir, device=args.device)
    head = {k: bundle_cfg[k] for k in HEAD_KNOBS if k in bundle_cfg}
    net = DeformationNet(net_config_for(sd, **head))
    net.load_state_dict(sd)
    cloud = compact_cloud(cloud)
    t_count = args.timesteps or bundle_cfg["timestep_count"]
    config = Stage2Config(
        hidden_dim=bundle_cfg["hidden_dimension"],
        residual_blocks=bundle_cfg["residual_block_count"],
        timestep_count=t_count,
        renderer=args.renderer,
        **head,
    )
    encoded_initial = normalize_and_encode_means_and_rotations(
        cloud.means, cloud.rotation_quaternions)
    out_dir = args.output or (args.bundle_dir / "renders")
    run_inference(net, cloud, encoded_initial, config, width=args.width, height=args.height,
                  device=args.device, output_directory=out_dir, fps=args.fps)
    print(f"renders -> {out_dir}")


if __name__ == "__main__":
    main()
