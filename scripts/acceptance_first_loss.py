"""The first stage-1 iteration's loss of the acceptance scene, as the JAX
package computes it on the backend it runs on.

``scripts/acceptance_full.py stage1`` logs it as step 0 of
``stage1_metrics.jsonl``; this computes that one number alone (one target
image and segmentation, the initial cloud, one dual render at ``fit``'s
starting budget), so that the logs of runs on different devices can be
told apart from the package's arithmetic on each.  The view is the one
``fit``'s sampler picks first (the last of ``default_rng(0)``'s first
permutation).

Usage (on a CPU: ~2.5 min and ~1.6 GB at the full 1280x720 scene):
    JAX_PLATFORMS=cpu python scripts/acceptance_first_loss.py
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import acceptance_full as acc
    from splatpu.core.types import activate_cloud
    from splatpu.render.api import render, render_dual, resolve_binning
    from splatpu.train.losses import SEGMENTATION_WEIGHT, image_loss
    from splatpu.train.stage1 import initialize_cloud

    truth, cams = acc.build_truth_and_cams(jax, np)
    view = int(np.random.default_rng(0).permutation(len(cams))[-1])
    binning, _ = acc.staging_binning(jax, truth, cams)
    margs = activate_cloud(truth)
    image = jnp.clip(render(margs, cams[view], config=binning).image, 0.0, 1.0)
    seg = render(margs.replace(colors=truth.segmentation_masks), cams[view],
                 config=binning).image

    # acceptance_full.py:196-205 and Stage1Config(capacity_factor=6.0)
    pc = np.concatenate(
        [
            np.asarray(truth.means),
            np.clip(np.asarray(truth.colors), 0.0, 1.0),
            (np.asarray(truth.segmentation_masks)[:, :1] > 0.5).astype(np.float32),
        ],
        axis=1,
    )
    pc = pc[np.random.default_rng(0).choice(len(pc), size=len(pc) // 3, replace=False)]
    capacity = -(-int(len(pc) * 6.0) // 256) * 256
    cloud = initialize_cloud(pc, capacity)
    start = resolve_binning(capacity, None, None)
    out, seg_out = render_dual(activate_cloud(cloud), cloud.segmentation_masks, cams[view],
                               config=start)
    img_l, seg_l = image_loss(out.image, image), image_loss(seg_out.image, seg)
    print(json.dumps({
        "backend": jax.default_backend(),
        "view": view,
        "capacity": capacity,
        "image_loss": float(img_l),
        "segmentation_loss": float(seg_l),
        "total_loss": float(img_l + SEGMENTATION_WEIGHT * seg_l),
        "binning_overflow": bool(out.overflowed | seg_out.overflowed),
    }))


if __name__ == "__main__":
    main()
