"""The reference's first stage-2 training steps, in plain PyTorch.

``stage2`` returns ``{"losses": [...], "grads": [{leaf: tensor}, ...], "params":
[{leaf: tensor}, ...]}`` with one entry per step (``params[0]`` the start).
The inputs are the benchmark's own: the scene's rows, the targets, the rig,
the initial network and the schedule of views; whatever the program derives
from them (the neighbour graph, encodings, budgets) is worked out here
again.  ``dtype`` bfloat16 computes the network's matmuls in bfloat16.
"""

from __future__ import annotations

import torch

from splatbench.reference import model, render as ref


def _render(means, rot, scales, op, colors, w2c, K, width, height, tile, acc_dtype):
    p = ref.project(means, rot, scales, op, w2c, K, width, height)
    bins = ref.bin_view(p, width, height, tile)
    return ref.render_table(ref.pack_table(p, colors), bins, width, height,
                            differentiable=True, acc_dtype=acc_dtype)


def stage2(cloud: dict, targets, w2c, K, net0: dict, cfg: dict, schedule, steps: int,
           device, dtype=torch.float32) -> dict:
    """``cloud``: the animated cloud's alive rows (numpy); ``targets`` (T, C,
    3, H, W) uint8; ``net0`` the initial network by state-dict names;
    ``schedule`` [(timestep, camera indices)]."""
    model.no_tf32()
    r, s2 = cfg["rig"], cfg["stage2"]
    head, width, height = s2["head"], r["width"], r["height"]
    t = {k: torch.as_tensor(v, device=device) for k, v in cloud.items()}
    means, quats = t["means"], t["rotation_quaternions"]
    scales = torch.exp(t["log_scales"])
    op = torch.sigmoid(t["opacity_logits"])[:, 0]
    fg = torch.nonzero(t["segmentation_masks"][:, 0] > 0.5, as_tuple=True)[0]
    nbr, d2 = model.knn(means[fg], model.RIGIDITY_K)
    nbr_w = torch.exp(-model.RIGIDITY_TEMPERATURE * d2)
    quirk = head["quirk_compat"]
    enc_init = model.encode_state(means, quats, quirk)
    prev_enc = enc_init
    prev_fg = model.snapshot(means[fg], quats[fg], nbr)
    params = {k: v.detach().clone().to(device).requires_grad_(True) for k, v in net0.items()}
    adam = model.Adam(params, eps=1e-8)
    t_count = cfg["timesteps"]
    warm = s2["warmup_iterations"] * t_count
    total_steps = s2["total_iterations"] * t_count
    w2c_t, K_t = torch.as_tensor(w2c, device=device), torch.as_tensor(K, device=device)
    rec = {"losses": [], "grads": [], "params": [{k: p.detach().clone() for k, p in params.items()}]}
    for step in range(steps):
        ts, cams = schedule[step]
        m, q = model.deform(params, head, means, quats, enc_init, prev_enc, ts, t_count,
                            s2["residual_blocks"], dtype)
        rig = model.rigidity(m[fg], q[fg], nbr, nbr_w, prev_fg)
        rot = ref.quat_normalize(q)
        imgs = torch.stack([_render(m, rot, scales, op, t["colors"], w2c_t[c], K_t[c], width,
                                    height, cfg["tile"], torch.float64) for c in cams])
        tgt = torch.as_tensor(targets[ts - 1][cams], device=device).float() / 255.0
        image_loss = (model.L1_WEIGHT * model.l1_per_view(imgs, tgt).sum()
                      + model.SSIM_WEIGHT * (1.0 - model.ssim_per_view(imgs, tgt)).sum())
        total = image_loss + model.RIGIDITY_WEIGHT * (float(len(cams)) * rig)
        grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
        lr = model.warmup_cosine(s2["learning_rate"], warm, total_steps, adam.count)
        upd = adam.update(grads)
        with torch.no_grad():
            for k, p in params.items():
                p.add_(-lr * upd[k])
        prev_enc = model.encode_state(m.detach(), q.detach(), quirk)
        prev_fg = model.snapshot(m[fg].detach(), q[fg].detach(), nbr)
        rec["losses"].append(float(total.detach()))
        rec["grads"].append({k: g.detach() for k, g in grads.items()})
        rec["params"].append({k: p.detach().clone() for k, p in params.items()})
    return rec
