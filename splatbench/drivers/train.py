"""Stage 2 (``splatpu_torch.train.stage2.train``) as a cell.

Set-up draws the network from the seed and drives one ``train`` call
through the first sequence iteration with a logger (every step's loss) and a
checkpoint at its end; the network's pre-hook reads the parameters before
steps 2 and 4 and the optimizer's moments after step 1.  Those three steps
are what the reference follows.  The window is a second ``train`` call that
resumes from that checkpoint with the same network object and no logger: it
opens at the call's first step (its set-up done; the first call has run
every shape) and closes at the first ``on_iteration`` ``--seconds`` later,
each read at a synchronised card.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

from splatbench import counts, faults, harness, scene
from splatbench.reference import steps as ref_steps


def net_state(cfg: dict, seed: int, device) -> dict:
    """The network's initial parameters by the port's state-dict names: each
    linear layer U(+-1/sqrt(fan_in)), from one draw of a generator on the
    device seeded with ``seed``; the head zero where the configuration says
    so; BatchNorm scale 1, shift 0."""
    s2 = cfg["stage2"]
    d, blocks = s2["hidden_dim"], s2["residual_blocks"]
    shapes = {"fc_in.weight": (d, 192), "fc_in.bias": (d,)}
    for r in range(blocks):
        shapes[f"blocks.{r}.fc1.weight"] = (d, d)
        shapes[f"blocks.{r}.fc2.weight"] = (d, d)
    shapes.update({"fc_out.weight": (7, d), "fc_out.bias": (7,)})
    fan_in = {k: (192 if k.startswith("fc_in") else d) for k in shapes}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    total = sum(int(np.prod(s)) for s in shapes.values())
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    sd, i = {}, 0
    for k, s in shapes.items():
        n = int(np.prod(s))
        sd[k] = (u[i:i + n] / float(np.sqrt(fan_in[k]))).reshape(s)
        i += n
    if s2["head"]["zero_init_head"]:
        sd["fc_out.weight"] = torch.zeros_like(sd["fc_out.weight"])
        sd["fc_out.bias"] = torch.zeros_like(sd["fc_out.bias"])
    for r in range(blocks):
        for bn in ("bn1", "bn2"):
            sd[f"blocks.{r}.{bn}.weight"] = torch.ones(d, device=device)
            sd[f"blocks.{r}.{bn}.bias"] = torch.zeros(d, device=device)
    return sd


def program_config(cfg: dict, seed: int, **extra):
    from splatpu_torch.train.stage2 import Stage2Config

    s2, head = cfg["stage2"], cfg["stage2"]["head"]
    return Stage2Config(
        total_iterations=s2["total_iterations"], warmup_iterations=s2["warmup_iterations"],
        learning_rate=s2["learning_rate"], hidden_dim=s2["hidden_dim"],
        residual_blocks=s2["residual_blocks"], views_per_step=s2["views_per_step"],
        timestep_count=cfg["timesteps"], quirk_compat=head["quirk_compat"],
        delta_scale=head["delta_scale"], double_residual=head["double_residual"],
        zero_init_head=head["zero_init_head"], time_gate_head=head["time_gate_head"],
        view_staging=s2["view_staging"], resident_cameras=s2.get("resident_cameras", 8),
        restage_every=s2.get("restage_every", 10), timestep_order=s2["timestep_order"],
        steps_per_timestep=1, binning_overrides={"tile": cfg["tile"]}, seed=seed, **extra)


class Inputs:
    """The cell's inputs: the animated cloud, the targets, the rig."""

    def __init__(self, ctx):
        cfg = ctx.cfg
        self.cloud = scene.load_cloud(cfg["stage2"]["cloud"], ctx.root)
        truth = scene.load_cloud(cfg["truth"], ctx.root)
        t0 = time.perf_counter()
        self.targets = scene.stage2_targets(ctx.config_name, truth, cfg, ctx.device,
                                            ctx.cache_dir, log=harness.log)
        harness.log(f"set-up: targets {self.targets.shape} in {time.perf_counter() - t0:.2f} s")
        self.w2c, self.K = scene.rig(cfg["rig"])
        r = cfg["rig"]
        from splatpu_torch.data.dataset import ViewData

        self.views = [[ViewData(camera_index=c, w2c=self.w2c[c], K=self.K[c], width=r["width"],
                                height=r["height"], image=self.targets[t, c],
                                segmentation=np.zeros((3, 1, 1), np.float32))
                       for c in range(self.w2c.shape[0])] for t in range(self.targets.shape[0])]

    def program_cloud(self, device):
        from splatpu_torch.core.types import cloud_from_arrays

        return cloud_from_arrays(**self.cloud, device=device)


class LossLog:
    """A logger that keeps each step's total loss."""

    def __init__(self):
        self.losses = []

    def log(self, metrics, step):
        if "total" in metrics:
            self.losses.append(float(metrics["total"]))

    def flush(self):
        pass


class Capture:
    """The network's pre-hook: the parameters before steps 2 and 4, and the
    optimizer's first moments after step 1 (the first gradient times 1 - b1)."""

    def __init__(self, net):
        self.calls = 0
        self.params, self.grad1 = {}, None
        self.handle = net.register_forward_pre_hook(self)

    def __call__(self, module, inputs):
        self.calls += 1
        if self.calls in (2, 4):
            self.params[self.calls - 1] = {k: p.detach().clone()
                                           for k, p in module.named_parameters()}
        if self.calls == 2:
            opt = harness.find_instance("Stage2Adam", "splatpu_torch.train.optim",
                                        lambda o: o.count == 1)
            self.grad1 = {k: (m / (1.0 - opt.b1)).clone() for k, m in opt.mu.items()}
        if self.calls == 4:
            self.handle.remove()


def checked_steps(ctx, inputs: Inputs, seed: int, net_sd: dict, ckpt: Path | None = None,
                  **overrides):
    """One ``train`` call through the sequence iteration that holds step 4
    (the first, at 4 timesteps or more): (the network,
    the binning it ended with, the program's record of its first three steps)."""
    from splatpu_torch.dynamics.network import DeformationNet
    from splatpu_torch.train import stage2

    config = program_config(ctx.cfg, seed, checkpoint_every=1 if ckpt else 0,
                            checkpoint_path=str(ckpt) if ckpt else None, **overrides)
    net = DeformationNet(config.net_config())
    net.load_state_dict({k: v.cpu() for k, v in net_sd.items()})
    net = net.to(ctx.device)
    cap, losses, ended = Capture(net), LossLog(), {}

    def stop(seq_it, net_, config_, metrics):
        ended["binning"] = config_.binning
        return cap.calls >= 4

    stage2.train(inputs.program_cloud(ctx.device), inputs.views, config, logger=losses,
                 initial_net=net, device=ctx.device, on_iteration=stop)
    change = {k: cap.params[3][k] - net_sd[k] for k in net_sd}
    record = {"losses": losses.losses[:3], "grad1": cap.grad1, "change": change}
    return net, ended["binning"], record


class Window:
    """The timed call's clock.  The network's pre-hook opens it at the first
    step and counts the steps; ``on_iteration`` closes it at the end of the
    first sequence iteration ``--seconds`` later.  A traced run times a third
    of that, then profiles the next sequence iterations and keeps each
    profiled step's rendered cloud and cameras for the counts."""

    def __init__(self, ctx, net):
        self.ctx = ctx
        self.seconds = ctx.args.seconds / 3 if ctx.args.trace else ctx.args.seconds
        self.open = self.close = None
        self.steps = 0
        self.host = None
        self.metrics = {}
        self.profile = None
        self.prof_from = self.prof_units = 0
        self.views = []
        self.handle = net.register_forward_pre_hook(self.step)

    def step(self, module, inputs):
        if self.open is None:
            harness.sync(self.ctx.device)
            self.host = harness.host_counters()
            self.open = self.ctx.setup_end = time.perf_counter()
        self.steps += 1

    def view_losses(self, orig):
        """``stage2.view_losses`` that keeps, while profiling, references to
        the step's activated cloud and cameras (no work on the device)."""

        def view_losses(args, camera, w2c, K, *rest):
            if self.profile is not None and self.prof_units == 0:
                a = (args.means3d, args.rotations, args.scales, args.opacities[:, 0])
                self.views.append((tuple(t.detach() for t in a), w2c, K))
            return orig(args, camera, w2c, K, *rest)

        return view_losses

    def __call__(self, seq_it, net, config, metrics):
        if self.profile is not None:
            if seq_it - self.prof_it < self.ctx.traffic["profile_sequence_iterations"]:
                return False
            self.profile.stop()
            self.prof_units = self.steps - self.prof_from
            self.handle.remove()
            return True
        harness.sync(self.ctx.device)
        now = time.perf_counter()
        if now - self.open < self.seconds:
            return False
        self.close = (now, self.steps)
        self.host = harness.host_delta(self.host, harness.host_counters())
        self.metrics = {k: float(v) for k, v in metrics.items()}
        if not self.ctx.args.trace:
            self.handle.remove()
            return True
        self.profile = harness.Profile(self.ctx.device)
        self.prof_it, self.prof_from = seq_it, self.steps
        self.profile.start()
        return False


def run(ctx) -> dict:
    from splatpu_torch.train import stage2

    inputs = Inputs(ctx)
    t0 = time.perf_counter()
    net_sd = net_state(ctx.cfg, ctx.args.seed, ctx.device)
    ckpt = Path(ctx.tmpdir) / f"splatbench_stage2_{os.getpid()}.msgpack"
    net, binning, record = checked_steps(ctx, inputs, ctx.args.seed, net_sd, ckpt)
    harness.log(f"set-up: checked steps (the first sequence iteration) in "
                f"{time.perf_counter() - t0:.2f} s; budget max_pairs {binning.max_pairs},"
                f" max_span {binning.max_span}, tile {binning.tile}")
    win = Window(ctx, net)
    config = program_config(ctx.cfg, ctx.args.seed, binning=binning)
    keep = (faults.patched(stage2, "view_losses", win.view_losses(stage2.view_losses))
            if ctx.args.trace else faults.no_fault())
    try:
        with keep:
            stage2.train(inputs.program_cloud(ctx.device), inputs.views, config,
                         initial_net=net, device=ctx.device, resume_from=str(ckpt),
                         on_iteration=win)
    finally:
        ckpt.unlink(missing_ok=True)
    if win.close is None:
        raise RuntimeError("the run ended before its window closed: raise total_iterations")
    wall, steps = win.close[0] - win.open, win.close[1]
    del net
    return {
        "e2e": {"train_step_ms": 1e3 * wall / steps},
        "attempted": steps,
        "failed": 0 if harness.finite(win.metrics.get("total")) else steps,
        "window": {"steps": steps, "seconds": wall, "last_loss": win.metrics.get("total"),
                   "overflow": win.metrics.get("binning_overflow"), "host": win.host},
        "record": record,
        "inputs": inputs,
        "profile": win.profile,
        "prof_units": win.prof_units,
        "views": win.views,
    }


def reference_of(ctx, inputs: Inputs, seed: int) -> dict:
    sched = scene.stage2_schedule(seed, ctx.cfg["stage2"], ctx.cfg["timesteps"],
                                  inputs.w2c.shape[0])
    return ref_steps.stage2(inputs.cloud, inputs.targets, inputs.w2c, inputs.K,
                            net_state(ctx.cfg, seed, ctx.device), ctx.cfg, sched, 3, ctx.device)


def reference(ctx, out: dict) -> dict:
    return reference_of(ctx, out["inputs"], ctx.args.seed)


def checked(ctx, inputs: Inputs, seed: int, mode: str) -> dict:
    """The program's record of its first three steps: as configured
    (``program``), with its bfloat16 network (``control``), or with a fault
    of ``faults.FAULTS`` planted."""
    over = {"compute_dtype": "bfloat16"} if mode == "control" else {}
    plant = faults.plant(mode) if mode in faults.FAULTS else faults.no_fault()
    with plant:
        _, _, record = checked_steps(ctx, inputs, seed, net_state(ctx.cfg, seed, ctx.device),
                                     **over)
    return record


def work(ctx, out: dict) -> dict:
    """The counts behind the rooflines and the step's FLOPs, per 5-view
    launch: the mean over the profiled steps of each step's deformed cloud
    at its own cameras."""
    views, s2, r = out.pop("views"), ctx.cfg["stage2"], ctx.cfg["rig"]
    colors = torch.from_numpy(out["inputs"].cloud["colors"]).to(ctx.device)
    steps = [counts.view_work(args, colors, w2c, K, r["width"], r["height"], ctx.cfg["tile"])
             for args, w2c, K in views]
    w = {k: sum(x[k] for x in steps) / len(steps) for k in steps[0]}
    v = s2["views_per_step"]
    b = counts.composite_bounds(w, v, 3)
    flops = (b["fwd_ops"] + b["bwd_ops"]
             + counts.network_ops(len(out["inputs"].cloud["means"]), s2["hidden_dim"],
                                  s2["residual_blocks"])
             + counts.ssim_ops(v, 3, w["pixels"]))
    return dict(b, step_flops=flops, work=w)
