"""Deformation network: residual MLP over the encoded Gaussian state (port of
``splatpu/dynamics/network.py``).

    fc_in: Linear(192 -> D, bias)
    R x block: Linear(no bias) -> BatchNorm -> GELU
               -> Linear(no bias) -> BatchNorm -> +skip -> GELU
    fc_out: Linear(D -> 7, bias)
    (+ the input means||quats when ``double_residual``)

BatchNorm always normalises with the current batch's statistics (biased
variance, eps 1e-5) and keeps no running statistics — in inference too, as
the reference never switches its module to eval mode.  ``nn.BatchNorm1d``
in eval mode would be wrong; ``F.batch_norm(training=True)`` without running
buffers is exactly this.  Everything computes in float32; TF32 matmuls are
switched off for the forward pass (and the caller's setting restored after),
so the card computes what the CPU does.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
INPUT_DIM = 192
OUTPUT_DIM = 7


@dataclasses.dataclass(frozen=True)
class DeformationNetConfig:
    hidden_dim: int = 128
    residual_blocks: int = 3
    input_dim: int = INPUT_DIM
    output_dim: int = OUTPUT_DIM
    delta_scale: float = 0.01
    double_residual: bool = True
    zero_init_head: bool = False
    time_gate_head: bool = False


@contextlib.contextmanager
def _no_tf32():
    """Full-float32 matmuls for the duration; the process's setting is
    restored after."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = prev


class BatchStatNorm(nn.Module):
    """BatchNorm over dim 0 with batch statistics only."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=BN_EPS)


class ResidualBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim, bias=False)
        self.bn1 = BatchStatNorm(dim)
        self.fc2 = nn.Linear(dim, dim, bias=False)
        self.bn2 = BatchStatNorm(dim)

    def forward(self, x):
        h = F.gelu(self.bn1(self.fc1(x)))
        h = self.bn2(self.fc2(h))
        return F.gelu(h + x)


class DeformationNet(nn.Module):
    def __init__(self, config: DeformationNetConfig = DeformationNetConfig()):
        super().__init__()
        self.config = config
        d = config.hidden_dim
        self.fc_in = nn.Linear(config.input_dim, d)
        self.blocks = nn.ModuleList(ResidualBlock(d) for _ in range(config.residual_blocks))
        self.fc_out = nn.Linear(d, config.output_dim)
        if config.zero_init_head:
            nn.init.zeros_(self.fc_out.weight)
            nn.init.zeros_(self.fc_out.bias)

    def forward(self, initial_means_and_rotations, encoded_initial, encoded_previous, encoded_progress):
        x = torch.cat([encoded_initial, encoded_previous, encoded_progress], dim=1)
        with _no_tf32():
            x = self.fc_in(x)
            for blk in self.blocks:
                x = blk(x)
            out = self.fc_out(x)
        if self.config.double_residual:
            out = out + initial_means_and_rotations
        return out


def state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's ``net_params`` pytree (numpy leaves) -> a
    ``DeformationNet`` state dict.

    JAX stores ``fc.w`` as (in, out) for ``x @ w``; ``nn.Linear`` keeps
    (out, in), so weights are transposed.  ``blocks`` may be a list (a live
    pytree) or a dict keyed "0", "1", ... (as flax msgpack stores lists).
    """
    import numpy as np

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    blocks = params["blocks"]
    if isinstance(blocks, dict):
        blocks = [blocks[str(i)] for i in range(len(blocks))]
    sd = {
        "fc_in.weight": t(params["fc_in"]["w"]).T.contiguous(),
        "fc_in.bias": t(params["fc_in"]["b"]),
        "fc_out.weight": t(params["fc_out"]["w"]).T.contiguous(),
        "fc_out.bias": t(params["fc_out"]["b"]),
    }
    for i, blk in enumerate(blocks):
        for fc in ("fc1", "fc2"):
            sd[f"blocks.{i}.{fc}.weight"] = t(blk[fc]["w"]).T.contiguous()
        for bn in ("bn1", "bn2"):
            sd[f"blocks.{i}.{bn}.weight"] = t(blk[bn]["gamma"])
            sd[f"blocks.{i}.{bn}.bias"] = t(blk[bn]["beta"])
    return sd


def net_config_for(state_dict, **head) -> DeformationNetConfig:
    """The config whose shapes match ``state_dict``; ``head`` sets the head
    knobs (delta_scale, double_residual, zero_init_head, time_gate_head)."""
    w_in = state_dict["fc_in.weight"]
    n_blocks = len({k.split(".")[1] for k in state_dict if k.startswith("blocks.")})
    return DeformationNetConfig(
        hidden_dim=w_in.shape[0],
        residual_blocks=n_blocks,
        input_dim=w_in.shape[1],
        output_dim=state_dict["fc_out.weight"].shape[0],
        **head,
    )
