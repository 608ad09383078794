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
buffers is exactly this.  By default everything computes in float32; TF32
matmuls are switched off for the forward pass (and the caller's setting
restored after), so the card computes what the CPU does; a training step
wraps its forward and backward passes in ``no_tf32`` itself, since autograd
runs the backward matmuls after ``forward`` has returned.

``compute_dtype="bfloat16"`` computes as the JAX package does under it:
the input, weights and biases cast to bfloat16, each matmul and each bias
add rounded to bfloat16, BatchNorm in float32 with its result cast back,
GELU and the skip adds in bfloat16, the head's output cast to float32
before the residual.  The parameters stay float32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from splatpu_torch.core import prng

BN_EPS = 1e-5
INPUT_DIM = 192
OUTPUT_DIM = 7


@dataclasses.dataclass(frozen=True)
class DeformationNetConfig:
    hidden_dim: int = 128
    residual_blocks: int = 3
    input_dim: int = INPUT_DIM
    output_dim: int = OUTPUT_DIM
    compute_dtype: str = "float32"  # or "bfloat16"
    delta_scale: float = 0.01
    double_residual: bool = True
    zero_init_head: bool = False
    time_gate_head: bool = False


@contextlib.contextmanager
def no_tf32():
    """Full-float32 matmuls and convolutions for the duration (TF32 off for
    cuBLAS and cuDNN); the process's settings are restored after.  The flags
    are process-wide, so a backward pass run inside the scope (autograd's
    device threads included) computes in float32 too."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = prev


class BatchStatNorm(nn.Module):
    """BatchNorm over dim 0 with batch statistics only."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        if x.dtype != torch.float32:  # normalised in float32, cast back
            return self.forward(x.float()).to(x.dtype)
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=BN_EPS)


def _linear(fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return fc(x)


def _linear_bf16(fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ w then + b, each rounded to bfloat16, as the JAX package's
    ``linear`` under bfloat16."""
    y = x @ fc.weight.to(torch.bfloat16).T
    return y if fc.bias is None else y + fc.bias.to(torch.bfloat16)


class ResidualBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim, bias=False)
        self.bn1 = BatchStatNorm(dim)
        self.fc2 = nn.Linear(dim, dim, bias=False)
        self.bn2 = BatchStatNorm(dim)

    def forward(self, x, linear=None):
        linear = linear or _linear
        h = F.gelu(self.bn1(linear(self.fc1, x)))
        h = self.bn2(linear(self.fc2, h))
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
        if self.config.compute_dtype == "bfloat16":
            x = x.to(torch.bfloat16)
            linear = _linear_bf16
        elif self.config.compute_dtype == "float32":
            linear = _linear
        else:
            raise ValueError(f"unknown compute_dtype {self.config.compute_dtype!r}")
        with no_tf32():
            x = linear(self.fc_in, x)
            for blk in self.blocks:
                x = blk(x, linear)
            out = linear(self.fc_out, x).float()
        if self.config.double_residual:
            out = out + initial_means_and_rotations
        return out


def _linear_init(fc: nn.Linear, k) -> None:
    """The JAX package's ``_linear_init``: ``k`` split into the weight's
    and the bias's keys, each U(+-1/sqrt(fan_in)) with the bound computed
    in float32; the weight drawn as (fan_in, fan_out) and transposed."""
    bound = float(np.float32(1.0) / np.sqrt(np.float32(fc.in_features)))
    wk, bk = prng.split(k)
    dev = fc.weight.device
    fc.weight.copy_(prng.uniform(wk, (fc.in_features, fc.out_features), -bound, bound, dev).T)
    if fc.bias is not None:
        fc.bias.copy_(prng.uniform(bk, (fc.out_features,), -bound, bound, dev))


def init_deformation_net(
    key,
    config: DeformationNetConfig = DeformationNetConfig(),
    device="cuda",
) -> DeformationNet:
    """A fresh network drawn from ``key`` (``core.prng``) as the JAX
    package's ``init_deformation_net`` draws it, to its bits: ``key`` split
    into 2 + 2 x blocks keys, ``fc_in`` from the first, ``fc_out`` from the
    second (left zero under ``zero_init_head``), block ``r``'s ``fc1`` and
    ``fc2`` from keys 2 + 2r and 3 + 2r; BatchNorm scale 1 and shift 0."""
    net = DeformationNet(config).to(device)
    keys = prng.split(key, 2 + 2 * config.residual_blocks)
    with torch.no_grad():
        _linear_init(net.fc_in, keys[0])
        if not config.zero_init_head:
            _linear_init(net.fc_out, keys[1])
        for r, blk in enumerate(net.blocks):
            _linear_init(blk.fc1, keys[2 + 2 * r])
            _linear_init(blk.fc2, keys[3 + 2 * r])
    return net


def net_params_to_jax_tree(net_or_state) -> dict:
    """A ``DeformationNet`` (or its state dict) -> the JAX package's
    ``net_params`` pytree with numpy leaves (weights transposed back to
    (in, out), ``blocks`` a list), its keys in sorted order, as a JAX
    pytree comes out of a jitted step and is checkpointed: the reverse of
    ``state_dict_from_jax``."""
    sd = net_or_state.state_dict() if isinstance(net_or_state, nn.Module) else net_or_state

    def a(name, transpose=False):
        x = sd[name].detach().cpu()
        return (x.T if transpose else x).contiguous().numpy()

    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    return {
        "blocks": [
            {
                "bn1": {"beta": a(f"blocks.{i}.bn1.bias"), "gamma": a(f"blocks.{i}.bn1.weight")},
                "bn2": {"beta": a(f"blocks.{i}.bn2.bias"), "gamma": a(f"blocks.{i}.bn2.weight")},
                "fc1": {"w": a(f"blocks.{i}.fc1.weight", True)},
                "fc2": {"w": a(f"blocks.{i}.fc2.weight", True)},
            }
            for i in range(n_blocks)
        ],
        "fc_in": {"b": a("fc_in.bias"), "w": a("fc_in.weight", True)},
        "fc_out": {"b": a("fc_out.bias"), "w": a("fc_out.weight", True)},
    }


def state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's ``net_params`` pytree (numpy leaves) -> a
    ``DeformationNet`` state dict.

    JAX stores ``fc.w`` as (in, out) for ``x @ w``; ``nn.Linear`` keeps
    (out, in), so weights are transposed.  ``blocks`` may be a list (a live
    pytree) or a dict keyed "0", "1", ... (as flax msgpack stores lists).
    """
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
