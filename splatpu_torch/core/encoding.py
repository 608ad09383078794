"""NeRF-style positional encoding (port of ``splatpu/core/encoding.py``).

For x of shape (N, D) and F frequencies the output is (N, 2F*D), laid out
in channel-major blocks of D:

    out[n, (2j)*D + d]   = sin(2^j * pi * x[n, d])
    out[n, (2j+1)*D + d] = cos(sin(2^j * pi * x[n, d]))   # quirk_compat
                         = cos(2^j * pi * x[n, d])        # otherwise
"""

import math

import torch


def positional_encoding(
    x: torch.Tensor, frequency_count: int, quirk_compat: bool = True
) -> torch.Tensor:
    freqs = (
        2.0 ** torch.arange(frequency_count, dtype=torch.float32, device=x.device)
    ) * math.pi
    phases = x[:, :, None] * freqs  # (N, D, F)
    s = torch.sin(phases)
    c = torch.cos(s) if quirk_compat else torch.cos(phases)
    interleaved = torch.stack([s, c], dim=-1).reshape(x.shape[0], x.shape[1], -1)
    return interleaved.transpose(1, 2).reshape(x.shape[0], -1)

