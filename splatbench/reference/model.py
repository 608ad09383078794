"""The rest of the benchmark's plain-PyTorch reference: the deformation
network and its encodings, rigidity, SSIM and the losses, Adam and its
schedules, and exact kNN.  It imports nothing of the program.

The definitions are those of the JAX package, which the port keeps:

- network: fc_in (192 -> D, bias); per block Linear (no bias) -> BatchNorm ->
  GELU -> Linear (no bias) -> BatchNorm -> + skip -> GELU; fc_out (D -> 7,
  bias); plus the input means and quaternions where ``double_residual``.
  BatchNorm normalises with the batch's own statistics (biased variance, eps
  1e-5).  Float32 with TF32 off, or bfloat16 matmuls for a control;
- encoding: per-axis min-max to [-1, 1], sin(2^j pi x) and cos of it (or of
  sin of it under ``quirk_compat``), 10 frequencies for means, 4 for
  quaternions and for the progress t / T;
- deformation: means + s * delta[:3], quaternions + s * delta[3:], s the
  delta scale (times t / T under ``time_gate_head``);
- rigidity over the foreground's 20 nearest neighbours (weights
  exp(-2000 d^2)): mean(sqrt(sum((R^T o - o_prev)^2) w + 1e-20));
- SSIM: 11-tap Gaussian window (sigma 1.5), zero padding, c1 = 0.01^2,
  c2 = 0.03^2; image loss 0.8 L1 + 0.2 (1 - SSIM);
- Adam as optax's ``scale_by_adam`` (eps outside the square root, bias
  corrections with the incremented count), stage 2 under a warmup-cosine
  schedule read at the count before the increment.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from splatbench.reference.render import quat_normalize, rotation_entries

BN_EPS = 1e-5
L1_WEIGHT, SSIM_WEIGHT = 0.8, 0.2
RIGIDITY_WEIGHT = 3.0
RIGIDITY_K = 20
RIGIDITY_TEMPERATURE = 2000.0


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---- network ---------------------------------------------------------------

def positional_encoding(x, frequencies: int, quirk: bool):
    freqs = (2.0 ** torch.arange(frequencies, dtype=torch.float32, device=x.device)) * math.pi
    phases = x[:, :, None] * freqs
    s = torch.sin(phases)
    c = torch.cos(s) if quirk else torch.cos(phases)
    return torch.stack([s, c], dim=-1).reshape(x.shape[0], x.shape[1], -1).transpose(1, 2) \
        .reshape(x.shape[0], -1)


def minmax(x):
    shifted = x - x.amin(dim=0)
    return 2.0 * shifted / shifted.amax(dim=0) - 1.0


def encode_state(means, quats, quirk: bool):
    return torch.cat([positional_encoding(minmax(means), 10, quirk),
                      positional_encoding(minmax(quats), 4, quirk)], dim=1)


def progress(t, count, device):
    return (torch.tensor(float(t), dtype=torch.float32, device=device)
            / torch.tensor(float(count), dtype=torch.float32, device=device))


def net_forward(params: dict, x, blocks: int, dtype=torch.float32):
    """``params`` by the names of the port's state dict; ``dtype`` of the matmuls."""
    def linear(name, h, bias=True):
        y = h.to(dtype) @ params[f"{name}.weight"].to(dtype).T
        if bias:
            y = y + params[f"{name}.bias"].to(dtype)
        return y

    def bn(name, h):
        h32 = h.float()
        y = F.batch_norm(h32, None, None, params[f"{name}.weight"], params[f"{name}.bias"],
                         training=True, eps=BN_EPS)
        return y.to(h.dtype)

    h = linear("fc_in", x)
    for r in range(blocks):
        b = f"blocks.{r}"
        u = F.gelu(bn(f"{b}.bn1", linear(f"{b}.fc1", h, bias=False)))
        u = bn(f"{b}.bn2", linear(f"{b}.fc2", u, bias=False))
        h = F.gelu(u + h)
    return linear("fc_out", h).float()


def deform(params, head: dict, means, quats, enc_initial, enc_previous, t, t_count, blocks,
           dtype=torch.float32):
    """(deformed means, deformed quaternions) at timestep ``t``."""
    n = means.shape[0]
    prog = progress(t, t_count, means.device)
    enc_t = positional_encoding(prog.reshape(1, 1), 4, head["quirk_compat"]).expand(n, 8)
    x = torch.cat([enc_initial, enc_previous, enc_t], dim=1)
    out = net_forward(params, x, blocks, dtype)
    if head["double_residual"]:
        out = out + torch.cat([means, quats], dim=1)
    scale = head["delta_scale"]
    if head["time_gate_head"]:
        scale = scale * prog
    return means + scale * out[:, :3], quats + scale * out[:, 3:]


# ---- rigidity ----------------------------------------------------------------

def knn(points, k: int, rows: int = 2048):
    """Exact k nearest (each point excluded), ascending, ties by index:
    (indices (N, k) int64, squared distances (N, k)).  Candidates come from
    |a|^2 + |b|^2 - 2 a.b; their distances are then summed from the
    differences, which keeps the digits that the expanded form cancels."""
    pts = points.float()
    n = pts.shape[0]
    sq = (pts * pts).sum(-1)
    idx_out, d2_out = [], []
    extra = min(n - 1, k + 8)
    for r0 in range(0, n, rows):
        q = pts[r0:r0 + rows]
        rr = torch.arange(q.shape[0], device=pts.device)
        d2 = sq[r0:r0 + rows, None] + sq[None, :] - 2.0 * (q @ pts.T)
        d2[rr, rr + r0] = float("inf")
        _, cand = torch.topk(d2, extra, dim=1, largest=False)
        cand, _ = torch.sort(cand, dim=1)
        exact = ((pts[cand] - q[:, None, :]) ** 2).sum(-1)
        order = torch.argsort(exact, dim=1, stable=True)[:, :k]
        idx_out.append(cand.gather(1, order))
        d2_out.append(exact.gather(1, order))
    return torch.cat(idx_out), torch.cat(d2_out)


def quat_mult(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def conjugate(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def snapshot(fg_means, fg_quats, nbr_idx):
    """The previous frame: conjugated unit quaternions and neighbour offsets."""
    with torch.no_grad():
        return (conjugate(quat_normalize(fg_quats, eps=1e-12)),
                fg_means[nbr_idx] - fg_means[:, None])


def rigidity(fg_means, fg_quats, nbr_idx, nbr_w, previous):
    inv_prev, off_prev = previous
    rel = rotation_entries(quat_mult(quat_normalize(fg_quats, eps=1e-12), inv_prev), eps=1e-12)
    rel = torch.stack([torch.stack(r, dim=-1) for r in rel], dim=-2)
    off = fg_means[nbr_idx] - fg_means[:, None]
    in_prev = (rel[:, None, :, :] * off[:, :, :, None]).sum(dim=2)
    return torch.sqrt(((in_prev - off_prev) ** 2).sum(-1) * nbr_w + 1e-20).mean()


# ---- image losses --------------------------------------------------------------

def _window(size: int = 11, sigma: float = 1.5):
    xs = np.arange(size)
    g = np.exp(-((xs - size // 2) ** 2) / (2.0 * sigma**2))
    return [float(x) for x in (g / g.sum()).astype(np.float32)]


def _blur(img):
    w = _window()
    r = len(w) // 2
    for dim in (2, 3):
        pad = (0, 0, r, r) if dim == 2 else (r, r, 0, 0)
        p = F.pad(img, pad)
        size = img.shape[dim]
        img = sum(w[d] * p.narrow(dim, d, size) for d in range(len(w)))
    return img


def ssim_per_view(a, b):
    """(V,) mean SSIM of (V, C, H, W) images."""
    mu1, mu2 = _blur(a), _blur(b)
    s11 = _blur(a * a) - mu1 * mu1
    s22 = _blur(b * b) - mu2 * mu2
    s12 = _blur(a * b) - mu1 * mu2
    c1, c2 = 0.01**2, 0.03**2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean(dim=(1, 2, 3))


def l1_per_view(a, b):
    return (a - b).abs().mean(dim=(1, 2, 3))


# ---- Adam ----------------------------------------------------------------------

class Adam:
    """optax ``scale_by_adam`` over a dict of tensors."""

    def __init__(self, params: dict, eps: float, b1: float = 0.9, b2: float = 0.999):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def update(self, grads: dict) -> dict:
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(self.count))
        out = {}
        for k, g in grads.items():
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * (g * g) + self.b2 * self.nu[k]
            out[k] = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
        return out


def warmup_cosine(base_lr: float, warmup: int, total: int, step: int) -> float:
    """Linear from base / 1000 over ``warmup`` steps, then a half cosine, in float32."""
    f32 = np.float32
    t_max = max(total - warmup, 1)
    w = f32(max(warmup, 1))
    s = f32(step)
    if s < warmup:
        frac = f32(1.0 - 1e-3) * min(s, w) / w
        return float(f32(base_lr) * (f32(1e-3) + frac))
    angle = f32(np.pi) * max(s - f32(warmup), f32(0.0)) / f32(t_max)
    return float(f32(base_lr * 0.5) * (f32(1.0) + np.cos(angle, dtype=f32)))
