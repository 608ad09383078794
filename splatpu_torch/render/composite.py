"""Forward tile composite: the CUDA kernel's wrapper and its plain version.

Replaces ``splatpu/render/exact.py::_fwd_kernel_grid`` (via ``_fwd_call_grid``,
the TPU's forward composite).  The kernel is ``csrc/composite_fwd.cu``: one
block per (tile, view), one thread per pixel walking the tile's sorted pairs
front to back, records gathered from the per-Gaussian table by ``gid`` into
shared memory, block exit once every pixel is done.  On the H100 it is bound
by its FP32 arithmetic (~16 operations and one exp per evaluated
(pixel, pair)), not by its bytes (one table row per pair per tile plus the
outputs); the source note in the ``.cu`` file says what the design does
about that.

Inputs, shared by both versions (V views, N Gaussians, P pair slots, T tiles):

- ``table``  (V, N, 7 + C) float32 rows [mx, my, ca, cb, cc, opacity, depth,
  colour_0..colour_{C-1}] (``pack_table``);
- ``gid``    (V, P) int32 depth-sorted pair -> Gaussian id;
- ``start``, ``end`` (V, T) int32 each tile's [start, end) in ``gid``;
- ``bg``     (C,) float32.

Outputs: image (V, C, H, W), depth (V, H, W), final transmittance (V, H, W)
and the int32 position of the last contributing pair (V, H, W), -1 where
none contributed.
"""

from __future__ import annotations

import ctypes

import torch

from splatpu_torch import _build
from splatpu_torch.core.projection import ALPHA_MAX, ALPHA_MIN, TRANSMITTANCE_EPS

REC_GEOM = 7
MAX_C = 5

LAUNCHES = 0  # kernel launches made by composite_fwd_cuda


def pack_table(mean2d, conic, opacity, depth, colors) -> torch.Tensor:
    """(N, 7 + C) per-Gaussian record rows of one view."""
    return torch.cat(
        [mean2d, conic, opacity[:, None], depth[:, None], colors], dim=1
    ).contiguous()


def _check_inputs(table, gid, start, end, bg, tiles_x, tiles_y, tile):
    if table.dim() != 3 or gid.dim() != 2 or start.dim() != 2 or end.dim() != 2:
        raise ValueError("expected table (V,N,R), gid (V,P), start/end (V,T)")
    v, _, rec = table.shape
    c = rec - REC_GEOM
    if not 1 <= c <= MAX_C:
        raise ValueError(f"the composite takes 1..{MAX_C} channels, got {c}")
    if gid.shape[0] != v or start.shape != (v, tiles_x * tiles_y) or end.shape != start.shape:
        raise ValueError("gid/start/end do not match the table's views and tile grid")
    if bg.shape != (c,):
        raise ValueError(f"bg must have shape ({c},), got {tuple(bg.shape)}")
    if tile * tile > 1024:
        raise ValueError(f"tile {tile} needs more than 1024 threads per block")
    for name, x, dt in (
        ("table", table, torch.float32), ("gid", gid, torch.int32),
        ("start", start, torch.int32), ("end", end, torch.int32),
        ("bg", bg, torch.float32),
    ):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
    return v, c


def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    fn = lib.splatpu_composite_fwd
    # Pointers and the stream as c_void_p: ctypes would otherwise pass each
    # Python int as a 32-bit int and cut the pointer.
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def composite_fwd_cuda(table, gid, start, end, bg, *, tiles_x, tiles_y, tile, width, height):
    """Launch the CUDA kernel; every tensor must be a contiguous CUDA tensor."""
    global LAUNCHES
    tensors = (table, gid, start, end, bg)
    if not all(x.is_cuda for x in tensors):
        raise ValueError("composite_fwd_cuda takes CUDA tensors only")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("composite_fwd_cuda takes contiguous tensors only")
    v, c = _check_inputs(table, gid, start, end, bg, tiles_x, tiles_y, tile)
    dev = table.device
    image = torch.empty((v, c, height, width), dtype=torch.float32, device=dev)
    depth = torch.empty((v, height, width), dtype=torch.float32, device=dev)
    tfin = torch.empty_like(depth)
    last = torch.empty((v, height, width), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.splatpu_composite_fwd(
            table.data_ptr(), gid.data_ptr(), start.data_ptr(), end.data_ptr(),
            bg.data_ptr(), image.data_ptr(), depth.data_ptr(), tfin.data_ptr(),
            last.data_ptr(), v, table.shape[1], gid.shape[1], c, tiles_x,
            tiles_y, tile, width, height, stream,
        )
    _build.check_status(lib, code, "composite_fwd launch")
    LAUNCHES += 1
    return image, depth, tfin, last


def untile(x: torch.Tensor, tiles_x: int, tiles_y: int, tile: int, width: int, height: int):
    """(V, T, tile*tile, K) tile-major -> (V, K, H, W) image layout, cropped."""
    v, _, _, k = x.shape
    x = x.reshape(v, tiles_y, tiles_x, tile, tile, k).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(v, k, tiles_y * tile, tiles_x * tile)[:, :, :height, :width]


def composite_fwd_plain(
    table, gid, start, end, bg, *, tiles_x, tiles_y, tile, width, height,
    chunk: int = 256, with_counts: bool = False,
):
    """The same function in plain PyTorch, vectorised over pairs.

    Tiles are processed in batches; each batch walks its segments in chunks
    of ``chunk`` pairs, carrying T and a done flag per pixel.  Within a chunk
    the exclusive transmittance is a cumprod of (1 - alpha), and the first
    pair that would drop T below 1e-4 cuts itself and the rest of the chunk
    (first-fail masking) — the serial walk's semantics, with the products
    taken in another order.  Transmittance and the sums are carried in
    float64, so that over the hundreds of pairs of a 720p tile this
    version's rounding stays well below the kernel's float32 rounding it is
    compared with; the outputs are float32.

    ``with_counts`` also returns, per pixel, the (pixel, pair) evaluations the
    serial walk makes (up to and including the cutting pair) and the pairs
    that contribute: the work this input needs, for the kernel's bound.
    """
    v, c = _check_inputs(table, gid, start, end, bg, tiles_x, tiles_y, tile)
    dev = table.device
    n_rec = table.shape[1]
    p = gid.shape[1]
    nt = tiles_x * tiles_y
    npix = tile * tile
    table_flat = table.reshape(v * n_rec, -1)
    gid_flat = gid.reshape(-1).long()
    starts = start.reshape(-1).long()
    ends = end.reshape(-1).long()
    view_of = torch.arange(v * nt, device=dev) // nt
    t_of = torch.arange(v * nt, device=dev) % nt
    ox = ((t_of % tiles_x) * tile).float()
    oy = ((t_of // tiles_x) * tile).float()
    pix = torch.arange(npix, device=dev)
    lx = (pix % tile).float()
    ly = (pix // tile).float()

    f64 = torch.float64
    acc_all = torch.zeros((v * nt, npix, c + 1), dtype=f64, device=dev)
    t_all = torch.ones((v * nt, npix), dtype=f64, device=dev)
    last_all = torch.full((v * nt, npix), -1, dtype=torch.int64, device=dev)
    n_eval_all = torch.zeros((v * nt, npix), dtype=torch.int64, device=dev)
    n_contrib_all = torch.zeros_like(n_eval_all)

    lengths = (ends - starts).clamp(min=0)
    g = max(1, min(chunk, int(lengths.max()) if lengths.numel() else 1))
    batch = max(1, (1 << 22) // (npix * g))
    lanes = torch.arange(g, device=dev)
    for b0 in range(0, v * nt, batch):
        sl = slice(b0, min(b0 + batch, v * nt))
        seg_len = int(lengths[sl].max())
        if seg_len == 0:
            continue
        b = sl.stop - sl.start
        t_car = torch.ones((b, npix), dtype=f64, device=dev)
        done = torch.zeros((b, npix), dtype=torch.bool, device=dev)
        acc = torch.zeros((b, npix, c + 1), dtype=f64, device=dev)
        last = torch.full((b, npix), -1, dtype=torch.int64, device=dev)
        n_eval = torch.zeros((b, npix), dtype=torch.int64, device=dev)
        n_contrib = torch.zeros_like(n_eval)
        for k0 in range(0, seg_len, g):
            pos = starts[sl, None] + k0 + lanes[None, :]           # (B, G)
            live = pos < ends[sl, None]
            pos_c = torch.where(live, pos, torch.zeros_like(pos))
            gids = gid_flat[view_of[sl, None] * p + pos_c]
            rec = table_flat[view_of[sl, None] * n_rec + gids]       # (B, G, R)
            mx = (rec[..., 0] - ox[sl, None])[:, None, :]
            my = (rec[..., 1] - oy[sl, None])[:, None, :]
            ca, cb, cc, op = (rec[..., i][:, None, :] for i in (2, 3, 4, 5))
            dx = lx[None, :, None] - mx                               # (B, NPIX, G)
            dy = ly[None, :, None] - my
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
            keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & live[:, None, :]
            alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
            one_minus = (1.0 - alpha).double()
            incl = torch.cumprod(one_minus, dim=2)
            ones = torch.ones_like(incl[..., :1])
            excl_ext = torch.cat([ones, incl], dim=2)                 # (B, NPIX, G+1)
            t_excl = t_car[..., None] * excl_ext[..., :-1]
            fail = (t_excl * one_minus < TRANSMITTANCE_EPS) & (alpha > 0.0)
            first_fail = torch.where(fail, lanes, torch.full_like(lanes, g)).amin(dim=2)
            contribute = (lanes < first_fail[..., None]) & ~done[..., None]
            w = torch.where(contribute, alpha * t_excl, torch.zeros_like(t_excl))
            acc += torch.einsum("bpg,bgr->bpr", w, rec[..., REC_GEOM - 1 :].double())
            t_new = t_car * torch.gather(excl_ext, 2, first_fail[..., None])[..., 0]
            t_car = torch.where(done, t_car, t_new)
            hit = contribute & (alpha > 0.0)
            pos_hit = torch.where(hit, pos[:, None, :], torch.full_like(pos[:, None, :], -1))
            last = torch.maximum(last, pos_hit.amax(dim=2))
            if with_counts:
                n_live = live.sum(dim=1)[:, None]
                walked = torch.where(first_fail < g, first_fail + 1, n_live)
                n_eval += torch.where(done, torch.zeros_like(walked), walked)
                n_contrib += hit.sum(dim=2)
            done = done | fail.any(dim=2)
            if bool(done.all()):
                break
        acc_all[sl] = acc
        t_all[sl] = t_car
        last_all[sl] = last
        n_eval_all[sl] = n_eval
        n_contrib_all[sl] = n_contrib

    img_t = acc_all[..., 1:] + t_all[..., None] * bg.double()
    packed = torch.cat(
        [img_t, acc_all[..., :1], t_all[..., None]], dim=-1
    ).float().reshape(v, nt, npix, c + 2)
    full = untile(packed, tiles_x, tiles_y, tile, width, height)
    last_full = untile(
        last_all.reshape(v, nt, npix, 1), tiles_x, tiles_y, tile, width, height
    )[:, 0].to(torch.int32)
    out = (full[:, :c].contiguous(), full[:, c].contiguous(),
           full[:, c + 1].contiguous(), last_full.contiguous())
    if not with_counts:
        return out
    counts = untile(
        torch.stack([n_eval_all, n_contrib_all], dim=-1).reshape(v, nt, npix, 2),
        tiles_x, tiles_y, tile, width, height,
    )
    return out + (counts[:, 0].contiguous(), counts[:, 1].contiguous())
