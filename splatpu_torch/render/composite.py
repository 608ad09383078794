"""Tile composite, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Two pairs of kernels gather their records from the per-Gaussian table:

- K1 and K2 replace ``splatpu/render/exact.py::_fwd_kernel_grid`` and
  ``_bwd_kernel_grid`` (via ``_fwd_call_grid`` / ``_bwd_call_grid``, the
  TPU's default ``kernel="grid"``): ``csrc/composite_fwd.cu`` and
  ``csrc/composite_bwd.cu``, 1..5 colour channels, as the grid kernel;
- K4 replaces ``exact.py::_fwd_kernel`` and ``_bwd_kernel`` (via
  ``_fwd_call`` / ``_bwd_call``, ``kernel="manual"``):
  ``csrc/composite_manual_fwd.cu`` and ``csrc/composite_manual_bwd.cu``,
  1..9 channels (``NREC - R_COLOR0`` of the TPU kernels) and any pair
  budget, with the channel count a template parameter.

The forward kernels: tiles of every multiple of 8 from 8 to 64 px
(``FWD_TILES``; any other tile is refused before a launch, by the plain
versions too), one block per (tile, view) of 8, 16 or 24 px, or per 16 px
square of a 32, 48 or 64 px tile, or per 8 px square of a 40 or 56 px
tile; each thread walks 2 pixels of one column
front to back over the tile's sorted pairs, records gathered by ``gid``
into shared memory a batch ahead; each warp skips the pairs that cannot
reach its 8 x 8 pixels; block exit once every pixel is done; T is carried
in float64, as the plain version does.  On the H100 they are bound by their FP32 arithmetic (~16
operations and one exp per evaluated (pixel, pair)), not by their bytes;
``csrc/composite_common.cuh`` says what the design does about that.

Inputs, shared by all versions (V views, N Gaussians, P pair slots, T tiles):

- ``table``  (V, N, 7 + C) float32 rows [mx, my, ca, cb, cc, opacity, depth,
  colour_0..colour_{C-1}] (``pack_table``);
- ``gid``    (V, P) int32 depth-sorted pair -> Gaussian id;
- ``start``, ``end`` (V, T) int32 each tile's [start, end) in ``gid``;
- ``bg``     (C,) float32.

Outputs: image (V, C, H, W), depth (V, H, W), final transmittance (V, H, W)
and the int32 position of the last contributing pair (V, H, W), -1 where
none contributed.

The backward kernels: one block per (tile, view), each thread walking
``bwd_pix(tile)`` pixels of one column (2 at 8 px, 4 at 16, 32 and 48, 3
at 24, 5 at 40, 7 at 56, 8 at 64) back to front from their forward
``last``,
per-pair sums over the tile's pixels in registers, then a reduce-scatter of
warp shuffles and a fixed-order sum across warps, no atomics.  They take the forward inputs plus the forward's final T and
``last`` and the cotangents ``g_img`` (V, C, H, W), ``g_depth`` and
``g_tf`` (V, H, W), and return the per-pair gradient rows (V, P, 7 + C) in
the table's row order; pairs that no pixel composited keep a zero row.

The plain versions (``composite_*_plain``) are the same functions in plain
PyTorch, vectorised over pairs (``fwd_walk`` / ``bwd_walk``, which the
padded composite of ``render/padded.py`` shares).
"""

from __future__ import annotations

import torch

from splatpu_torch import _build
from splatpu_torch.core.projection import ALPHA_MAX, ALPHA_MIN, TRANSMITTANCE_EPS

REC_GEOM = 7
MAX_C = 5          # K1/K2, as the TPU grid kernel's packed output
MAX_C_MANUAL = 9   # K4: the TPU kernels' NREC - R_COLOR0
FWD_TILES = (8, 16, 24, 32, 40, 48, 56, 64)  # the tiles the forward body takes (px)
BWD_TILES = FWD_TILES  # the tiles the backward body takes (px)

LAUNCHES = 0             # kernel launches made by composite_fwd_cuda (K1)
BWD_LAUNCHES = 0         # by composite_bwd_cuda (K2)
MANUAL_LAUNCHES = 0      # by composite_manual_fwd_cuda (K4 forward)
MANUAL_BWD_LAUNCHES = 0  # by composite_manual_bwd_cuda (K4 backward)


def pack_table(mean2d, conic, opacity, depth, colors) -> torch.Tensor:
    """(N, 7 + C) per-Gaussian record rows of one view."""
    return torch.cat(
        [mean2d, conic, opacity[:, None], depth[:, None], colors], dim=1
    ).contiguous()


def check_types(**named) -> None:
    for name, (x, dt) in named.items():
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")


def _check_inputs(table, gid, start, end, bg, tiles_x, tiles_y, tile, max_c=MAX_C):
    if table.dim() != 3 or gid.dim() != 2 or start.dim() != 2 or end.dim() != 2:
        raise ValueError("expected table (V,N,R), gid (V,P), start/end (V,T)")
    v, _, rec = table.shape
    c = rec - REC_GEOM
    if not 1 <= c <= max_c:
        raise ValueError(f"the composite takes 1..{max_c} channels, got {c}")
    if gid.shape[0] != v or start.shape != (v, tiles_x * tiles_y) or end.shape != start.shape:
        raise ValueError("gid/start/end do not match the table's views and tile grid")
    if bg.shape != (c,):
        raise ValueError(f"bg must have shape ({c},), got {tuple(bg.shape)}")
    if tile not in FWD_TILES:
        raise ValueError(f"the composite takes {FWD_TILES} px tiles, got {tile}")
    check_types(table=(table, torch.float32), gid=(gid, torch.int32),
                start=(start, torch.int32), end=(end, torch.int32), bg=(bg, torch.float32))
    return v, c


def _fwd_cuda(entry, max_c, table, gid, start, end, bg, tiles_x, tiles_y, tile, width, height):
    """Check the inputs, allocate the outputs and call one forward launcher."""
    _build.require_cuda(entry, (table, gid, start, end, bg))
    v, c = _check_inputs(table, gid, start, end, bg, tiles_x, tiles_y, tile, max_c)
    dev = table.device
    image = torch.empty((v, c, height, width), dtype=torch.float32, device=dev)
    depth = torch.empty((v, height, width), dtype=torch.float32, device=dev)
    tfin = torch.empty_like(depth)
    last = torch.empty((v, height, width), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, f"splatpu_{entry}")(
            table.data_ptr(), gid.data_ptr(), start.data_ptr(), end.data_ptr(),
            bg.data_ptr(), image.data_ptr(), depth.data_ptr(), tfin.data_ptr(),
            last.data_ptr(), v, table.shape[1], gid.shape[1], c, tiles_x,
            tiles_y, tile, width, height, stream,
        )
    _build.check_status(lib, code, f"{entry} launch")
    return image, depth, tfin, last


def composite_fwd_cuda(table, gid, start, end, bg, *, tiles_x, tiles_y, tile, width, height):
    """Launch K1; every tensor must be a contiguous CUDA tensor."""
    global LAUNCHES
    out = _fwd_cuda("composite_fwd", MAX_C, table, gid, start, end, bg,
                    tiles_x, tiles_y, tile, width, height)
    LAUNCHES += 1
    return out


def composite_manual_fwd_cuda(table, gid, start, end, bg, *, tiles_x, tiles_y, tile, width,
                              height):
    """Launch K4's forward; every tensor must be a contiguous CUDA tensor."""
    global MANUAL_LAUNCHES
    out = _fwd_cuda("composite_manual_fwd", MAX_C_MANUAL, table, gid, start, end, bg,
                    tiles_x, tiles_y, tile, width, height)
    MANUAL_LAUNCHES += 1
    return out


def untile(x: torch.Tensor, tiles_x: int, tiles_y: int, tile: int, width: int, height: int):
    """(V, T, tile*tile, K) tile-major -> (V, K, H, W) image layout, cropped."""
    v, _, _, k = x.shape
    x = x.reshape(v, tiles_y, tiles_x, tile, tile, k).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(v, k, tiles_y * tile, tiles_x * tile)[:, :, :height, :width]


def to_tiles(x: torch.Tensor, tiles_x: int, tiles_y: int, tile: int, fill=0):
    """(V, K, H, W) image layout -> (V * T, tile*tile, K) tile-major, the
    pixels beyond the image set to ``fill`` (the inverse of ``untile``)."""
    v, k, h, w = x.shape
    x = torch.nn.functional.pad(x, (0, tiles_x * tile - w, 0, tiles_y * tile - h), value=fill)
    x = x.reshape(v, k, tiles_y, tile, tiles_x, tile).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(v * tiles_y * tiles_x, tile * tile, k)


def _tile_frames(v, nt, tiles_x, tile, dev):
    """Per (view, tile) row: its view and tile origin; per pixel of a tile:
    its tile-local coordinates."""
    vt = torch.arange(v * nt, device=dev)
    t_of = vt % nt
    pix = torch.arange(tile * tile, device=dev)
    return (vt // nt, ((t_of % tiles_x) * tile).float(), ((t_of // tiles_x) * tile).float(),
            (pix % tile).float(), (pix // tile).float())


def _chunk_geometry(rec, ox, oy, lx, ly, padded):
    """dx, dy (B, NPIX, G) of the pixels against a chunk's records.

    The grid and manual kernels work in tile-local coordinates (means minus
    the tile origin, pixel in tile); the padded kernel (K5) in absolute
    pixel coordinates, as its TPU kernel does.  Each form is the kernels'
    own rounding, op by op."""
    if padded:
        px = (ox[:, None] + lx[None, :])[:, :, None]
        py = (oy[:, None] + ly[None, :])[:, :, None]
        return px - rec[..., 0][:, None, :], py - rec[..., 1][:, None, :]
    mx = (rec[..., 0] - ox[:, None])[:, None, :]
    my = (rec[..., 1] - oy[:, None])[:, None, :]
    return lx[None, :, None] - mx, ly[None, :, None] - my


def fwd_walk(fetch, start, end, bg, *, v, c, tiles_x, tiles_y, tile, width, height,
             padded=False, chunk=256, with_counts=False):
    """The forward composite in plain PyTorch, vectorised over pairs.

    ``fetch(view (B, 1), pos (B, G))`` returns the records (B, G, 7 + C) at
    those pair positions.  Tiles are processed in batches; each batch walks
    its segments in chunks of ``chunk`` pairs, carrying T and a done flag
    per pixel.  Within a chunk the exclusive transmittance is a cumprod of
    (1 - alpha), and the first pair that would drop T below 1e-4 cuts
    itself and the rest of the chunk (first-fail masking) — the serial
    walk's semantics, with the products taken in another order.
    Transmittance and the sums are carried in float64, so that over the
    hundreds of pairs of a 720p tile this version's rounding stays well
    below the kernels' float32 rounding it is compared with; the outputs
    are float32.

    ``with_counts`` also returns, per pixel, the (pixel, pair) evaluations the
    serial walk makes (up to and including the cutting pair) and the pairs
    that contribute: the work this input needs, for the kernels' bounds.
    """
    dev = bg.device
    nt = tiles_x * tiles_y
    npix = tile * tile
    starts = start.reshape(-1).long()
    ends = end.reshape(-1).long()
    view_of, ox, oy, lx, ly = _tile_frames(v, nt, tiles_x, tile, dev)

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
            rec = fetch(view_of[sl, None], torch.where(live, pos, torch.zeros_like(pos)))
            dx, dy = _chunk_geometry(rec, ox[sl], oy[sl], lx, ly, padded)  # (B, NPIX, G)
            ca, cb, cc, op = (rec[..., i][:, None, :] for i in (2, 3, 4, 5))
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


def table_fetch(table, gid):
    """``fwd_walk``'s record fetch for the table kernels: gather each pair's
    Gaussian row by ``gid``."""
    v, n_rec, rec_n = table.shape
    p = gid.shape[1]
    table_flat = table.reshape(v * n_rec, rec_n)
    gid_flat = gid.reshape(-1).long()
    return lambda view, pos: table_flat[view * n_rec + gid_flat[view * p + pos]]


def _fwd_plain(max_c, table, gid, start, end, bg, geo, chunk, with_counts):
    v, c = _check_inputs(table, gid, start, end, bg, geo["tiles_x"], geo["tiles_y"],
                         geo["tile"], max_c)
    return fwd_walk(table_fetch(table, gid), start, end, bg, v=v, c=c, **geo, chunk=chunk,
                    with_counts=with_counts)


def composite_fwd_plain(
    table, gid, start, end, bg, *, tiles_x, tiles_y, tile, width, height,
    chunk: int = 256, with_counts: bool = False,
):
    """K1's function in plain PyTorch (``fwd_walk``), 1..5 channels."""
    geo = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile=tile, width=width, height=height)
    return _fwd_plain(MAX_C, table, gid, start, end, bg, geo, chunk, with_counts)


def composite_manual_fwd_plain(
    table, gid, start, end, bg, *, tiles_x, tiles_y, tile, width, height,
    chunk: int = 256, with_counts: bool = False,
):
    """K4's forward in plain PyTorch: the same walk, 1..9 channels."""
    geo = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile=tile, width=width, height=height)
    return _fwd_plain(MAX_C_MANUAL, table, gid, start, end, bg, geo, chunk, with_counts)


def check_bwd_inputs(tfinal, last, g_img, g_depth, g_tf, v, c, width, height):
    pix = (v, height, width)
    for name, x, shape, dt in (
        ("tfinal", tfinal, pix, torch.float32), ("last", last, pix, torch.int32),
        ("g_img", g_img, (v, c, height, width), torch.float32),
        ("g_depth", g_depth, pix, torch.float32), ("g_tf", g_tf, pix, torch.float32),
    ):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")


def _bwd_cuda(entry, max_c, table, gid, start, end, bg, tfinal, last, g_img, g_depth, g_tf,
              tiles_x, tiles_y, tile, width, height):
    tensors = (table, gid, start, end, bg, tfinal, last, g_img, g_depth, g_tf)
    _build.require_cuda(entry, tensors)
    v, c = _check_inputs(table, gid, start, end, bg, tiles_x, tiles_y, tile, max_c)
    check_bwd_inputs(tfinal, last, g_img, g_depth, g_tf, v, c, width, height)
    p = gid.shape[1]
    d_rows = torch.zeros((v, p, table.shape[2]), dtype=torch.float32, device=table.device)
    lib = _build.load_library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        code = getattr(lib, f"splatpu_{entry}")(
            *(x.data_ptr() for x in tensors), d_rows.data_ptr(), v, table.shape[1], p, c,
            tiles_x, tiles_y, tile, width, height, stream,
        )
    _build.check_status(lib, code, f"{entry} launch")
    return d_rows


def composite_bwd_cuda(
    table, gid, start, end, bg, tfinal, last, g_img, g_depth, g_tf,
    *, tiles_x, tiles_y, tile, width, height,
):
    """Launch K2; every tensor must be a contiguous CUDA tensor.  Returns
    the per-pair gradient rows (V, P, 7 + C)."""
    global BWD_LAUNCHES
    rows = _bwd_cuda("composite_bwd", MAX_C, table, gid, start, end, bg, tfinal, last, g_img,
                     g_depth, g_tf, tiles_x, tiles_y, tile, width, height)
    BWD_LAUNCHES += 1
    return rows


def composite_manual_bwd_cuda(
    table, gid, start, end, bg, tfinal, last, g_img, g_depth, g_tf,
    *, tiles_x, tiles_y, tile, width, height,
):
    """Launch K4's backward; every tensor must be a contiguous CUDA tensor.
    Returns the per-pair gradient rows (V, P, 7 + C)."""
    global MANUAL_BWD_LAUNCHES
    rows = _bwd_cuda("composite_manual_bwd", MAX_C_MANUAL, table, gid, start, end, bg, tfinal,
                     last, g_img, g_depth, g_tf, tiles_x, tiles_y, tile, width, height)
    MANUAL_BWD_LAUNCHES += 1
    return rows


def bwd_walk(fetch, start, end, bg, tfinal, last, g_img, g_depth, g_tf, *, v, c, p,
             tiles_x, tiles_y, tile, width, height, padded=False, chunk=256):
    """The backward composite in plain PyTorch, vectorised over pairs;
    ``fetch`` as in ``fwd_walk``, ``p`` the pair positions of a view.

    Tiles are processed in batches; each batch walks its segments back to
    front in chunks of ``chunk`` pairs, from the tile's largest ``last``
    down, carrying per pixel the transmittance T (divided by 1 - alpha per
    live pair, as the kernels do) and the suffix sum.  Within a chunk the
    suffix products and sums are a cumprod / cumsum along the reversed
    lanes.  Alpha is computed in float32 as the forward does; T, the suffix
    and the row sums are carried in float64, so this version's rounding
    stays well below the kernels' float32 rounding it is compared with.

    The opacity row is sum(dpower) / opacity for the table kernels (the
    TPU grid and manual kernels' form) and sum(exp(power) * dalpha) for the
    padded kernel (``padded``, its TPU kernel's form); both are zero where
    the raw alpha is clamped.
    """
    dev = bg.device
    rec_n = REC_GEOM + c
    nt = tiles_x * tiles_y
    npix = tile * tile
    f64 = torch.float64
    starts = start.reshape(-1).long()
    ends = end.reshape(-1).long()
    view_of, ox, oy, lx, ly = _tile_frames(v, nt, tiles_x, tile, dev)

    geo = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile=tile)
    gimg_t = to_tiles(g_img, **geo).double()                         # (VT, NPIX, C)
    gdep_t = to_tiles(g_depth[:, None], **geo)[..., 0].double()      # (VT, NPIX)
    tfin_t = to_tiles(tfinal[:, None], **geo)[..., 0].double()
    gtf_t = to_tiles(g_tf[:, None], **geo)[..., 0].double()
    last_t = to_tiles(last[:, None].long(), **geo, fill=-1)[..., 0]  # (VT, NPIX)
    s_init = tfin_t * (gtf_t + (gimg_t * bg.double()).sum(-1))

    top = torch.minimum(ends - 1, last_t.amax(dim=1))               # (VT,)
    lengths = (top - starts + 1).clamp(min=0)
    out = torch.zeros((v * p, rec_n), dtype=f64, device=dev)
    g = max(1, min(chunk, int(lengths.max()) if lengths.numel() else 1))
    batch = max(1, (1 << 21) // (npix * g))
    lanes = torch.arange(g, device=dev)
    for b0 in range(0, v * nt, batch):
        sl = slice(b0, min(b0 + batch, v * nt))
        seg_len = int(lengths[sl].max())
        if seg_len == 0:
            continue
        t_car = tfin_t[sl].clone()
        s_car = s_init[sl].clone()
        gimg, gdep, last_b = gimg_t[sl], gdep_t[sl], last_t[sl]
        for k0 in range(0, seg_len, g):
            pos = top[sl, None] - k0 - lanes[None, :]                 # (B, G) descending
            live_p = pos >= starts[sl, None]
            pos_c = torch.where(live_p, pos, torch.zeros_like(pos))
            rec = fetch(view_of[sl, None], pos_c)                     # (B, G, R)
            dx, dy = _chunk_geometry(rec, ox[sl], oy[sl], lx, ly, padded)  # (B, NPIX, G)
            ca, cb, cc, op = (rec[..., i][:, None, :] for i in (2, 3, 4, 5))
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            e_power = torch.exp(power)
            raw = op * e_power
            alpha = torch.clamp(raw, max=ALPHA_MAX)
            live = (
                ~(power > 0.0) & (alpha >= ALPHA_MIN) & live_p[:, None, :]
                & (pos[:, None, :] <= last_b[:, :, None])
            )
            alpha = torch.where(live, alpha, torch.zeros_like(alpha)).double()
            one_m = 1.0 - alpha
            t_excl = t_car[..., None] / torch.cumprod(one_m, dim=2)
            chat = gdep[..., None] * rec[..., 6].double()[:, None, :]
            for ch in range(c):
                chat = chat + gimg[..., ch : ch + 1] * rec[..., REC_GEOM + ch].double()[:, None, :]
            w = alpha * t_excl
            wchat = w * chat
            suffix = s_car[..., None] + torch.cumsum(wchat, dim=2) - wchat
            dalpha = torch.where(live, t_excl * chat - suffix / one_m, torch.zeros_like(w))
            unclamped = raw < ALPHA_MAX
            dpower = torch.where(unclamped, alpha * dalpha, torch.zeros_like(w))
            dx, dy = dx.double(), dy.double()
            ca, cb, cc, op = ca.double(), cb.double(), cc.double(), op.double()
            if padded:
                op_row = torch.where(unclamped, e_power.double() * dalpha,
                                     torch.zeros_like(w)).sum(1)
            else:
                op_row = torch.where(
                    op[:, 0] > 0.0, dpower.sum(1) / op[:, 0].clamp(min=1e-30),
                    torch.zeros_like(op[:, 0]),
                )
            rows = [
                ((ca * dx + cb * dy) * dpower).sum(1),
                ((cc * dy + cb * dx) * dpower).sum(1),
                (-0.5 * dx * dx * dpower).sum(1),
                (-dx * dy * dpower).sum(1),
                (-0.5 * dy * dy * dpower).sum(1),
                op_row,
                (w * gdep[..., None]).sum(1),
            ] + [(w * gimg[..., ch : ch + 1]).sum(1) for ch in range(c)]
            rows = torch.stack(rows, dim=-1)                          # (B, G, R)
            flat = view_of[sl, None] * p + pos_c
            out[flat[live_p]] = rows[live_p]
            t_car = t_excl[..., -1]
            s_car = s_car + wchat.sum(2)
    return out.float().reshape(v, p, rec_n)


def _bwd_plain(max_c, table, gid, start, end, bg, tfinal, last, g_img, g_depth, g_tf, geo,
               chunk):
    v, c = _check_inputs(table, gid, start, end, bg, geo["tiles_x"], geo["tiles_y"],
                         geo["tile"], max_c)
    check_bwd_inputs(tfinal, last, g_img, g_depth, g_tf, v, c, geo["width"], geo["height"])
    return bwd_walk(table_fetch(table, gid), start, end, bg, tfinal, last, g_img, g_depth,
                    g_tf, v=v, c=c, p=gid.shape[1], **geo, chunk=chunk)


def composite_bwd_plain(
    table, gid, start, end, bg, tfinal, last, g_img, g_depth, g_tf,
    *, tiles_x, tiles_y, tile, width, height, chunk: int = 256,
):
    """K2's function in plain PyTorch (``bwd_walk``), 1..5 channels."""
    geo = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile=tile, width=width, height=height)
    return _bwd_plain(MAX_C, table, gid, start, end, bg, tfinal, last, g_img, g_depth, g_tf,
                      geo, chunk)


def composite_manual_bwd_plain(
    table, gid, start, end, bg, tfinal, last, g_img, g_depth, g_tf,
    *, tiles_x, tiles_y, tile, width, height, chunk: int = 256,
):
    """K4's backward in plain PyTorch: the same walk, 1..9 channels."""
    geo = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile=tile, width=width, height=height)
    return _bwd_plain(MAX_C_MANUAL, table, gid, start, end, bg, tfinal, last, g_img, g_depth,
                      g_tf, geo, chunk)
