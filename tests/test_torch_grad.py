"""Render gradients and gradient routing: the port against the JAX package.

- render(impl="plain") and render(impl="oracle") gradients against
  jax.grad through the JAX render(impl="pallas") (interpret mode off the
  TPU) and through impl="oracle", on the scenes of tests/test_render_exact.py
  (48x32, tiles 16 and 32), scaled by the reference's largest gradient,
  atol 1e-4 (the tolerance of test_render_exact.py's gradient tests);
- pos_of_slot_of: identical integers;
- the plain routing against the JAX package's _route_to_table, and in its
  padded mode against a numpy transcription of the padded stream's routing
  (pallas_composite.py:507-520) on seeded slot maps with slots past the
  budget;
- the routing's per-Gaussian sums against _cumsum_pairs_pallas (interpret
  mode) on an (R, 2 * 2048) block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatpu.core.types as jt
import splatpu.render.exact as jexact
from splatpu.render.api import render as jax_render
from splatpu.render.binning import BinningConfig as JBinningConfig
import splatpu_torch.core.types as tt
from splatpu_torch.render.api import render
from splatpu_torch.render.binning import BinningConfig
from splatpu_torch.render.exact import build_exact_stream
from splatpu_torch.render.route import pos_of_slot_of, route_pairs_plain
from _torch_scenes import jax_camera, jax_cloud, np_cloud, np_lookat, torch_camera, torch_cloud

torch.set_num_threads(1)

W, H = 48, 32
EYE = (0.3, -0.2, -4.0)
BG = np.array([0.1, 0.2, 0.3], np.float32)
PARAMS = ("means", "colors", "rotation_quaternions", "opacity_logits", "log_scales")
GRAD_ATOL = 1e-4


def cfg(tile):
    return dict(tile=tile, max_span=64, max_pairs=1 << 12, chunk_pairs=256)


def jax_loss(params, cloud, cam, impl, bcfg):
    c = cloud.replace(**params)
    out = jax_render(jt.activate_cloud(c), cam, bg=jnp.asarray(BG), impl=impl, config=bcfg)
    return (
        jnp.mean(jnp.abs(out.image - 0.4))
        + 0.1 * jnp.mean(out.depth)
        + 0.05 * jnp.mean(out.final_transmittance)
    )


jax_grad = jax.jit(jax.grad(jax_loss), static_argnames=("impl", "bcfg"))


def port_grads(cloud_np, impl, tile):
    c = torch_cloud(cloud_np)
    leaves = {k: getattr(c, k).clone().requires_grad_(True) for k in PARAMS}
    args = tt.activate_cloud(c.replace(**leaves))
    cam = tt.stack_cameras([torch_camera(*np_lookat(EYE, W, H), W, H)])
    out = render(args, cam, bg=torch.from_numpy(BG), impl=impl,
                 config=BinningConfig(**cfg(tile)))
    loss = (
        (out.image - 0.4).abs().mean() + 0.1 * out.depth.mean()
        + 0.05 * out.final_transmittance.mean()
    )
    loss.backward()
    return {k: v.grad.numpy() for k, v in leaves.items()}


@pytest.fixture(scope="module", params=[0, 2])
def scene(request):
    return np_cloud(request.param, 48)


@pytest.fixture(scope="module")
def jax_grads(scene):
    cloud = jax_cloud(scene)
    cam = jax_camera(*np_lookat(EYE, W, H), W, H)
    params = {k: getattr(cloud, k) for k in PARAMS}
    out = {}
    for tile in (16, 32):
        for impl in ("pallas", "oracle"):
            g = jax_grad(params, cloud, cam, impl, JBinningConfig(**cfg(tile)))
            out[tile, impl] = {k: np.asarray(v) for k, v in g.items()}
    return out


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("ref_impl", ["pallas", "oracle"])
@pytest.mark.parametrize("impl", ["plain", "oracle"])
def test_render_gradients_match_jax(scene, jax_grads, tile, ref_impl, impl):
    got = port_grads(scene, impl, tile)
    for k in PARAMS:
        ref = jax_grads[tile, ref_impl][k]
        scale = np.abs(ref).max() + 1e-8
        assert np.abs(ref).max() > 0, k
        np.testing.assert_allclose(got[k] / scale, ref / scale, rtol=0, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("tile", [8, 24])
def test_plain_gradients_at_8_and_24_px_match_jax(tile):
    """The plain backward version at the tiles the CUDA backward body took
    last (8 and 24 px; 48 is no multiple of 24, so its last tile column is
    cut) against JAX's pallas gradients there, scaled, atol GRAD_ATOL."""
    cloud_np = np_cloud(0, 48)
    cloud = jax_cloud(cloud_np)
    cam = jax_camera(*np_lookat(EYE, W, H), W, H)
    ref = jax_grad({k: getattr(cloud, k) for k in PARAMS}, cloud, cam, "pallas",
                   JBinningConfig(**cfg(tile)))
    got = port_grads(cloud_np, "plain", tile)
    for k in PARAMS:
        r = np.asarray(ref[k])
        scale = np.abs(r).max() + 1e-8
        assert np.abs(r).max() > 0, k
        np.testing.assert_allclose(got[k] / scale, r / scale, rtol=0, atol=GRAD_ATOL, err_msg=k)


def test_bg_gradient_matches_jax(scene):
    def jloss(bg):
        out = jax_render(jt.activate_cloud(jax_cloud(scene)), jax_camera(*np_lookat(EYE, W, H), W, H),
                         bg=bg, impl="oracle")
        return jnp.mean(jnp.abs(out.image - 0.4))

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(BG)))
    bg = torch.from_numpy(BG.copy()).requires_grad_(True)
    cam = tt.stack_cameras([torch_camera(*np_lookat(EYE, W, H), W, H)])
    out = render(tt.activate_cloud(torch_cloud(scene)), cam, bg=bg, impl="plain",
                 config=BinningConfig(**cfg(16)))
    (out.image - 0.4).abs().mean().backward()
    # A float32 sum over the 1,536 pixels, in another order than JAX's.
    np.testing.assert_allclose(bg.grad.numpy(), ref, rtol=1e-5, atol=0)


def streams_both(cloud_np, tile, max_pairs):
    bc = dict(cfg(tile), max_pairs=max_pairs)
    w2c, K = np_lookat(EYE, W, H)
    js = jax.jit(jexact.build_exact_stream, static_argnums=2)(
        jt.activate_cloud(jax_cloud(cloud_np)), jax_camera(w2c, K, W, H), JBinningConfig(**bc))
    ts = build_exact_stream(tt.activate_cloud(torch_cloud(cloud_np)), torch_camera(w2c, K, W, H),
                            BinningConfig(**bc))
    return js, ts


@pytest.mark.parametrize("tile,max_pairs", [(16, 1 << 12), (32, 1 << 12), (16, 64)])
def test_pos_of_slot_identical(tile, max_pairs):
    # (16, 64) clips the budget: dropped slots must map to P in both.
    js, ts = streams_both(np_cloud(3, 64), tile, max_pairs)
    ref = np.asarray(jexact.pos_of_slot_of(js.offsets, js.gid, js.lane))
    got = pos_of_slot_of(ts.offsets[None], ts.gid[None], ts.lane[None])[0].numpy()
    assert bool(ts.overflowed) == (max_pairs == 64)
    np.testing.assert_array_equal(got, ref)
    assert (got < max_pairs).sum() == min(int(ts.total_pairs), max_pairs)


@pytest.mark.parametrize("tile,max_pairs,channels", [(16, 1 << 12, 3), (32, 64, 1)])
def test_routing_matches_jax(tile, max_pairs, channels):
    js, ts = streams_both(np_cloud(4, 64), tile, max_pairs)
    n_rows = 7 + channels
    rng = np.random.default_rng(tile)
    grads = rng.normal(size=(jexact.NREC, max_pairs)).astype(np.float32)
    pos = jexact.pos_of_slot_of(js.offsets, js.gid, js.lane)
    ref = np.asarray(jexact._route_to_table(
        jnp.asarray(grads), js.offsets, js.counts, pos, n_rows))[:n_rows].T
    rows = torch.from_numpy(np.ascontiguousarray(grads[:n_rows].T))[None]
    got = route_pairs_plain(rows, pos_of_slot_of(ts.offsets[None], ts.gid[None], ts.lane[None]),
                            ts.offsets[None], ts.counts[None])[0].numpy()
    assert got.shape == (64, n_rows)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def jax_padded_routing(rows, q_of_slot, offsets, counts, span):
    """pallas_composite.py:507-520 in numpy: (Pp, R) rows in padded order ->
    (N, R), each Gaussian's window of ``span`` slots from its offset,
    clipped into the slot map and masked by its count."""
    grads_slots = rows.T[:, q_of_slot]  # (NREC, max_pairs)
    slot_idx = offsets[:, None] + np.arange(span, dtype=np.int32)[None, :]  # (N, S)
    slot_idx = np.clip(slot_idx, 0, q_of_slot.shape[0] - 1)
    mask = np.arange(span, dtype=np.int32)[None, :] < counts[:, None]
    return np.stack([np.sum(np.where(mask, row[slot_idx], 0.0), axis=1) for row in grads_slots],
                    axis=1)


@pytest.mark.parametrize("seed,channels", [(0, 1), (1, 3), (2, 9)])
def test_padded_routing_matches_jax(seed, channels):
    # Two views of random rows, slot maps, offsets and counts (ranges that
    # overlap, and that reach past max_pairs, where JAX clips each slot to
    # the last one).
    rng = np.random.default_rng(seed)
    views, pp, max_pairs, n, span = 2, 300, 96, 40, 16
    r = 7 + channels
    rows = rng.normal(size=(views, pp, r)).astype(np.float32)
    q_of_slot = rng.integers(0, pp, size=(views, max_pairs)).astype(np.int32)
    counts = rng.integers(0, span + 1, size=(views, n)).astype(np.int32)
    offsets = rng.integers(0, max_pairs + 8, size=(views, n)).astype(np.int32)
    assert (offsets + counts > max_pairs).sum() >= 5 and (offsets >= max_pairs).any()
    got = route_pairs_plain(torch.from_numpy(rows), torch.from_numpy(q_of_slot),
                            torch.from_numpy(offsets), torch.from_numpy(counts),
                            padded=True).numpy()
    assert got.shape == (views, n, r)
    for v in range(views):
        ref = jax_padded_routing(rows[v], q_of_slot[v], offsets[v], counts[v], span)
        np.testing.assert_allclose(got[v], ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_routing_matches_pallas_cumsum():
    # The TPU kernel (interpret mode here) is an inclusive cumsum carried
    # across 2048-column blocks; its consumer takes each Gaussian's boundary
    # difference.  Its in-block scan splits f32 into bf16 parts (~2^-16
    # relative error of the running sum), which sets the tolerance.
    r, p = 10, 2 * 2048
    rng = np.random.default_rng(5)
    x = rng.normal(size=(r, p)).astype(np.float32)
    counts = rng.integers(0, 9, size=900).astype(np.int32)
    counts[-1] = max(0, p - int(counts[:-1].sum()))
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    csum = np.asarray(jexact._cumsum_pairs_pallas(jnp.asarray(x)))
    ends = offsets + counts
    b = np.where(ends > 0, csum[:, np.clip(ends - 1, 0, p - 1)], 0.0)
    ref = (b - np.concatenate([np.zeros((r, 1)), b[:, :-1]], axis=1)).T
    got = route_pairs_plain(
        torch.from_numpy(np.ascontiguousarray(x.T))[None],
        torch.arange(p, dtype=torch.int32)[None],
        torch.from_numpy(offsets)[None], torch.from_numpy(counts)[None],
    )[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0**-14 * np.abs(csum).max())


@pytest.mark.parametrize("grad_enabled", [True, False])
def test_cuda_backward_tile_refused_before_render(grad_enabled):
    """The CUDA backward body takes 8 px tiles like the forward, so a render
    through the CUDA kernels at 8 px is not refused before it bins, with
    gradients or without: it goes on to the forward kernel's wrapper, which
    refuses CPU tensors."""
    c = torch_cloud(np_cloud(0, 48))
    args = tt.activate_cloud(c.replace(means=c.means.clone().requires_grad_(True)))
    cam = tt.stack_cameras([torch_camera(*np_lookat(EYE, W, H), W, H)])
    with torch.set_grad_enabled(grad_enabled), pytest.raises(ValueError, match="CUDA tensors only"):
        render(args, cam, bg=torch.from_numpy(BG), impl="cuda", config=BinningConfig(**cfg(8)))
