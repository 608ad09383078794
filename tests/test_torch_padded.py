"""The padded pair stream, impl="stream" and impl="plain_padded" (K5's plain
versions through CompositeG): the port against the JAX package on the same
numpy inputs.

- ``build_pair_stream``: tile, gid, start, end, emit_offsets, emit_counts,
  q_of_slot, total_pairs and both overflow flags identical, on a scene with
  duplicated Gaussians and equal depths (sort ties), on a pair-budget
  overflow and on a span overflow;
- the forward of "stream" against JAX "stream" and of "plain_padded"
  against JAX "pallas_padded" (K5 in interpret mode) at the tolerances of
  tests/test_render_exact.py (image 2e-5, depth 2e-4, final T 2e-5), and
  the last contributor identical to the TPU kernel's (its int32 output);
- gradients to every per-Gaussian input within 1e-4 of the JAX ones,
  scaled by the reference's largest value;
- an overflowed render: gradients of the Gaussians whose slots all lie
  within the budget match; the port routes nothing for slots past the
  budget, where JAX adds the last kept slot's row again (the divergence
  recorded in ROADMAP.md section C).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatpu.core.types as jt
import splatpu.render.pallas_composite as jpc
from splatpu.render.api import render as jax_render
from splatpu.render.binning import BinningConfig as JBinningConfig
from splatpu.render.binning import build_pair_stream as jax_build_pair_stream
import splatpu_torch.core.types as tt
from splatpu_torch.render.api import render
from splatpu_torch.render.binning import BinningConfig, build_pair_stream
from _torch_scenes import jax_camera, jax_cloud, np_cloud, np_lookat, np_of, torch_camera, torch_cloud

torch.set_num_threads(1)

W, H = 48, 32
EYE = (0.3, -0.2, -4.0)
BG = np.array([0.1, 0.2, 0.3], np.float32)
CFG = dict(tile=16, max_span=64, max_pairs=1 << 12, chunk_pairs=128)
PARAMS = ("means", "colors", "rotation_quaternions", "opacity_logits", "log_scales")
TOL = {"image": 2e-5, "depth": 2e-4, "final_transmittance": 2e-5}
GRAD_ATOL = 1e-4
FIELDS = ("tile", "gid", "start", "end", "emit_offsets", "emit_counts", "q_of_slot",
          "total_pairs", "overflowed", "span_overflowed")

jax_stream_jit = jax.jit(jax_build_pair_stream, static_argnums=2)
jax_render_jit = jax.jit(jax_render, static_argnames=("impl", "config"))


def tie_cloud():
    """64 Gaussians: rows 32..63 copy rows 0..31 exactly, and every third row
    shares one z, so keys tie within tiles both ways."""
    c = np_cloud(21, 64, scale_range=(0.03, 0.12))
    for k in c:
        c[k][32:] = c[k][:32]
    c["means"][::3, 2] = 0.25
    return c


@pytest.mark.parametrize("case,cloud,overrides", [
    ("ties", tie_cloud, {}),
    ("budget_overflow", lambda: np_cloud(22, 64), {"max_pairs": 64}),
    ("span_overflow", lambda: np_cloud(23, 64, scale_range=(0.1, 0.3)), {"max_span": 4}),
])
def test_pair_stream_identical(case, cloud, overrides):
    cloud = cloud()
    cfg = dict(CFG, **overrides)
    w2c, K = np_lookat((0.0, 0.0, -4.0), W, H)
    ref = jax_stream_jit(jt.activate_cloud(jax_cloud(cloud)), jax_camera(w2c, K, W, H),
                         JBinningConfig(**cfg))
    got = build_pair_stream(tt.activate_cloud(torch_cloud(cloud)), torch_camera(w2c, K, W, H),
                            BinningConfig(**cfg))
    for f in FIELDS:
        a, b = np_of(getattr(got, f)), np_of(getattr(ref, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.gid.shape[0] == BinningConfig(**cfg).padded_capacity(6)
    if case == "ties":
        # Every key is tied with a twin: the emission slot order decides.
        assert int(got.total_pairs) > 0 and not bool(got.overflowed)
    else:
        assert bool(got.overflowed)
        assert bool(got.span_overflowed) == (case == "span_overflow")


def jax_loss(params, cloud, cam, impl, bcfg):
    out = jax_render(jt.activate_cloud(cloud.replace(**params)), cam, bg=jnp.asarray(BG),
                     impl=impl, config=bcfg)
    return (jnp.mean(jnp.abs(out.image - 0.4)) + 0.1 * jnp.mean(out.depth)
            + 0.05 * jnp.mean(out.final_transmittance))


jax_grad = jax.jit(jax.grad(jax_loss), static_argnames=("impl", "bcfg"))


def jax_last(cloud, cam, bcfg):
    """The TPU kernel's int32 last contributor (interpret mode), (H, W)."""
    args = jt.activate_cloud(cloud)
    s = jax_stream_jit(args, cam, bcfg)
    sp = s.splats
    g = s.gid
    records = jpc._pack_records(sp.mean2d[g], sp.conic[g], args.colors[g], s.g_opacity[g],
                                sp.depth[g])
    tx, ty = -(-W // 16), -(-H // 16)
    fwd = jax.jit(functools.partial(jpc._composite_fwd_call, num_tiles=tx * ty, tiles_x=tx,
                                    G=bcfg.chunk_pairs, C=3))
    last = np_of(fwd(records, s.start, s.end, jnp.asarray(BG)[:, None])[3])
    last = last.reshape(ty, tx, 16, 16).transpose(0, 2, 1, 3).reshape(ty * 16, tx * 16)
    return last[:H, :W]


@pytest.fixture(scope="module")
def jax_refs():
    """JAX outputs and gradients on one scene, each jitted once."""
    cloud_np = np_cloud(24, 64)
    cloud = jax_cloud(cloud_np)
    cam = jax_camera(*np_lookat(EYE, W, H), W, H)
    bcfg = JBinningConfig(**CFG)
    args = jt.activate_cloud(cloud)
    params = {k: getattr(cloud, k) for k in PARAMS}
    out = {"cloud": cloud_np, "last": jax_last(cloud, cam, bcfg)}
    for impl in ("stream", "pallas_padded"):
        o = jax_render_jit(args, cam, bg=jnp.asarray(BG), impl=impl, config=bcfg)
        out[impl] = {k: np_of(getattr(o, k)) for k in TOL}
        out[impl, "grad"] = {k: np_of(v) for k, v in
                             jax_grad(params, cloud, cam, impl, bcfg).items()}
    return out


def port_render(cloud_np, impl, cfg, leaves=None):
    c = torch_cloud(cloud_np)
    if leaves is not None:
        c = c.replace(**leaves)
    cam = tt.stack_cameras([torch_camera(*np_lookat(EYE, W, H), W, H)])
    return render(tt.activate_cloud(c), cam, bg=torch.from_numpy(BG), impl=impl,
                  config=BinningConfig(**cfg))


def port_grads(cloud_np, impl, cfg):
    c = torch_cloud(cloud_np)
    leaves = {k: getattr(c, k).clone().requires_grad_(True) for k in PARAMS}
    out = port_render(cloud_np, impl, cfg, leaves)
    loss = ((out.image - 0.4).abs().mean() + 0.1 * out.depth.mean()
            + 0.05 * out.final_transmittance.mean())
    loss.backward()
    return {k: v.grad.numpy() for k, v in leaves.items()}


@pytest.mark.parametrize("impl,ref_impl", [("stream", "stream"), ("plain_padded", "pallas_padded")])
def test_forward_matches_jax(jax_refs, impl, ref_impl):
    out = port_render(jax_refs["cloud"], impl, CFG)
    for k, tol in TOL.items():
        np.testing.assert_allclose(np_of(getattr(out, k))[0], jax_refs[ref_impl][k], rtol=0,
                                   atol=tol, err_msg=k)
    # Both return the last contributing padded position, as K5 does.
    np.testing.assert_array_equal(np_of(out.last_contributor)[0], jax_refs["last"])
    assert (jax_refs["last"] >= 0).any() and not bool(out.overflowed.any())


@pytest.mark.parametrize("impl,ref_impl", [("stream", "stream"), ("plain_padded", "pallas_padded")])
def test_gradients_match_jax(jax_refs, impl, ref_impl):
    got = port_grads(jax_refs["cloud"], impl, CFG)
    for k in PARAMS:
        ref = jax_refs[ref_impl, "grad"][k]
        scale = np.abs(ref).max()
        assert scale > 0, k
        np.testing.assert_allclose(got[k] / scale, ref / scale, rtol=0, atol=GRAD_ATOL, err_msg=k)


def test_overflow_routing_divergence():
    cloud_np = np_cloud(25, 64)
    cfg = dict(CFG, max_pairs=64)
    cloud = jax_cloud(cloud_np)
    cam = jax_camera(*np_lookat(EYE, W, H), W, H)
    ref = jax_grad({k: getattr(cloud, k) for k in PARAMS}, cloud, cam, "pallas_padded",
                   JBinningConfig(**cfg))
    got = port_grads(cloud_np, "plain_padded", cfg)
    s = build_pair_stream(tt.activate_cloud(torch_cloud(cloud_np)),
                          torch_camera(*np_lookat(EYE, W, H), W, H), BinningConfig(**cfg))
    assert bool(s.overflowed) and not bool(s.span_overflowed)
    ends = (s.emit_offsets + s.emit_counts).numpy()
    inside = ends <= cfg["max_pairs"]                     # every slot kept
    dropped = s.emit_offsets.numpy() >= cfg["max_pairs"]  # every slot dropped
    assert inside.sum() > 0 and (dropped & (s.emit_counts.numpy() > 0)).sum() > 0
    for k in PARAMS:
        r = np_of(ref[k])
        scale = np.abs(r[inside]).max()
        np.testing.assert_allclose(got[k][inside] / scale, r[inside] / scale, rtol=0,
                                   atol=GRAD_ATOL, err_msg=k)
        # The port: a Gaussian none of whose pairs was kept gets no gradient.
        assert not got[k][dropped].any(), k


def test_cuda_padded_raises_on_cpu_tensors():
    # No fallback: the CUDA impl never runs the plain versions.
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_render(np_cloud(26, 16), "cuda_padded", CFG)
    with pytest.raises(ValueError, match="fixed at 16x16 tiles"):
        port_render(np_cloud(26, 16), "plain_padded", dict(CFG, tile=32))
