"""Stage-2 options and helpers of the port against the JAX package.

- ``adopt_checkpointed_budget``: the cases of tests/test_budget_policy.py
  (TestResumeAdoption), each against the JAX function's result;
- the bfloat16 ``compute_dtype``: the network's outputs against the JAX
  network's under bfloat16, within 2e-2 of the outputs' largest magnitude
  (bfloat16 keeps 8 bits of mantissa, ~4e-3 relative per rounding, and the
  outputs pass through ~10 roundings); "auto" means float32 off a TPU;
- a mesh that is not the process group's size refused; ``mesh_tiles``
  without ``mesh_cameras`` builds no mesh;
- ``psnr`` against the JAX package's; ``MetricsLogger`` fetches its
  buffered tensors in one batched copy (no ``.item()``) and writes the JAX
  logger's rows;
- the profiling helpers on the CPU: ``time_fn``'s batches on the host
  clock, ``force_completion``;
- the native KD-tree (tests/test_native_knn.py's cases: self and external
  queries against a numpy brute force, the small-cloud padding) and
  ``knn``'s routing above the threshold, indices identical to a float64
  brute force and squared distances within 1e-5 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatpu.obs.metrics as jmetrics
from splatpu.dynamics.network import DeformationNetConfig as JNetConfig
from splatpu.dynamics.network import deformation_net_apply
from splatpu.dynamics.network import init_deformation_net as jinit
from splatpu.obs.quality import psnr as jpsnr
from splatpu.render.binning import BinningConfig as JBinningConfig
from splatpu.render.binning import adopt_checkpointed_budget as j_adopt
import splatpu_torch.neighbors.knn as tknn
import splatpu_torch.train.stage2 as ts2
from splatpu_torch.dynamics.network import DeformationNet, DeformationNetConfig, state_dict_from_jax
from splatpu_torch.neighbors import native
from splatpu_torch.obs import profiling
from splatpu_torch.obs.metrics import MetricsLogger
from splatpu_torch.obs.quality import psnr
from splatpu_torch.render.binning import BinningConfig, adopt_checkpointed_budget

torch.set_num_threads(1)


@pytest.mark.parametrize("ckpt_pairs,ckpt_span", [
    (1 << 18, 64),    # pair growth adopted
    (1 << 16, 256),   # span-only growth adopted, big_capacity from the ratio
    (1 << 16, 64),    # no growth, no change
    (1 << 12, 16),    # a smaller checkpointed budget ignored
])
def test_adopt_checkpointed_budget_matches_jax(ckpt_pairs, ckpt_span):
    b = BinningConfig(max_pairs=1 << 16, max_span=64)
    got, changed = adopt_checkpointed_budget(b, ckpt_pairs, ckpt_span, n=10_000)
    want, j_changed = j_adopt(JBinningConfig(max_pairs=1 << 16, max_span=64), ckpt_pairs,
                              ckpt_span, n=10_000)
    assert changed == j_changed
    assert (got.max_pairs, got.max_span, got.big_capacity) == (
        want.max_pairs, want.max_span, want.big_capacity)
    if not changed:
        assert got is b


def test_bfloat16_network_matches_jax():
    rng = np.random.default_rng(0)
    n = 512
    jcfg = JNetConfig(hidden_dim=32, residual_blocks=2, compute_dtype="bfloat16")
    params = jax.tree.map(np.asarray, jinit(jax.random.key(2), jcfg))
    inputs = [rng.normal(size=(n, 7)).astype(np.float32),
              rng.uniform(-1, 1, (n, 92)).astype(np.float32),
              rng.uniform(-1, 1, (n, 92)).astype(np.float32),
              rng.uniform(-1, 1, (n, 8)).astype(np.float32)]
    want = np.asarray(deformation_net_apply(params, *map(jnp.asarray, inputs), jcfg))
    net = DeformationNet(DeformationNetConfig(hidden_dim=32, residual_blocks=2,
                                              compute_dtype="bfloat16"))
    net.load_state_dict(state_dict_from_jax(params))
    got = net(*map(torch.from_numpy, inputs))
    assert got.dtype == torch.float32
    got = got.detach().numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)
    # bfloat16, not float32: the float32 network differs by more than the
    # float32 rounding.
    f32 = DeformationNet(DeformationNetConfig(hidden_dim=32, residual_blocks=2))
    f32.load_state_dict(state_dict_from_jax(params))
    assert np.abs(f32(*map(torch.from_numpy, inputs)).detach().numpy() - got).max() > 1e-4 * scale
    # Gradients reach the float32 parameters through the casts.
    net(*map(torch.from_numpy, inputs)).sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in net.parameters())


def test_compute_dtype_auto_is_float32_and_mesh_refused():
    assert ts2.Stage2Config().net_config().compute_dtype == "float32"
    assert ts2.Stage2Config(compute_dtype="bfloat16").net_config().compute_dtype == "bfloat16"
    # A mesh that is not the process group's size is refused (here: no
    # group, one rank). A tile axis without a camera axis builds no mesh,
    # as in JAX: the call goes on to the cloud (here None).
    with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
        ts2.train(None, [[None]], ts2.Stage2Config(mesh_cameras=2), device="cpu")
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'to'"):
        ts2.train(None, [[None]], ts2.Stage2Config(mesh_tiles=2), device="cpu")


def test_psnr_matches_jax():
    rng = np.random.default_rng(1)
    a, b = rng.uniform(size=(2, 3, 8, 9)).astype(np.float32)
    assert float(psnr(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(
        float(jpsnr(jnp.asarray(a), jnp.asarray(b))), rel=1e-6)


def test_profiling_helpers_on_cpu():
    calls = []
    stats = profiling.time_fn(lambda x: calls.append(x), 3, warmup=2, iters=5, batches=2,
                              device="cpu")
    assert calls == [3] * 8
    assert stats["iters"] == 5 and stats["timer"] == "host_clock"
    assert stats["mean_ms"] >= 0 and stats["spread_ms"] >= 0
    profiling.force_completion("cpu")


def test_metrics_logger_one_batched_fetch(tmp_path, monkeypatch):
    calls = {"item": 0}
    real_item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: calls.__setitem__("item", calls["item"] + 1) or real_item(self))
    rows = [({"loss": 0.25, "n": 3, "flag": True, "name": "x"}, 1),
            ({"loss": 0.125, "n": 4, "flag": False, "name": "y"}, 2)]
    port = MetricsLogger(tmp_path / "port.jsonl", flush_every=10)
    ref = jmetrics.MetricsLogger(tmp_path / "jax.jsonl", flush_every=10)
    for m, step in rows:
        port.log({k: torch.tensor(v) if isinstance(v, float) else v for k, v in m.items()}, step)
        ref.log({k: jnp.float32(v) if isinstance(v, float) else v for k, v in m.items()}, step)
    port.close()
    ref.close()
    assert calls["item"] == 0
    strip = lambda line: {k: v for k, v in json.loads(line).items() if k != "ts"}  # noqa: E731
    got = [strip(x) for x in (tmp_path / "port.jsonl").read_text().splitlines()]
    want = [strip(x) for x in (tmp_path / "jax.jsonl").read_text().splitlines()]
    assert got == want and [r["step"] for r in got] == [1, 2]


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("the native kNN library did not build (no g++)")


def brute(points, queries=None):
    q = points if queries is None else queries
    diff = q[:, None].astype(np.float64) - points[None]
    full = np.einsum("ijk,ijk->ij", diff, diff)
    if queries is None:
        np.fill_diagonal(full, np.inf)
    return full


def test_native_self_knn_matches_bruteforce(lib):
    pts = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
    idx, d2 = native.knn_native(pts, k=7)
    full = brute(pts)
    ref_idx = np.argsort(full, axis=1)[:, :7]
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(d2, np.take_along_axis(full, ref_idx, axis=1), rtol=1e-5,
                               atol=1e-6)


def test_native_query_knn(lib):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    q = rng.normal(size=(40, 3)).astype(np.float32)
    idx, d2 = native.knn_query_native(pts, q, k=4)
    full = brute(pts, q)
    ref_idx = np.argsort(full, axis=1)[:, :4]
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(d2, np.take_along_axis(full, ref_idx, axis=1), rtol=1e-5,
                               atol=1e-6)


def test_native_small_cloud_padding(lib):
    pts = np.zeros((3, 3), np.float32)
    pts[1], pts[2] = [1, 0, 0], [2, 0, 0]
    idx, d2 = native.knn_native(pts, k=5)
    assert idx.shape == (3, 5)
    assert (idx[:, 2:] == -1).all() and np.isinf(d2[:, 2:]).all()
    assert d2[0, 0] == pytest.approx(1.0)


def test_knn_routes_above_threshold_to_native(lib, monkeypatch):
    """Above NATIVE_THRESHOLD (lowered here to 1,000 so the CPU brute force
    stays quick) ``knn`` answers through the KD-tree: the brute force's
    indices, squared distances within 1e-5 relative; with k > N - 1 the
    padding of the JAX package (index 0, distance inf)."""
    monkeypatch.setattr(tknn, "NATIVE_THRESHOLD", 1000)
    calls = []
    real = native.knn_native
    monkeypatch.setattr(native, "knn_native", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    pts_np = np.random.default_rng(2).uniform(-1, 1, (3000, 3)).astype(np.float32)
    idx, d2 = tknn.knn(torch.from_numpy(pts_np), 20)
    assert calls and idx.dtype == torch.int32
    # The exact answer: float64 differences (the float32 brute force's
    # |a|^2 + |b|^2 - 2ab form may order near ties otherwise).
    full = brute(pts_np)
    ref_idx = np.argsort(full, axis=1, kind="stable")[:, :20]
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_allclose(d2.numpy(), np.take_along_axis(full, ref_idx, axis=1), rtol=1e-5)
    small = torch.from_numpy(np.random.default_rng(3).normal(size=(1001, 3)).astype(np.float32))
    idx, d2 = tknn.knn(small, 1005)
    assert idx.shape == (1001, 1005) and (idx[:, 1000:] == 0).all()
    assert torch.isinf(d2[:, 1000:]).all() and torch.isfinite(d2[:, :1000]).all()
