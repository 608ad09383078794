"""The port's random draws (``splatpu_torch/core/prng.py``) against
``jax.random``, on the CPU, from the same keys: seeds 0, 7, 2^31 and
2^32 + 5.

- ``key`` and ``PRNGKey`` equal ``jax.random.key_data(jax.random.key(s))``
  (with 64-bit types off, JAX keeps only the seed's low 32 bits);
- ``split`` into 2, 6 and 8 keys, and ``random_bits``, bit for bit;
- ``uniform`` bit for bit at (n,), (n, 3) and (64, 128), with bounds +-1,
  +-1/sqrt(fan_in) (fan_in 192, 128 and 64) and (0.004, 0.02);
- ``normal`` at (500224, 3), stage 1's config-4 capacity, within 2 ulp
  (bit for bit on every entry on an x86 CPU with FMA, where the port's
  copy of XLA's fused operations is exact);
- ``erf_inv`` on every 128th of the 2^23 values that ``normal``'s uniform
  can take, within 2 ulp of ``jax.lax.erf_inv``;
- the TPU's own stage-1 checkpoints (``runs/config4_s1``,
  ``runs/acceptance_s1``) hold the key that ``key(0)`` split once per
  logged mutation gives: the TPU drew with the same (partitionable)
  threefry;
- ``make_random_cloud(key(0), ...)`` is the committed acceptance truth
  (120,000 and 250,000 Gaussians): the uniform fields bit for bit, the
  quaternions and log scales within 1e-6; and ``bench.py``'s cloud at
  100,000 is JAX's draw in the same way.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatpu.data.synthetic import make_random_cloud as jax_random_cloud
from splatpu_torch.core import prng
from splatpu_torch.data.synthetic import make_random_cloud
from splatpu_torch.io.checkpoint import msgpack_restore

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SEEDS = [0, 7, 2**31, 2**32 + 5]
UNIFORM_FIELDS = ("means", "colors", "segmentation_masks", "opacity_logits")
ROUNDED_FIELDS = ("rotation_quaternions", "log_scales")


def ulps(a, b) -> np.ndarray:
    """|a - b| in float32 units in the last place (ordered bit patterns)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    for got in (prng.key(seed), prng.PRNGKey(seed)):
        assert got.dtype == np.uint32 and got.shape == (2,)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(prng.key(seed), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed):
    for num in (2, 6, 8):
        want = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(seed), num)))
        got = prng.split(prng.key(seed), num)
        assert got.dtype == np.uint32 and got.shape == (num, 2)
        np.testing.assert_array_equal(got, want)
    # A subkey splits again as JAX's does (stage 1's key, sub = split(key)).
    sub = jax.random.split(jax.random.key(seed))[1]
    np.testing.assert_array_equal(prng.split(prng.split(prng.key(seed))[1]),
                                  np.asarray(jax.random.key_data(jax.random.split(sub))))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax(seed):
    for shape in ((1000,), (333, 3), (64, 128)):
        want = np.asarray(jax.random.bits(jax.random.key(seed), shape))
        got = prng.random_bits(prng.key(seed), shape, "cpu")
        assert got.shape == shape
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def inv_sqrt(fan_in):
    return float(1.0 / jnp.sqrt(fan_in))


@pytest.mark.parametrize("shape", [(1000,), (1000, 3), (64, 128)], ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, shape):
    bounds = [(-1.0, 1.0), (0.004, 0.02), (0.0, 1.0)] + [
        (-inv_sqrt(f), inv_sqrt(f)) for f in (192, 128, 64)]
    for lo, hi in bounds:
        want = np.asarray(jax.random.uniform(jax.random.key(seed), shape, minval=lo, maxval=hi))
        got = prng.uniform(prng.key(seed), shape, lo, hi, "cpu")
        assert got.dtype == torch.float32 and got.shape == shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"[{lo}, {hi})")


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax(seed):
    shape = (500_224, 3)
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = prng.normal(prng.key(seed), shape, "cpu")
    assert got.dtype == torch.float32 and got.shape == shape
    d = ulps(got.numpy(), want)
    print(f"normal(key({seed}), {shape}): largest {d.max()} ulp from JAX's, bitwise share"
          f" {(d == 0).mean():.6f}")
    assert d.max() <= 2


def test_erf_inv_matches_xla():
    """Every 128th value of the lattice ``normal`` draws ``u`` from:
    floats k / 2^23 scaled onto [nextafter(-1, 0), 1) with one rounding."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    k = np.arange(0, 1 << 23, 128, dtype=np.uint32)
    floats = (k | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    span = np.float32(np.float32(1.0) - lo)
    u = np.maximum((floats.astype(np.float64) * span + lo).astype(np.float32), lo)
    assert len(u) == 1 << 16
    want = np.asarray(jax.jit(jax.lax.erf_inv)(u))
    d = ulps(prng.erf_inv(torch.from_numpy(u)).numpy(), want)
    print(f"erf_inv on {len(u)} values: largest {d.max()} ulp from XLA's, bitwise share"
          f" {(d == 0).mean():.6f}")
    assert d.max() <= 2


def assert_cloud_is(got, want):
    for k in UNIFORM_FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ROUNDED_FIELDS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def fields(cloud) -> dict:
    """A cloud's fields as numpy, from either package (CPU tensors)."""
    return {k: np.asarray(getattr(cloud, k)) for k in UNIFORM_FIELDS + ROUNDED_FIELDS}


@pytest.mark.parametrize("n", [120_000, 250_000])
def test_random_cloud_is_the_acceptance_truth(n):
    """``scripts/acceptance_full.py``'s truth, as committed in
    ``runs/acceptance_truth/truth_n<n>.npz`` (written from the threefry
    draw by ``scripts/export_acceptance_truth.py``)."""
    committed = np.load(ROOT / "runs" / "acceptance_truth" / f"truth_n{n}.npz")
    cloud = make_random_cloud(prng.key(0), n, extent=1.0, scale_range=(0.004, 0.02),
                              device="cpu")
    assert cloud.capacity == n and bool(cloud.alive.all())
    assert_cloud_is(fields(cloud), {k: committed[k] for k in committed.files})


def test_bench_cloud_matches_jax():
    """``bench.py``'s cloud at 100,000 Gaussians, and a capacity and a
    centre besides."""
    want = jax_random_cloud(jax.random.key(0), 100_000, extent=1.2, scale_range=(0.005, 0.02))
    got = make_random_cloud(prng.key(0), 100_000, extent=1.2, scale_range=(0.005, 0.02),
                            device="cpu")
    assert_cloud_is(fields(got), fields(want))
    want = jax_random_cloud(jax.random.key(3), 500, capacity=768, center=(0.5, -1.0, 2.0),
                            fg_fraction=0.4)
    got = make_random_cloud(prng.key(3), 500, capacity=768, center=(0.5, -1.0, 2.0),
                            fg_fraction=0.4, device="cpu")
    assert got.capacity == 768 and int(got.n_alive()) == 500
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    assert_cloud_is(fields(got), fields(want))


@pytest.mark.parametrize("run", ["config4_s1", "acceptance_s1"])
def test_tpu_checkpoint_key_is_the_ports(run):
    """The key the TPU's fit carried to its last checkpoint is the one the
    port's ``fit`` carries: ``key(seed 0)``, then ``key, sub = split(key)``
    at each of the mutations the TPU's log shows up to that iteration."""
    raw = msgpack_restore((ROOT / "runs" / run / "stage1_ckpt.msgpack").read_bytes())
    with open(ROOT / "runs" / run / "stage1_metrics.jsonl") as f:
        mutations = {r["step"] for r in map(json.loads, f)
                     if "cloned" in r and r["step"] <= int(raw["i"])}
    assert len(mutations) == 46
    k = prng.key(0)
    for _ in mutations:
        k, _ = prng.split(k)
    np.testing.assert_array_equal(np.asarray(raw["key"], np.uint32), k)
