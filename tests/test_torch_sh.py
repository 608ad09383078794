"""The port's SH colour evaluation (``splatpu_torch/core/sh.py``) against
the JAX package's (``splatpu/core/sh.py``) at degrees 0-3, on directions,
means and coefficients drawn with numpy from a seed: 1e-6 absolute."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatpu.core.sh as jsh
import splatpu_torch.core.sh as tsh

TOL = 1e-6


def _dirs(n, seed):
    d = np.random.default_rng(seed).standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_basis_matches_jax(degree):
    dirs = _dirs(257, degree)
    got = tsh.sh_basis(torch.from_numpy(dirs), degree).numpy()
    ref = np.asarray(jsh.sh_basis(jnp.asarray(dirs), degree))
    assert got.shape == ref.shape == (257, tsh.num_sh_coeffs(degree))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_colors_matches_jax(degree):
    rng = np.random.default_rng(10 + degree)
    k = tsh.num_sh_coeffs(degree)
    coeffs = rng.standard_normal((199, k, 3)).astype(np.float32)
    means = (3.0 * rng.standard_normal((199, 3))).astype(np.float32)
    center = rng.standard_normal(3).astype(np.float32)
    got = tsh.eval_sh_colors(torch.from_numpy(coeffs), torch.from_numpy(means),
                             torch.from_numpy(center)).numpy()
    ref = np.asarray(jsh.eval_sh_colors(jnp.asarray(coeffs), jnp.asarray(means),
                                        jnp.asarray(center)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert (got >= 0).all()


def test_degree_errors_match_jax():
    with pytest.raises(ValueError):
        tsh.sh_basis(torch.zeros((2, 3)), 4)
    with pytest.raises(ValueError):
        tsh.eval_sh_colors(torch.zeros((2, 5, 3)), torch.zeros((2, 3)), torch.zeros(3), degree=1)
    assert [tsh.num_sh_coeffs(d) for d in range(4)] == [jsh.num_sh_coeffs(d) for d in range(4)]
