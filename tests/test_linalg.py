"""SPD linear algebra of the refits: Cholesky inverse, its JVP rule, the
batched form and refined solves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gple_tpu.ops.linalg import psd_inverse, psd_inverse_batched, refine_solve


def gram_like(n, length=0.5, noise=1e-2, seed=0):
    """A GP kernel matrix as produced by the framework (pinned noise 1e-2)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return jnp.asarray(np.exp(-0.5 * d2 / length**2) + noise**2 * np.eye(n))


@pytest.mark.parametrize("n,length", [(64, 0.5), (256, 0.3), (256, 2.0), (512, 4.0)])
def test_psd_inverse_matches_numpy(n, length):
    """The production inverse is accurate across the conditioning range of
    framework kernels (up to ~1e7) and exactly symmetric."""
    k = gram_like(n, length)
    cond = float(np.linalg.cond(np.asarray(k)))
    x = np.asarray(psd_inverse(k))
    res = np.abs(np.asarray(k) @ x - np.eye(n)).max()
    assert res < max(cond * 1e-12, 2e-8), (cond, res)
    np.testing.assert_array_equal(x, x.T)
    ref = np.linalg.inv(np.asarray(k))
    assert np.abs(x - ref).max() <= max(cond * 1e-12, 1e-9) * np.abs(ref).max()


@pytest.mark.parametrize("b,n", [(1, 16), (4, 64), (4, 256)])
def test_psd_inverse_batched_shapes(b, n):
    """(B, N, N) in, (B, N, N) out, each slice the single-matrix inverse --
    the refit's (4, N, N) stack of SPD systems."""
    ks = jnp.stack([gram_like(n, 0.5 + 0.25 * i, seed=i) for i in range(b)])
    xs = psd_inverse_batched(ks)
    assert xs.shape == (b, n, n) and xs.dtype == ks.dtype
    for i in range(b):
        np.testing.assert_allclose(np.asarray(xs[i]), np.asarray(psd_inverse(ks[i])),
                                   rtol=1e-12, atol=1e-12 * float(jnp.abs(xs[i]).max()))


def test_refined_solve_accuracy():
    """alpha via the production inverse + refinement matches the direct solve."""
    k = gram_like(256, 2.0, seed=1)  # cond ~2e6
    rng = np.random.default_rng(2)
    y = jnp.asarray(rng.normal(size=256))
    a = np.asarray(refine_solve(psd_inverse(k), k, y, iters=3))
    a_direct = np.linalg.solve(np.asarray(k), np.asarray(y))
    denom = np.abs(a_direct).max()
    assert np.abs(a - a_direct).max() / denom < 1e-9


def test_custom_jvp_exact():
    """d(K^-1) = -K^-1 dK K^-1 through the custom rule."""
    k = gram_like(32, 0.7)
    dk = jnp.asarray(np.random.default_rng(3).normal(size=(32, 32)))
    dk = 0.5 * (dk + dk.T) * 1e-3
    _, jvp = jax.jvp(psd_inverse, (k,), (dk,))
    kinv = np.asarray(psd_inverse(k))
    expect = -kinv @ np.asarray(dk) @ kinv
    np.testing.assert_allclose(np.asarray(jvp), expect, atol=1e-10)


def test_batched_jvp_exact():
    """The batched inverse differentiates slice by slice with the same rule."""
    ks = jnp.stack([gram_like(24, 0.6, seed=4), gram_like(24, 0.9, seed=5)])
    rng = np.random.default_rng(6)
    dks = rng.normal(size=(2, 24, 24)) * 1e-3
    dks = jnp.asarray(0.5 * (dks + np.swapaxes(dks, -1, -2)))
    _, jvp = jax.jvp(psd_inverse_batched, (ks,), (dks,))
    for i in range(2):
        kinv = np.asarray(psd_inverse(ks[i]))
        np.testing.assert_allclose(np.asarray(jvp[i]),
                                   -kinv @ np.asarray(dks[i]) @ kinv, atol=1e-10)


def test_grad_through_inverse_matches_finite_difference():
    """The optimizer's losses differentiate through the inverse: a scalar
    quadratic form y^T K(l)^-1 y against central differences in l."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(20, 2))
    y = jnp.asarray(rng.normal(size=20))

    def loss(length):
        d2 = jnp.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)
        k = jnp.exp(-0.5 * d2 / length**2) + 1e-2 * jnp.eye(20)
        return y @ psd_inverse(k) @ y

    g = float(jax.grad(loss)(0.8))
    h = 1e-5
    fd = (float(loss(0.8 + h)) - float(loss(0.8 - h))) / (2 * h)
    assert abs(g - fd) <= 1e-6 * max(1.0, abs(fd)), (g, fd)
