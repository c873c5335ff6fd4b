"""Full lower-triangular ARD characteristic matrix (reference validation GPR,
test/gpr.cpp:309-328,368-396).

The matrix kernel k = sigma_f^2 exp(-1/2 |W (a - b)|^2) with lower-triangular
W must (a) reduce exactly to the axis-aligned kernel when W = diag(1/l),
(b) keep the analytic population/purity integrals consistent with numerical
quadrature of the GP's own prediction, and (c) beat the axis-aligned
hypothesis class on a tilted (x-p correlated) distribution -- the situation
the reference built it for (post-crossing sheared Wigner functions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gple_tpu.ops import kernels as K
from gple_tpu import validation


def tilted_gaussian(coords, theta=0.6, sx=0.8, sp=1.6):
    """A rotated anisotropic Gaussian: correlated in x and p."""
    c, s = np.cos(theta), np.sin(theta)
    u = c * coords[:, 0] + s * coords[:, 1]
    v = -s * coords[:, 0] + c * coords[:, 1]
    return 0.3 * np.exp(-0.5 * ((u / sx) ** 2 + (v / sp) ** 2))


def test_matrix_gram_reduces_to_vector():
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(20, 2)))
    lengths = jnp.asarray([0.7, 1.3])
    w = jnp.diag(1.0 / lengths)
    np.testing.assert_allclose(
        np.asarray(K.gram(w, x, x)), np.asarray(K.gram(lengths, x, x)), rtol=1e-12
    )


def test_matrix_gram_cross_term_naive():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(12, 2))
    w = np.array([[1.4, 0.0], [0.5, 0.9]])
    g = np.asarray(K.gram(jnp.asarray(w), jnp.asarray(x), jnp.asarray(x)))
    for i in range(12):
        for j in range(12):
            d = w @ (x[i] - x[j])
            assert g[i, j] == pytest.approx(np.exp(-0.5 * np.dot(d, d)), rel=1e-12)


def _matrix_state(seed=0, w10=0.45):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(64, 2)) * np.array([1.0, 1.5]))
    y = jnp.asarray(tilted_gaussian(np.asarray(x)))
    w = jnp.asarray([[1.0 / 0.9, 0.0], [w10, 1.0 / 1.4]])
    params = K.KernelParams(
        magnitude=jnp.asarray(0.5), lengths=w, noise=jnp.asarray(1e-2)
    )
    return K.fit_real(params, x, y)


def _quadrature(state, fn):
    """Integrate fn(mean(r)) over a wide grid around the training points."""
    g = np.linspace(-12.0, 12.0, 241)
    da = (g[1] - g[0]) ** 2
    gx, gp = np.meshgrid(g, g, indexing="ij")
    coords = jnp.asarray(np.stack([gx.ravel(), gp.ravel()], axis=-1))
    mean, _, _ = K.predict_real(state, coords, with_variance=False)
    return float(np.sum(fn(np.asarray(mean), np.stack([gx.ravel(), gp.ravel()], -1))) * da)


def test_matrix_population_matches_quadrature():
    st = _matrix_state()
    pop = float(K.population(st))
    quad = _quadrature(st, lambda m, r: m)
    assert pop == pytest.approx(quad, rel=1e-6)


def test_matrix_r_average_matches_quadrature():
    st = _matrix_state()
    ravg = np.asarray(K.r_average(st))
    qx = _quadrature(st, lambda m, r: m * r[:, 0])
    qp = _quadrature(st, lambda m, r: m * r[:, 1])
    np.testing.assert_allclose(ravg, [qx, qp], rtol=1e-5, atol=1e-10)


def test_matrix_purity_matches_quadrature():
    from gple_tpu.utils.constants import purity_factor

    st = _matrix_state()
    pur = float(K.purity(st))
    quad = _quadrature(st, lambda m, r: m**2) * purity_factor(1)
    assert pur == pytest.approx(quad, rel=1e-6)


@pytest.mark.parametrize("w10", [0.0, 0.45])
def test_potential_energy_matches_quadrature(w10):
    st = _matrix_state(w10=w10)
    e_prm = float(validation.potential_energy_prm(st, "SAC", 0))
    from gple_tpu.models import tully

    def weight(m, r):
        v = np.asarray(tully.adiabatic_potential("SAC", jnp.asarray(r[:, 0])))[:, 0]
        return m * v

    quad = _quadrature(st, weight)
    assert e_prm == pytest.approx(quad, rel=1e-5, abs=1e-12)


@pytest.mark.parametrize("w10", [0.0, 0.45])
def test_kinetic_energy_matches_quadrature(w10):
    st = _matrix_state(w10=w10)
    mass = 2000.0
    e_prm = float(validation.kinetic_energy_prm(st, mass))
    quad = _quadrature(st, lambda m, r: m * r[:, 1] ** 2 / (2.0 * mass))
    assert e_prm == pytest.approx(quad, rel=1e-5)


def test_full_ard_beats_axis_aligned_on_tilted_snapshot():
    """The measured comparison a round review asked for: cross terms must cut the
    snapshot-fit MSE on a tilted distribution."""
    g = np.linspace(-6.0, 6.0, 61)
    da = (g[1] - g[0]) ** 2
    gx, gp = np.meshgrid(g, g, indexing="ij")
    coords = np.stack([gx.ravel(), gp.ravel()], axis=-1)
    vals = tilted_gaussian(coords)
    key = jax.random.PRNGKey(7)
    axis = validation.screenshot_fit(key, coords, vals, da, n_points=160)
    full = validation.screenshot_fit(key, coords, vals, da, n_points=160,
                                     full_ard=True)
    assert full.state.params.lengths.ndim == 2
    assert abs(float(full.state.params.lengths[1, 0])) > 1e-3  # used the tilt
    assert full.mse < 0.7 * axis.mse
    # conservation integrals stay sane under the matrix kernel
    assert full.population_prm == pytest.approx(full.population_grid, rel=0.15)
