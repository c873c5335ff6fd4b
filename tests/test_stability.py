"""Regression tests for the round-1 instability modes of the flagship step.

Three failure modes took down the N=1024 fit+evolve benchmark and are pinned
here so they cannot silently return:

1. All-zero labels (inactive elements carry zeros by design, storage.py):
   an unbounded rescale = 10/tiny overflows downstream rescale**2 terms.
2. The complex-kernel augmented solve at corr -> +-1 with matched Re/Im
   kernels: the old Schur-block chain cancelled to rounding noise; the real
   SPD embedding must stay finite and accurate there.
3. Ill-conditioned grams near the kappa ~ 1e7 corner of the optimizer's
   bound box: the production inverse must stay finite and give a refined
   solve that contracts, never diverges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gple_tpu.ops import complex_kernels as CK
from gple_tpu.ops import kernels as K
from gple_tpu.ops.linalg import psd_inverse, refine_solve
from gple_tpu.utils import ri


def phase_points(n=48, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=(n, 2)) * np.array([1.0, 2.0]))


# ---------------------------------------------------------------------------
# 1. degenerate labels


def test_fit_real_zero_labels_finite():
    """Fitting an inactive element's all-zero labels must stay finite
    end-to-end (fit, LOOCV, predict, cutoff), with bounded rescale."""
    x = phase_points()
    params = K.KernelParams(
        magnitude=jnp.asarray(1.0), lengths=jnp.asarray([1.0, 2.0]), noise=jnp.asarray(0.01)
    )
    st = K.fit_real(params, x, jnp.zeros(x.shape[0]))
    assert np.isfinite(float(st.rescale))
    assert float(st.rescale) <= 10.0 / 1e-30 * (1 + 1e-12)
    assert np.all(np.isfinite(np.asarray(st.alpha)))
    assert np.isfinite(float(K.loocv_error(st)))
    mean, var, cut = K.predict_real(st, phase_points(16, seed=1))
    for a in (mean, var, cut):
        assert np.all(np.isfinite(np.asarray(a)))
    np.testing.assert_allclose(np.asarray(cut), 0.0, atol=1e-12)


def test_fit_complex_zero_labels_finite():
    x = phase_points()
    p = CK.ComplexKernelParams(
        magnitude=jnp.asarray(1.0),
        real_magnitude=jnp.asarray(1.0),
        real_lengths=jnp.asarray([1.0, 2.0]),
        imag_magnitude=jnp.asarray(0.8),
        imag_lengths=jnp.asarray([1.2, 1.8]),
        noise=jnp.asarray(0.01),
    )
    st = CK.fit_complex(p, x, jnp.zeros((x.shape[0], 2)))
    assert np.isfinite(float(st.rescale))
    assert np.all(np.isfinite(np.asarray(st.v)))
    mean, var, cut = CK.predict_complex(st, phase_points(16, seed=1))
    for a in (mean, var, cut):
        assert np.all(np.isfinite(np.asarray(a)))
    np.testing.assert_allclose(np.asarray(cut), 0.0, atol=1e-12)


def test_cutoff_factor_zero_mean_zero_variance():
    """The exact corner that NaN'd on hardware: mean = 0 with var = 0 must
    give cutoff 0, not 0/0."""
    out = np.asarray(K.cutoff_factor(jnp.asarray([0.0, 1e-20]), jnp.asarray([0.0, 0.0])))
    assert np.all(np.isfinite(out))
    assert out[0] == 0.0


# ---------------------------------------------------------------------------
# 2. complex solve at the correlation singular limit


@pytest.mark.parametrize("corr", [1.0, -1.0, 0.999])
def test_complex_fit_at_full_correlation(corr):
    """With matched Re/Im kernels and corr -> +-1 the old Schur chain
    cancelled catastrophically; the SPD embedding must solve the augmented
    system accurately (residual at noise level)."""
    x = phase_points(40, seed=3)
    rng = np.random.default_rng(4)
    y = 0.3 * np.exp(-0.5 * np.asarray(x[:, 0]) ** 2) * np.exp(
        0.5j * np.asarray(x[:, 1])
    ) + 0.01 * (rng.normal(size=40) + 1j * rng.normal(size=40))
    p = CK.ComplexKernelParams(
        magnitude=jnp.asarray(1.0),
        real_magnitude=jnp.asarray(1.0),
        real_lengths=jnp.asarray([1.0, 2.0]),
        imag_magnitude=jnp.asarray(1.0),          # matched: worst case
        imag_lengths=jnp.asarray([1.0, 2.0]),
        noise=jnp.asarray(0.01),
        corr=jnp.asarray(corr),
    )
    st = CK.fit_complex(p, x, ri.from_complex(jnp.asarray(y)))
    v = np.asarray(st.v)
    assert np.all(np.isfinite(v))
    assert np.abs(v).max() < 1e6  # round-1 divergence reached ~1e24
    # residual of the augmented system K v + Kt conj(v) = y_rescaled
    k, ktr, kti = (np.asarray(a) for a in CK.covariance_matrices(p, x, x, same=True))
    vc = v[:, 0] + 1j * v[:, 1]
    yc = np.asarray(st.labels[:, 0] + 1j * st.labels[:, 1])
    res = k @ vc + (ktr + 1j * kti) @ np.conj(vc) - yc
    assert np.abs(res).max() < 1e-6 * np.abs(yc).max()


# ---------------------------------------------------------------------------
# 3. conditioning guard


def test_psd_inverse_high_condition_accurate():
    """At kappa ~ 1e7 (tight lengths, tiny noise) the inverse is finite and
    refine_solve reaches the true solution."""
    rng = np.random.default_rng(5)
    n = 96
    x = rng.normal(size=(n, 2)) * 0.15          # tightly clustered points
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    k = jnp.asarray(np.exp(-0.5 * d2 / 0.5**2) + 3.2e-3**2 * np.eye(n))
    cond = float(np.linalg.cond(np.asarray(k)))
    assert 2e6 < cond < 3e7, cond
    xinv = psd_inverse(k)
    assert np.all(np.isfinite(np.asarray(xinv)))
    y = jnp.asarray(rng.normal(size=n))
    a = np.asarray(refine_solve(xinv, k, y, iters=8))
    a_true = np.linalg.solve(np.asarray(k), np.asarray(y))
    err = np.abs(a - a_true).max() / np.abs(a_true).max()
    assert err < 1e-8, (cond, err)


def test_psd_inverse_pathological_spectrum_contracts():
    """A spectrum spanning 1e9 (beyond any production gram): the inverse
    stays finite and refinement does not diverge."""
    n = 64
    rng = np.random.default_rng(6)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    ev = np.logspace(-9, 0, n)
    k = jnp.asarray((q * ev) @ q.T)
    k = 0.5 * (k + k.T)
    xinv = np.asarray(psd_inverse(k))
    assert np.all(np.isfinite(xinv))
    y = jnp.asarray(rng.normal(size=n))
    r0 = np.linalg.norm(np.asarray(k) @ np.asarray(refine_solve(jnp.asarray(xinv), k, y, iters=2)) - np.asarray(y))
    r1 = np.linalg.norm(np.asarray(k) @ np.asarray(refine_solve(jnp.asarray(xinv), k, y, iters=8)) - np.asarray(y))
    assert r1 <= r0 * (1 + 1e-6) + 1e-12
