"""Tests for the complex GP kernel (reference complex_kernel.cpp parity)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gple_tpu.ops import complex_kernels as CK
from gple_tpu.utils import ri


def make_dataset(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2)) * np.array([1.0, 2.0])
    f = 0.2 * np.exp(-0.5 * (x[:, 0] ** 2 + (x[:, 1] / 2.0) ** 2))
    y = f * np.exp(1.0j * (0.5 * x[:, 0] + 0.2 * x[:, 1]))
    return jnp.asarray(x), jnp.asarray(y)


def to_ri(y):
    return ri.from_complex(jnp.asarray(y))


def to_c(z):
    z = np.asarray(z)
    return z[..., 0] + 1.0j * z[..., 1]


def default_params(mag=1.0, mr=1.0, mi=0.8, noise=0.01):
    return CK.ComplexKernelParams(
        magnitude=jnp.asarray(mag),
        real_magnitude=jnp.asarray(mr),
        real_lengths=jnp.asarray([1.0, 2.0]),
        imag_magnitude=jnp.asarray(mi),
        imag_lengths=jnp.asarray([1.2, 1.8]),
        noise=jnp.asarray(noise),
    )


def test_flat_roundtrip():
    p = default_params()
    flat = p.to_flat()
    # 1 + 2*(1+2) + 1 reference params (complex_kernel.h:18-22) + corr
    assert flat.shape == (9,)
    p2 = CK.ComplexKernelParams.from_flat(flat)
    for a, b in zip(p, p2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_augmented_block_solve_matches_dense():
    """P/Q/v must equal the blocks of the explicit 2N x 2N augmented inverse."""
    x, y = make_dataset(20)
    p = default_params()
    st = CK.fit_complex(p, x, to_ri(y))
    k, kt_re, kt_im = CK.covariance_matrices(p, x, x, same=True)
    k = np.asarray(k).astype(complex)
    kt = np.asarray(kt_re) + 1.0j * np.asarray(kt_im)
    aug = np.block([[k, kt], [kt.conj(), k.conj()]])
    aug_inv = np.linalg.inv(aug)
    n = 20
    p_block = np.asarray(st.p_re) + 1.0j * np.asarray(st.p_im)
    q_block = np.asarray(st.q_re) + 1.0j * np.asarray(st.q_im)
    np.testing.assert_allclose(p_block, aug_inv[:n, :n], atol=1e-9)
    np.testing.assert_allclose(q_block, aug_inv[n:, :n], atol=1e-9)
    labels_c = to_c(st.labels)
    yb = np.concatenate([labels_c, labels_c.conj()])
    sol = aug_inv @ yb
    np.testing.assert_allclose(to_c(st.v), sol[:n], atol=1e-9)
    # lower half of the solve is conj(upper): consistency of the augmented form
    np.testing.assert_allclose(sol[n:], sol[:n].conj(), atol=1e-9)


def test_interpolation_and_variance():
    x, y = make_dataset()
    st = CK.fit_complex(default_params(), x, to_ri(y))
    mean, var, cut = CK.predict_complex(st, x)
    np.testing.assert_allclose(
        to_c(mean), np.asarray(y), atol=1e-2 * float(jnp.max(jnp.abs(y)))
    )
    assert np.all(np.asarray(var) >= -1e-9)


def test_loocv_against_bruteforce():
    """The block LOOCV formula equals leaving one point out of the augmented
    system (both its rows) and predicting it back."""
    x, y = make_dataset(16)
    p = default_params()
    st = CK.fit_complex(p, x, to_ri(y))
    err = float(CK.loocv_error_complex(st))
    n = 16
    k, kt_re, kt_im = CK.covariance_matrices(p, x, x, same=True)
    k = np.asarray(k).astype(complex)
    kt = np.asarray(kt_re) + 1.0j * np.asarray(kt_im)
    ys = to_c(st.labels)
    total = 0.0
    for i in range(n):
        keep = np.arange(n) != i
        kk = k[np.ix_(keep, keep)]
        kkt = kt[np.ix_(keep, keep)]
        aug = np.block([[kk, kkt], [kkt.conj(), kk.conj()]])
        sol = np.linalg.solve(aug, np.concatenate([ys[keep], ys[keep].conj()]))
        v, vc = sol[: n - 1], sol[n - 1 :]
        krow = k[i, keep]
        ktrow = kt[i, keep]
        pred = krow @ v + ktrow @ vc
        total += abs(pred - ys[i]) ** 2
    assert err == pytest.approx(total, rel=1e-6)


def quad_grid(lim=8.0, n=401):
    xs = np.linspace(-lim, lim, n)
    ps = np.linspace(-2 * lim, 2 * lim, 2 * n - 1)
    gx, gp = np.meshgrid(xs, ps, indexing="ij")
    pts = jnp.asarray(np.stack([gx.ravel(), gp.ravel()], axis=-1))
    da = (xs[1] - xs[0]) * (ps[1] - ps[0])
    return pts, da


def test_purity_vs_quadrature():
    x, y = make_dataset(24)
    st = CK.fit_complex(default_params(), x, to_ri(y))
    pts, da = quad_grid()
    mean, _, _ = CK.predict_complex(st, pts, with_variance=False)
    f = to_c(mean)
    purity_quad = (2 * np.pi) * (np.abs(f) ** 2).sum() * da  # (2 pi hbar)^Dim
    assert float(CK.purity_complex(st)) == pytest.approx(purity_quad, rel=1e-5)


def test_loss_gradient_finite():
    x, y = make_dataset(16)

    yri = to_ri(y)

    def loss(flat):
        st = CK.fit_complex(CK.ComplexKernelParams.from_flat(flat), x, yri)
        return CK.loocv_error_complex(st)

    flat0 = default_params().to_flat()
    g = np.asarray(jax.grad(loss)(flat0))
    assert np.all(np.isfinite(g))
    # spot-check one finite difference (real characteristic length 0)
    i = 2
    dv = np.zeros(9); dv[i] = 1e-6
    num = (float(loss(flat0 + dv)) - float(loss(flat0 - dv))) / 2e-6
    assert g[i] == pytest.approx(num, rel=5e-4, abs=1e-7)


def test_optimal_magnitude_positive():
    x, y = make_dataset()
    st = CK.fit_complex(default_params(), x, to_ri(y))
    assert float(CK.optimal_magnitude_complex(st)) > 0


def _chirped_dataset(k=(3.0, -2.0), n=128, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2)) * np.array([0.5, 1.5])
    env = 0.3 * np.exp(-0.5 * ((x[:, 0] / 0.5) ** 2 + (x[:, 1] / 1.5) ** 2))
    y = env * np.exp(1.0j * (x @ np.asarray(k) + 0.7))
    return jnp.asarray(x), to_ri(jnp.asarray(y))


def test_estimate_chirp_recovers_wavevector():
    k_true = (3.0, -2.0)
    x, yri = _chirped_dataset(k_true)
    k_hat = np.asarray(CK.estimate_chirp(x, yri))
    assert k_hat == pytest.approx(np.asarray(k_true), abs=1e-6)


def test_estimate_chirp_zero_labels_gives_zero():
    x, _ = _chirped_dataset()
    k_hat = np.asarray(CK.estimate_chirp(x, jnp.zeros((x.shape[0], 2))))
    assert k_hat == pytest.approx(np.zeros(2), abs=1e-12)


def test_chirped_fit_beats_static_on_fringe_field():
    """Demodulated fit interpolates a fringe field the stationary RBF cannot;
    chirp_k = 0 (the default) must reproduce the reference kernel exactly."""
    x, yri = _chirped_dataset()
    xt, yt = _chirped_dataset(n=64, seed=7)
    params = default_params(mr=1.0, mi=1.0)
    st_plain = CK.fit_complex(params, x, yri)
    st_chirp = CK.fit_complex(params, x, yri, chirp=True)
    assert np.asarray(st_plain.chirp_k) == pytest.approx(np.zeros(2))
    m_plain, _, _ = CK.predict_complex(st_plain, xt, with_variance=False)
    m_chirp, _, _ = CK.predict_complex(st_chirp, xt, with_variance=False)
    scale = float(jnp.max(ri.absval(yt)))
    err_plain = float(jnp.sqrt(jnp.mean(jnp.sum((m_plain - yt) ** 2, -1)))) / scale
    err_chirp = float(jnp.sqrt(jnp.mean(jnp.sum((m_chirp - yt) ** 2, -1)))) / scale
    assert err_chirp < 0.2 * err_plain
    assert err_chirp < 0.02


def test_block_diag_fit_matches_full_at_corr_zero():
    """The block-diagonal fit (the moment-mode production structure,
    corr = 0) must reproduce the full augmented solve: same P/Q blocks,
    same v, same predictions, same purity -- it is an exact algebraic
    specialization, not an approximation."""
    x, y = make_dataset(24)
    p = default_params()._replace(corr=jnp.asarray(0.0))
    st_full = CK.fit_complex(p, x, to_ri(y))
    st_bd = CK.fit_complex(p, x, to_ri(y), block_diag=True)
    np.testing.assert_allclose(np.asarray(st_bd.p_re), np.asarray(st_full.p_re),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_bd.q_re), np.asarray(st_full.q_re),
                               rtol=1e-9, atol=1e-12)
    # corr = 0 makes the imaginary blocks exactly zero in BOTH paths
    np.testing.assert_allclose(np.asarray(st_full.p_im), 0.0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_bd.p_im), 0.0, atol=0.0)
    np.testing.assert_allclose(np.asarray(st_bd.v), np.asarray(st_full.v),
                               rtol=1e-9, atol=1e-12)
    xt = jnp.asarray(np.random.default_rng(1).normal(size=(16, 2)))
    m_full, v_full, c_full = CK.predict_complex(st_full, xt)
    m_bd, v_bd, c_bd = CK.predict_complex(st_bd, xt)
    np.testing.assert_allclose(np.asarray(m_bd), np.asarray(m_full),
                               rtol=1e-8, atol=1e-12)
    # the variance is a cancellation of O(1) terms down to O(1e-4), so the
    # 1e-9 block differences amplify relatively
    np.testing.assert_allclose(np.asarray(v_bd), np.asarray(v_full),
                               rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(float(CK.purity_complex(st_bd)),
                               float(CK.purity_complex(st_full)), rtol=1e-9)


def test_batched_refit_matches_element_fits():
    """The step's refit inverts all four SPD systems in one batched call
    (storage.fit_gp_states, block_diag); it must reproduce the separate
    per-element fits."""
    from gple_tpu.ops import kernels as RK
    from gple_tpu.storage import Density, fit_gp_states

    x, y = make_dataset(24)
    pts = jnp.stack([x, x * 1.1, x * 0.9])
    rho = jnp.stack([to_ri(jnp.abs(y)), to_ri(y), to_ri(0.5 * jnp.abs(y))])
    dens = Density(points=pts, rho=rho, active=jnp.asarray([True, True, True]))
    dp = RK.KernelParams(magnitude=jnp.ones(2),
                         lengths=jnp.asarray([[0.8, 1.2], [1.0, 1.5]]),
                         noise=jnp.full(2, 1e-2))
    op = default_params()._replace(corr=jnp.asarray(0.0))
    gps = fit_gp_states(dp, op, dens, block_diag=True)
    st_off = CK.fit_complex(op, pts[1], rho[1], block_diag=True)
    np.testing.assert_allclose(np.asarray(gps.offdiag.v), np.asarray(st_off.v),
                               rtol=1e-9, atol=1e-12)
    for d, elem in enumerate((0, 2)):
        p = jax.tree.map(lambda a: a[d], dp)
        st = RK.fit_real(p, pts[elem], rho[elem, :, 0])
        np.testing.assert_allclose(np.asarray(gps.diag.alpha[d]),
                                   np.asarray(st.alpha), rtol=1e-9, atol=1e-12)
