"""Real Gaussian-process kernel for the diagonal density-matrix elements.

Re-design of the reference real GPR stack
(``gaussian_process_liouville_equation/kernel.{h,cpp}``):

* kernel definition  k(x, x') = sigma_f^2 (exp(-1/2 sum_d ((x_d - x'_d)/l_d)^2)
  + sigma_n^2 delta(x, x'))                            -- ``kernel.h:25-28``
* label rescaling to max = 10                          -- ``kernel.h:37``, ``kernel.cpp:279-280``
* Cholesky + K^-1 y + LOOCV squared error              -- ``kernel.cpp:281-285``
* analytic population / <r> / purity integrals         -- ``kernel.cpp:286-335``
* predictive mean / per-point variance / smoothstep
  cutoff                                                -- ``kernel.cpp:481-544``, ``kernel.h:296-332``

Design notes:

* Points sit on ROWS: features are ``(N, PhaseDim)`` so the Gram construction
  and predictive products are plain matmuls.
* The training state caches the full K^-1 (like the reference,
  kernel.cpp:282), computed by :func:`gple_tpu.ops.linalg.psd_inverse`
  (Cholesky), so both the LOOCV loss and the predictive variance are matmul
  chains with no triangular solves at predict time.
* **All hand-derived gradients of the reference (kernel.cpp:337-477) are
  deleted**: every quantity here is a smooth jnp function of the parameters,
  so ``jax.grad`` supplies exact derivatives for the optimizer.
* Everything is shaped for ``vmap`` over density-matrix elements; no Python
  control flow depends on data.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gple_tpu.utils.constants import purity_factor

#: rescale target: max |label| -> 10 (reference kernel.h:37)
RESCALE_MAXIMUM = 10.0
#: cutoff connecting point: predictions below 2 sigma are suppressed (kernel.h:16)
CONNECTING_POINT = 2.0


class KernelParams(NamedTuple):
    """(magnitude, lengths, noise) -- reference parameter order kernel.cpp:253-273."""

    magnitude: jnp.ndarray   # scalar sigma_f
    lengths: jnp.ndarray     # (PhaseDim,) characteristic lengths
    noise: jnp.ndarray       # scalar relative noise sigma_n

    @property
    def num_params(self) -> int:
        return 2 + self.lengths.shape[-1]

    def to_flat(self) -> jnp.ndarray:
        return jnp.concatenate(
            [jnp.atleast_1d(self.magnitude), self.lengths, jnp.atleast_1d(self.noise)],
            axis=-1,
        )

    @classmethod
    def from_flat(cls, flat: jnp.ndarray) -> "KernelParams":
        return cls(magnitude=flat[..., 0], lengths=flat[..., 1:-1], noise=flat[..., -1])


def gram(lengths, xa, xb):
    """Unit-magnitude RBF Gram matrix exp(-1/2 |z_a - z_b|^2), (Na, Nb).

    ``lengths`` selects between two hypothesis classes:

    * vector ``(PhaseDim,)`` -- axis-aligned ARD, z = x / l (the main-program
      kernel, kernel.h:25-28);
    * matrix ``(PhaseDim, PhaseDim)`` -- full lower-triangular characteristic
      matrix W, z = W x, whose diagonal is the INVERSE lengths and whose
      off-diagonal terms couple dimensions (the reference validation GPR's
      shogun GaussianARD weights, test/gpr.cpp:309-328,368-396) -- a strictly
      richer class that can align to tilted phase-space distributions.

    The two are distinguished by rank relative to the features so both stay
    valid under ``vmap`` batching (batched vector lengths are ``ndim - 1`` of
    the batched features; batched matrices are equal ndim).

    Broadcast-difference form: exact (no catastrophic cancellation) and cheap
    at PhaseDim = 2.  XLA fuses it with the exp and, in the predictive mean,
    with the reduction against alpha (PERF.md: not bandwidth-bound on the
    H100).
    """
    if lengths.ndim == xa.ndim:  # full characteristic matrix: z = W x
        za = jnp.einsum("...ij,...nj->...ni", lengths, xa)
        zb = jnp.einsum("...ij,...nj->...ni", lengths, xb)
    else:
        za = xa / lengths
        zb = xb / lengths
    d2 = jnp.sum((za[..., :, None, :] - zb[..., None, :, :]) ** 2, axis=-1)
    return jnp.exp(-0.5 * d2)


def effective_length_product(lengths) -> jnp.ndarray:
    """prod of characteristic lengths -- the Gaussian-integral volume factor.

    Vector lengths: prod(l).  Characteristic matrix W (lower triangular,
    z = W x): integral of exp(-1/2 |W d|^2) over d is (2 pi)^Dim / det(W)
    with det(W) = prod(diag(W)), so the effective product is 1/prod(|diag W|)
    (reference test/gpr.cpp:750 uses Characteristic.diagonal().prod() the
    same way)."""
    if lengths.ndim >= 2:
        return 1.0 / jnp.abs(jnp.prod(jnp.diagonal(lengths, axis1=-2, axis2=-1), axis=-1))
    return jnp.prod(lengths, axis=-1)


def purity_aux_lengths(lengths):
    """The sqrt(2)-widened characteristic of the purity auxiliary kernel:
    exp(-1/4 |z_i - z_j|^2) (kernel.h:285-294).  Vector: sqrt(2) l; matrix:
    W / sqrt(2)."""
    if lengths.ndim >= 2:
        return lengths / jnp.sqrt(2.0)
    return jnp.sqrt(2.0) * lengths


def kernel_matrix(params: KernelParams, xa, xb, same: bool):
    """Full kernel sigma_f^2 (G + sigma_n^2 I[same]), (Na, Nb)."""
    g = gram(params.lengths, xa, xb)
    if same:
        g = g + params.noise**2 * jnp.eye(xa.shape[-2], dtype=g.dtype)
    return params.magnitude**2 * g


class RealTrainState(NamedTuple):
    """Everything cached from one training-set factorization.

    Caching the full K^-1 (like the reference, kernel.cpp:282) makes the
    predict-time variance a pure matmul chain.  The inverse itself comes from
    :func:`gple_tpu.ops.linalg.psd_inverse` (Cholesky)."""

    params: KernelParams
    features: jnp.ndarray        # (N, PhaseDim)
    labels: jnp.ndarray          # (N,) rescaled real labels
    rescale: jnp.ndarray         # scalar: labels = raw * rescale
    kinv: jnp.ndarray            # (N, N) K^-1
    alpha: jnp.ndarray           # (N,) K^-1 labels (rescaled)


def finish_real_fit(params: KernelParams, features, labels_raw, k,
                    kinv) -> RealTrainState:
    """State assembly AFTER the SPD inverse: label rescale + refined alpha.

    Split out of :func:`fit_real` so the production refit can solve all four
    of the step's SPD systems in ONE batched inverse
    (storage.fit_gp_states via linalg.psd_inverse_batched) and finish each
    element here."""
    from gple_tpu.ops.linalg import refine_solve

    labels_real = jnp.real(labels_raw)
    # clip guards the all-zero-label case (inactive elements carry zeros by
    # design, storage.py): an unbounded 10/1e-300 rescale overflows every
    # downstream rescale**2, and 0 * inf = NaN poisons the labels themselves
    rescale = RESCALE_MAXIMUM / jnp.maximum(jnp.max(jnp.abs(labels_real)), 1e-30)
    y = labels_real * rescale
    alpha = refine_solve(kinv, k, y, iters=3)
    return RealTrainState(
        params=params, features=features, labels=y, rescale=rescale,
        kinv=kinv, alpha=alpha,
    )


def fit_real(params: KernelParams, features, labels_raw) -> RealTrainState:
    """Factorize the training kernel (reference TrainingKernel ctor).

    ``labels_raw`` may be complex; only the real part carries information for
    diagonal elements (kernel.cpp:279-283).
    """
    from gple_tpu.ops.linalg import psd_inverse

    k = kernel_matrix(params, features, features, same=True)
    kinv = psd_inverse(k)
    return finish_real_fit(params, features, labels_raw, k, kinv)


def kinv_diagonal(state: RealTrainState) -> jnp.ndarray:
    """diag(K^-1) from the cached inverse (kernel.cpp:282-285)."""
    return jnp.diagonal(state.kinv)


def loocv_error(state: RealTrainState) -> jnp.ndarray:
    """Leave-one-out CV squared error sum((alpha_i / K^-1_ii)^2) (kernel.cpp:285)."""
    return jnp.sum((state.alpha / kinv_diagonal(state)) ** 2)


def predict_real(state: RealTrainState, test_features, with_variance: bool = True):
    """Mean, variance, and cutoff prediction at ``test_features`` (M, PhaseDim).

    Returns ``(mean_raw, variance, cutoff_raw)`` where the means are unscaled
    back to label units; variance is in rescaled units to match the cutoff
    comparison of the reference (kernel.cpp:495-519).  f64 throughout, like
    the reference.
    """
    k_star = kernel_matrix(state.params, test_features, state.features, same=False)
    mean_scaled = k_star @ state.alpha
    if not with_variance:
        return mean_scaled / state.rescale, None, mean_scaled / state.rescale
    # var_i = k(x_i, x_i) - k_star_i K^-1 k_star_i^T : two matmuls
    self_k = state.params.magnitude**2 * (1.0 + state.params.noise**2)
    var = self_k - jnp.sum((k_star @ state.kinv) * k_star, axis=-1)
    cut = cutoff_factor(mean_scaled, var)
    return mean_scaled / state.rescale, var, mean_scaled * cut / state.rescale


def cutoff_factor(prediction, variance):
    """Smoothstep suppression of low-signal predictions (kernel.h:296-332).

    1 where |pred| >= 2 sqrt(var); 0 where |pred| <= sqrt(var); smooth cubic
    in between.  Branch-free.
    """
    c = CONNECTING_POINT
    # floor against t = 0/0 = NaN for zero-mean zero-variance rows (inactive
    # elements); 1e-30 is ~20 orders below any meaningful rescaled variance
    # (O(1e-8)).
    var = jnp.maximum(variance, 1e-30)
    t = jnp.abs(prediction) / jnp.sqrt(var)
    mid = (3.0 * c - 2.0 * t - 1.0) * (t - 1.0) ** 2 / (c - 1.0) ** 3
    return jnp.where(t >= c, 1.0, jnp.where(t <= 1.0, 0.0, mid))


def extra_set_error(state: RealTrainState, test_features, test_labels_raw) -> jnp.ndarray:
    """Squared prediction error on a held-out set, in rescaled units
    (reference PredictiveKernel with TestLabel, kernel.cpp:521-522)."""
    k_star = kernel_matrix(state.params, test_features, state.features, same=False)
    mean_scaled = k_star @ state.alpha
    y = jnp.real(test_labels_raw) * state.rescale
    return jnp.sum((mean_scaled - y) ** 2)


def optimal_magnitude(state: RealTrainState) -> jnp.ndarray:
    """Maximum-likelihood magnitude sqrt(y^T K^-1 y / N) given magnitude = 1
    during optimization (reference kernel.h:167-179)."""
    within = jnp.dot(state.labels, state.alpha) / state.labels.shape[0]
    return jnp.sqrt(jnp.abs(within))


# -- analytic phase-space integrals (kernel.cpp:286-335) ------------------------

def _dim(state: RealTrainState) -> int:
    return state.features.shape[-1] // 2


def population(state: RealTrainState) -> jnp.ndarray:
    """integral f(r) dr = (2 pi)^Dim sigma_f^2 prod(l) sum(alpha) / rescale."""
    d = _dim(state)
    factor = (2.0 * jnp.pi) ** d * state.params.magnitude**2 \
        * effective_length_product(state.params.lengths)
    return factor * jnp.sum(state.alpha) / state.rescale


def r_average(state: RealTrainState) -> jnp.ndarray:
    """integral r f(r) dr, shape (PhaseDim,) (kernel.cpp:298-312)."""
    d = _dim(state)
    factor = (2.0 * jnp.pi) ** d * state.params.magnitude**2 \
        * effective_length_product(state.params.lengths)
    return factor * (state.features.T @ state.alpha) / state.rescale


def purity(state: RealTrainState) -> jnp.ndarray:
    """(2 pi hbar)^Dim integral f^2 dr via the sqrt(2)-widened auxiliary kernel
    (kernel.h:285-294, kernel.cpp:313-335):

        purity = (2 pi hbar)^Dim pi^Dim alpha^T K1 alpha / rescale^2,
        K1 = sigma_f^4 prod(l) exp(-1/4 sum((dx/l)^2)).
    """
    d = _dim(state)
    aux_mag_sq = state.params.magnitude**4 \
        * effective_length_product(state.params.lengths)
    k1 = aux_mag_sq * gram(
        purity_aux_lengths(state.params.lengths), state.features, state.features
    )
    quad = state.alpha @ (k1 @ state.alpha)
    return purity_factor(d) * jnp.pi**d * quad / state.rescale**2
