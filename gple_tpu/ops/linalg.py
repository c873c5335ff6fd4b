"""Positive-definite linear algebra for the GP refits.

Every SPD inverse of the hot path is Cholesky + ``cho_solve`` in f64: LAPACK
on the CPU, cuSOLVER (batched ``potrf``) and cuBLAS (``trsm``) on the GPU,
matching the reference's LDLT solve (kernel.cpp:281-283).  The training
state caches the full inverse (like the reference, kernel.cpp:282), so the
LOOCV loss and the predictive variance are matmul chains.

* ``psd_inverse`` carries the exact derivative d(K^-1) = -K^-1 dK K^-1 as
  its JVP rule, so the hyperparameter optimizer differentiates through it.
* ``psd_inverse_batched`` inverts a (B, N, N) stack in one batched call:
  the refit's four SPD systems per step (storage.fit_gp_states).
* ``refine_solve`` adds O(N^2) f64 iterative refinement to solves through
  the cached inverse.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.custom_jvp
def psd_inverse(k):
    """Inverse of a symmetric positive-definite (N, N) matrix."""
    chol = jnp.linalg.cholesky(k)
    kinv = jax.scipy.linalg.cho_solve((chol, True), jnp.eye(k.shape[0], dtype=k.dtype))
    return 0.5 * (kinv + kinv.T)


@psd_inverse.defjvp
def _psd_inverse_jvp(primals, tangents):
    (k,), (dk,) = primals, tangents
    kinv = psd_inverse(k)
    return kinv, -kinv @ dk @ kinv


def psd_inverse_batched(ks):
    """:func:`psd_inverse` over a stack of SPD matrices (B, N, N)."""
    return jax.vmap(psd_inverse)(ks)


def refine_solve(kinv, k, y, iters: int = 5):
    """Iterative refinement of x = K^-1 y given an approximate inverse:
    x += X (y - K x).  f64 O(N^2) per step; error shrinks by ||I - K X||.
    HIGHEST matmul precision: the residual y - K x must be computed at full
    f64, or the refinement floor is the matmul rounding, not eps."""
    with jax.default_matmul_precision("highest"):
        x = kinv @ y
        for _ in range(iters):
            x = x + kinv @ (y - k @ x)
        return x
