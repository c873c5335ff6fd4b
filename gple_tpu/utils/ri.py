"""Real-imaginary (RI) representation of complex values.

Every complex quantity on the compute path -- density values, GP
predictions, phases, the complex-kernel algebra -- is carried as a
trailing-axis-2 float array ``z[..., 0] = Re, z[..., 1] = Im``.  The system was
first written for an accelerator without a complex128 type; whether native
complex128 is faster on the GPU is not measured yet.  The helpers
here keep that arithmetic readable; complex dtypes appear only in host-side
analysis and the CPU oracles.
"""

from __future__ import annotations

import jax.numpy as jnp


def ri(re, im=None):
    """Pack (re, im) into an RI array; im defaults to zero."""
    re = jnp.asarray(re)
    if im is None:
        im = jnp.zeros_like(re)
    return jnp.stack([re, jnp.broadcast_to(jnp.asarray(im), re.shape)], axis=-1)


def from_complex(z):
    z = jnp.asarray(z)
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)


def to_complex(z):
    return z[..., 0] + 1.0j * z[..., 1]


def re(z):
    return z[..., 0]


def im(z):
    return z[..., 1]


def conj(z):
    return jnp.stack([z[..., 0], -z[..., 1]], axis=-1)


def add(a, b):
    return a + b


def mul(a, b):
    """Elementwise complex multiply."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return jnp.stack([ar * br - ai * bi, ar * bi + ai * br], axis=-1)


def scale(a, s):
    """Multiply by a real scalar/array (broadcast over the RI axis)."""
    return a * jnp.asarray(s)[..., None]


def abs2(z):
    return z[..., 0] ** 2 + z[..., 1] ** 2


def absval(z):
    return jnp.hypot(z[..., 0], z[..., 1])


def phase_mul(z, theta):
    """Multiply by e^{i theta} (theta real, broadcast against z[..., 0])."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack(
        [z[..., 0] * c - z[..., 1] * s, z[..., 0] * s + z[..., 1] * c], axis=-1
    )


def matvec(m_re, m_im, v):
    """(complex matrix as two real parts) @ (RI vector) -> RI vector."""
    vr, vi = v[..., 0], v[..., 1]
    return jnp.stack(
        [m_re @ vr - m_im @ vi, m_re @ vi + m_im @ vr], axis=-1
    )


def rmatvec(m_re, v):
    """(real matrix) @ (RI vector)."""
    return jnp.stack([m_re @ v[..., 0], m_re @ v[..., 1]], axis=-1)


def matmul(a_re, a_im, b_re, b_im):
    """Complex matmul from real parts -> (re, im)."""
    return a_re @ b_re - a_im @ b_im, a_re @ b_im + a_im @ b_re


def vdot_re(a, b):
    """Re(a^H b) = sum(a_re b_re + a_im b_im)."""
    return jnp.sum(a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1], axis=-1)
