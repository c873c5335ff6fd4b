"""Constrained GP hyperparameter optimization.

Replacement for the reference's NLopt stack (``opt.cpp``):

* loss = LOOCV error + extra-set prediction error       -- ``opt.cpp:441-482``
* magnitude and noise pinned during optimization, the
  magnitude set analytically afterwards                 -- ``opt.cpp:25-27,44-57,1179-1195``
* bounds: characteristic lengths in [std/sqrt(N), 2 std]
  of the current point cloud                            -- ``opt.cpp:1026-1052``
* equality constraints population = 1, energy = E0,
  purity = P0, with a purity-free diagonal pass when
  the coherence is optimized separately                 -- ``opt.cpp:644-719,1135-1177``
* three-stage restart ladder: local-from-previous ->
  local-from-initial -> global (multi-start random
  restarts replace DIRECT_L), accepted via the 5%
  ``check_averages`` rule and ``compare_and_overwrite`` -- ``opt.cpp:1200-1392``

Design notes:

* NLopt's Nelder-Mead / SLSQP / AUGLAG_EQ zoo becomes ONE jit-compiled
  pipeline: bound-constrained L-BFGS (optax, zoom linesearch) on
  sigmoid-transformed parameters, wrapped in an augmented-Lagrangian outer
  loop for the equality constraints.  Each restart stage is a single XLA
  program; gradients are exact ``jax.grad`` through the Cholesky
  factorization, so the reference's ~2,000 lines of hand-derived derivatives
  have no counterpart here.
* Population, <r>, and purity are invariant to the pinned global magnitude
  (alpha scales as sigma^-2 against the sigma^2 in the analytic integrals), so
  pin-then-set-analytically is exact, not an approximation.
* NaN/Inf guarding (the reference's ``make_normal``, opt.cpp:418-431) is a
  ``jnp.nan_to_num`` on losses and constraint values.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gple_tpu.ops import complex_kernels as CK
from gple_tpu.ops import kernels as RK
from gple_tpu.storage import DIAG_INDICES, OFFDIAG_INDEX, Density

#: relative tolerance of the conservation checks (reference opt.h:13)
AVERAGE_TOLERANCE = 0.05
#: pinned magnitude / noise during optimization (opt.cpp:25-27)
INITIAL_MAGNITUDE = 1.0
INITIAL_NOISE = 1e-2
#: sub-kernel magnitude bounds for the complex kernel (opt.cpp:86-87)
COMPLEX_MAG_LB = 0.1
COMPLEX_MAG_UB = 10.0
#: bound on the real-imaginary correlation strength rho (new parameter; the
#: reference pins rho = 1, which cannot represent quadrature coherences --
#: see ComplexKernelParams.corr).  Strictly inside (-1, 1) keeps the
#: augmented system PD rather than merely PSD.
CORR_BOUND = 0.99
#: hard floor on characteristic lengths (opt.cpp:397)
MIN_CHAR_LENGTH = 1.0 / 100.0

LBFGS_STEPS = 60
AL_OUTER = 4
GLOBAL_STARTS = 16
#: augmented-Lagrangian penalty schedule on the RELATIVE constraint
#: violations.  The loss (LOOCV + extra-set error on labels rescaled to
#: max 10) is O(10-100), so the penalty must reach ~1e6 for a 0.1% relative
#: violation to cost O(1) -- with the reference's NLopt SLSQP the equality
#: constraints are exact (KKT), and a weak penalty here lets every reopt
#: accept population ~0.97, which the evolution then locks in (the labels
#: relax to the fit), ratcheting the norm down a few percent per reopt.
AL_MU0 = 1e3
AL_MU_GROWTH = 10.0


def _wstd_jnp(points, weights):
    """|weight|-weighted per-axis std of a cloud (jittable), floored."""
    w = jnp.maximum(jnp.abs(weights), 1e-30)
    mu = (points.T @ w) / jnp.sum(w)
    var = (((points - mu) ** 2).T @ w) / jnp.sum(w)
    return jnp.sqrt(jnp.maximum(var, MIN_CHAR_LENGTH**2))


def moment_kernel_params(density: Density, prev_diag: "RK.KernelParams",
                         prev_off: "CK.ComplexKernelParams",
                         off_extra=None, off_len_div: float = 2.0,
                         track_diag: bool = True):
    """Closed-form moment-based kernel parameters from the current cloud.

    Jittable counterpart of ``Optimizer._moment_impl``'s parameter choice
    (lengths = |label|-weighted cloud std / 2 per axis, off-diagonal sub-
    kernel magnitudes = label RMS), used by the per-tick hyperparameter
    tracking path (``GPLEConfig.moment_per_tick``): clouds stretch and drift
    between reoptimizations, and lengths frozen at the last reopt mis-smooth
    the fit the evolution reads.  Magnitudes/noise/corr carry over from
    ``prev`` -- the GP MEAN the evolver queries is insensitive to the overall
    magnitude, and inactive elements keep their previous parameters."""
    diag_idx = jnp.asarray(DIAG_INDICES)
    if track_diag:
        lens = jax.vmap(_wstd_jnp)(
            density.points[diag_idx], density.rho[diag_idx, :, 0]
        ) / 2.0
        act_d = density.active[diag_idx][:, None]
        diag = RK.KernelParams(
            magnitude=prev_diag.magnitude,
            lengths=jnp.where(act_d, lens, prev_diag.lengths),
            noise=prev_diag.noise,
        )
    else:
        # per-tick DIAG tracking measured worse (RMSE 0.067 vs 0.049 frozen,
        # round 2): the diagonal lengths co-evolve with the carried-label rot;
        # only the coherence needs live lengths (its std moves fast through
        # the crossing while the fringes demand a tight std/len ratio)
        diag = prev_diag
    o_pts = density.points[OFFDIAG_INDEX]
    o_rho = density.rho[OFFDIAG_INDEX]
    if off_extra is not None:
        o_pts = jnp.concatenate([o_pts, off_extra[0]], axis=0)
        o_rho = jnp.concatenate([o_rho, off_extra[1]], axis=0)
    lr = _wstd_jnp(o_pts, o_rho[:, 0]) / off_len_div
    li = _wstd_jnp(o_pts, o_rho[:, 1]) / off_len_div
    mr = jnp.sqrt(jnp.mean(o_rho[:, 0] ** 2)) + 1e-30
    mi = jnp.sqrt(jnp.mean(o_rho[:, 1] ** 2)) + 1e-30
    act_o = density.active[OFFDIAG_INDEX]
    off = CK.ComplexKernelParams(
        magnitude=prev_off.magnitude,
        real_magnitude=jnp.where(act_o, mr, prev_off.real_magnitude),
        real_lengths=jnp.where(act_o, lr, prev_off.real_lengths),
        imag_magnitude=jnp.where(act_o, mi, prev_off.imag_magnitude),
        imag_lengths=jnp.where(act_o, li, prev_off.imag_lengths),
        noise=prev_off.noise,
        corr=prev_off.corr,
    )
    return diag, off


def _sigmoid_to_bounds(z, lb, ub):
    return lb + (ub - lb) * jax.nn.sigmoid(z)


def _bounds_to_sigmoid(theta, lb, ub):
    frac = jnp.clip((theta - lb) / jnp.maximum(ub - lb, 1e-30), 1e-6, 1.0 - 1e-6)
    return jnp.log(frac) - jnp.log1p(-frac)


# -- pure losses / constraints -----------------------------------------------------

def _diag_states(diag_lengths, data):
    params = RK.KernelParams(
        magnitude=jnp.ones(2), lengths=diag_lengths, noise=jnp.full(2, INITIAL_NOISE)
    )
    return jax.vmap(RK.fit_real)(params, data["dpts"], data["drho"])


def _diag_loss_from_states(states, data):
    loo = jax.vmap(RK.loocv_error)(states)
    extra = jax.vmap(RK.extra_set_error)(states, data["depts"], data["derho"])
    per_elem = jnp.nan_to_num(loo + extra, nan=1e30, posinf=1e30)
    return jnp.sum(per_elem * data["dmask"])


def _diag_loss(diag_lengths, data):
    return _diag_loss_from_states(_diag_states(diag_lengths, data), data)


def _off_state(off_flat, data, block_diag: bool = False):
    # off_flat: (m_R, l_R(d), m_I, l_I(d), corr) -- 2d + 3 entries
    d = (off_flat.shape[0] - 3) // 2
    params = CK.ComplexKernelParams(
        magnitude=jnp.asarray(1.0),
        real_magnitude=off_flat[0],
        real_lengths=off_flat[1 : 1 + d],
        imag_magnitude=off_flat[1 + d],
        imag_lengths=off_flat[2 + d : 2 + 2 * d],
        noise=jnp.asarray(INITIAL_NOISE),
        corr=off_flat[-1],
    )
    return CK.fit_complex(params, data["opts"], data["orho"],
                          block_diag=block_diag)


def _off_loss_from_state(state, data):
    loss = CK.loocv_error_complex(state) + CK.extra_set_error_complex(
        state, data["oepts"], data["oerho"]
    )
    return jnp.nan_to_num(loss, nan=1e30, posinf=1e30) * data["omask"]


def _off_loss(off_flat, data):
    return _off_loss_from_state(_off_state(off_flat, data), data)


def _raw_averages(diag_lengths, off_flat, data, with_off: bool):
    """(population, energy, purity) from the analytic GP integrals."""
    states = _diag_states(diag_lengths, data)
    pops = jax.vmap(RK.population)(states) * data["dmask"]
    population = jnp.sum(pops)
    energy = jnp.sum(pops * data["energies"])
    pur = jnp.sum(jax.vmap(RK.purity)(states) * data["dmask"])
    if with_off:
        pur = pur + 2.0 * CK.purity_complex(_off_state(off_flat, data)) * data["omask"]
    vals = jnp.stack([population, energy, pur])
    return jnp.nan_to_num(vals, nan=1e150, posinf=1e150, neginf=-1e150)


# -- inner solvers -------------------------------------------------------------------

#: L-BFGS history length (two-loop recursion)
LBFGS_HISTORY = 8
#: candidate step scales of the vectorized linesearch (covers 2^-9 .. 2)
LINESEARCH_SCALES = tuple(2.0**k for k in range(-9, 2, 2)) + (1.0,)


def _lbfgs_scan(fn, z0, steps: int):
    """Platform-adaptive bounded L-BFGS inner solver.

    On CPU (where the optimizer runs by default, like the reference's NLopt,
    opt.cpp:1019) this is optax's zoom-linesearch L-BFGS: the data-dependent
    while_loop is cheap in-process and evaluates the loss ~2-3x per step.
    On CUDA (``Optimizer.device="default"`` only) it is the fixed-fan variant
    below: a FIXED fan of candidate steps evaluated in one ``vmap`` (batched
    GP fits), no data-dependent control flow, so no host sync per linesearch
    iteration.  Whether zoom is faster on the GPU is not measured yet.

    Dispatch is ``lax.platform_dependent``, resolved at LOWERING time for the
    platform the ladder actually runs on -- ``jax.default_backend()`` does not
    see ``jax.default_device(cpu)`` contexts (Optimizer.device='cpu' in a GPU
    session must take the zoom path).
    """
    return jax.lax.platform_dependent(
        z0,
        cpu=lambda z: _lbfgs_zoom(fn, z, steps),
        cuda=lambda z: _lbfgs_fixed_fan(fn, z, steps),
    )


#: inner-solver convergence: stop when the sup-norm of the L-BFGS update falls
#: below this (sigmoid-space parameters are O(1); 1e-7 is far past any
#: physically meaningful change in the lengths).  The reference's NLopt stops
#: on the same kind of step tolerance (opt.cpp:342-346 sets xtol/ftol).
ZOOM_XTOL = 1e-7


def _lbfgs_zoom(fn, z0, steps: int):
    """optax L-BFGS with zoom linesearch (CPU path).

    Runs as a ``while_loop`` with a step-size convergence test instead of a
    fixed-length scan: warm restarts typically converge in far fewer than
    ``steps`` iterations, and on the host an early exit skips their ~2-3 loss
    evaluations each (the optimizer is the wall-clock bottleneck of a CPU
    trajectory).  The CUDA path keeps the fixed-length scan (see
    :func:`_lbfgs_scan`)."""
    opt = optax.lbfgs()
    state = opt.init(z0)
    vg = optax.value_and_grad_from_state(fn)

    def cond(carry):
        _, _, i, dz = carry
        return (i < steps) & (dz > ZOOM_XTOL)

    def body(carry):
        z, st, i, _ = carry
        value, grad = vg(z, state=st)
        grad = jnp.nan_to_num(grad)
        updates, st = opt.update(grad, st, z, value=value, grad=grad, value_fn=fn)
        z = optax.apply_updates(z, updates)
        dz = jnp.max(jnp.abs(jnp.nan_to_num(updates)))
        return (z, st, i + 1, dz)

    z, _, _, _ = jax.lax.while_loop(
        cond, body, (z0, state, jnp.asarray(0), jnp.asarray(jnp.inf, dtype=z0.dtype))
    )
    return z


def _lbfgs_fixed_fan(fn, z0, steps: int):
    """Fixed-step L-BFGS: two-loop recursion + a VECTORIZED linesearch (CUDA
    path).  The candidate fan doubles as a trust region: when no candidate
    improves the loss the iterate stays put (the zero candidate), mirroring
    NLopt's termination-by-stall rather than diverging.
    """
    shape = z0.shape
    z0 = z0.ravel()
    d = z0.shape[0]
    m = LBFGS_HISTORY
    scales = jnp.asarray(LINESEARCH_SCALES + (0.0,), dtype=z0.dtype)

    def fn_flat(z):
        return fn(z.reshape(shape))

    def vg(z):
        value, grad = jax.value_and_grad(fn_flat)(z)
        return jnp.nan_to_num(value, nan=1e30, posinf=1e30), jnp.nan_to_num(grad)

    def direction(g, S, Y, rho, k):
        """Two-loop recursion over the circular (S, Y) history."""
        q = g
        alphas = []
        for j in range(m):          # newest to oldest
            i = (k - 1 - j) % m
            valid = (rho[i] > 0.0) & (j < k)
            a = jnp.where(valid, rho[i] * jnp.dot(S[i], q), 0.0)
            q = q - a * Y[i]
            alphas.append((i, valid, a))
        i_last = (k - 1) % m
        sy = jnp.dot(S[i_last], Y[i_last])
        yy = jnp.dot(Y[i_last], Y[i_last])
        gamma = jnp.where((k > 0) & (sy > 0.0) & (yy > 0.0), sy / jnp.maximum(yy, 1e-30), 1.0)
        r = gamma * q
        for i, valid, a in reversed(alphas):   # oldest to newest
            b = jnp.where(valid, rho[i] * jnp.dot(Y[i], r), 0.0)
            r = r + jnp.where(valid, (a - b), 0.0) * S[i]
        return -r

    def step(carry, _):
        z, value, grad, S, Y, rho, k = carry
        p = direction(grad, S, Y, rho, k)
        # safeguard: fall back to steepest descent if the direction is not
        # a descent direction (stale curvature pairs)
        descent = jnp.dot(p, grad) < 0.0
        p = jnp.where(descent, p, -grad)
        cands = z[None, :] + scales[:, None] * p[None, :]
        values = jax.vmap(fn_flat)(cands)
        values = jnp.nan_to_num(values, nan=1e30, posinf=1e30)
        # the 0.0 scale reproduces f(z): argmin never regresses
        values = values.at[-1].set(value)
        best = jnp.argmin(values)
        z_new = cands[best]
        v_new, g_new = vg(z_new)
        s = z_new - z
        y = g_new - grad
        sy = jnp.dot(s, y)
        ok = sy > 1e-12
        i = k % m
        S = S.at[i].set(jnp.where(ok, s, S[i]))
        Y = Y.at[i].set(jnp.where(ok, y, Y[i]))
        rho = rho.at[i].set(jnp.where(ok, 1.0 / jnp.maximum(sy, 1e-30), rho[i]))
        k = k + jnp.where(ok, 1, 0)
        return (z_new, v_new, g_new, S, Y, rho, k), v_new

    v0, g0 = vg(z0)
    S0 = jnp.zeros((m, d), dtype=z0.dtype)
    Y0 = jnp.zeros((m, d), dtype=z0.dtype)
    rho0 = jnp.zeros((m,), dtype=z0.dtype)
    carry0 = (z0, v0, g0, S0, Y0, rho0, jnp.asarray(0))
    (z, _, _, _, _, _, _), _ = jax.lax.scan(step, carry0, None, length=steps)
    return z.reshape(shape)


@partial(jax.jit, static_argnums=(4, 5, 6))
def _run_stage(start_diag, start_off, lam0, data, off_active: bool,
               lbfgs_steps: int, al_outer: int):
    """One complete do_optimize pass (opt.cpp:1101-1198) as a single XLA
    program: elementwise fits, then the constrained diagonal pass, then (when
    the coherence is active) the constrained full pass.

    ``lam0``: (2, 3) warm-start Lagrange multipliers for the (diag, full)
    constrained passes -- zeros for a cold start.  Warm multipliers carry the
    converged constraint prices from the previous reoptimization, so the
    ladder's usual ``local_previous`` stage needs fewer outer updates
    (al_outer = 2 instead of 4) for the same acceptance (the reference's
    SLSQP re-derives exact KKT multipliers each call; an AL method gets them
    iteratively, and between reopts they barely move).

    Returns (diag_lengths, off_flat, error, raw_averages, lam_out).
    """
    dlb, dub = data["dlb"], data["dub"]
    olb, oub = data["olb"], data["oub"]
    targets = data["targets"]

    # 1. elementwise unconstrained minimization
    zd = _bounds_to_sigmoid(start_diag, dlb, dub)
    zd = _lbfgs_scan(lambda z: _diag_loss(_sigmoid_to_bounds(z, dlb, dub), data),
                     zd, lbfgs_steps)
    zo = _bounds_to_sigmoid(start_off, olb, oub)
    if off_active:
        zo = _lbfgs_scan(lambda z: _off_loss(_sigmoid_to_bounds(z, olb, oub), data),
                         zo, lbfgs_steps)

    # 2. constrained passes via augmented Lagrangian.  The outer multiplier
    # updates run as a lax.scan (NOT an unrolled Python loop): one L-BFGS
    # body in the compiled graph instead of al_outer copies -- the unrolled
    # form made _run_stage a very long XLA compile.
    def al_minimize(z0, loss_and_cons, n_cons, lam_init):
        def outer(carry, _):
            z, lam, mu = carry

            def objective(zz):
                loss, cons = loss_and_cons(zz)
                return loss + jnp.sum(lam * cons) + 0.5 * mu * jnp.sum(cons**2)

            z = _lbfgs_scan(objective, z, lbfgs_steps)
            _, cons = loss_and_cons(z)
            return (z, lam + mu * cons, mu * AL_MU_GROWTH), None

        (z, lam, _), _ = jax.lax.scan(
            outer, (z0, lam_init[:n_cons], jnp.asarray(AL_MU0)), None, length=al_outer
        )
        return z, lam

    # diagonal pass: purity constraint only when the coherence is absent
    n_cons_diag = 2 if off_active else 3
    zo_fixed = zo

    # constraints are RELATIVE violations (avgs/target - 1): one penalty
    # scale works for population (~1), energy (~0.1), and purity (~1) alike
    cons_scale = jnp.maximum(jnp.abs(targets), 1e-3)

    def diag_lc(z):
        lengths = _sigmoid_to_bounds(z, dlb, dub)
        off_flat = _sigmoid_to_bounds(zo_fixed, olb, oub)
        avgs = _raw_averages(lengths, off_flat, data, with_off=False)
        cons = ((avgs - targets) / cons_scale)[:n_cons_diag]
        return _diag_loss(lengths, data), cons

    zd, lam_diag = al_minimize(zd, diag_lc, n_cons_diag, lam0[0])
    lam_full = lam0[1][:3]

    if off_active:
        zall = jnp.concatenate([zd.ravel(), zo])
        nd = zd.size

        def full_lc(z):
            lengths = _sigmoid_to_bounds(z[:nd].reshape(zd.shape), dlb, dub)
            off_flat = _sigmoid_to_bounds(z[nd:], olb, oub)
            avgs = _raw_averages(lengths, off_flat, data, with_off=True)
            cons = (avgs - targets) / cons_scale
            return _diag_loss(lengths, data) + _off_loss(off_flat, data), cons

        zall, lam_full = al_minimize(zall, full_lc, 3, lam0[1])
        zd = zall[:nd].reshape(zd.shape)
        zo = zall[nd:]

    diag_lengths = _sigmoid_to_bounds(zd, dlb, dub)
    off_flat = _sigmoid_to_bounds(zo, olb, oub)
    error = _diag_loss(diag_lengths, data) + (_off_loss(off_flat, data) if off_active else 0.0)
    avgs = _raw_averages(diag_lengths, off_flat, data, with_off=off_active)
    lam_out = jnp.stack([
        jnp.concatenate([lam_diag, jnp.zeros(3 - n_cons_diag, dtype=lam_diag.dtype)]),
        lam_full,
    ])
    return diag_lengths, off_flat, error, avgs, lam_out


def _halton(n: int, d: int) -> np.ndarray:
    """First ``n`` points of the ``d``-dimensional Halton sequence in (0,1)."""
    all_primes = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    if d > len(all_primes):
        raise ValueError(f"_halton supports d <= {len(all_primes)}, got {d}")
    primes = all_primes[:d]
    out = np.empty((n, d))
    for j, b in enumerate(primes):
        for i in range(1, n + 1):
            f, x, k = 1.0, 0.0, i
            while k > 0:
                f /= b
                x += f * (k % b)
                k //= b
            out[i - 1, j] = x
    return out


@jax.jit
def _global_candidates(data):
    """Deterministic low-discrepancy log-space sweep for the global stage.

    Counterpart of the reference's systematic DIRECT_L global search
    (opt.cpp:1349-1383): GLOBAL_STARTS Halton points stratify the log-bounds
    box far more evenly than the independent uniform draws they replace, and
    the sweep is reproducible run to run.  Returns the candidate diag lengths
    with the smallest unconstrained loss; the constrained local stage then
    polishes from there (like DIRECT_L -> MMA in the reference ladder)."""
    shape = data["dlb"].shape
    u = jnp.asarray(_halton(GLOBAL_STARTS, int(np.prod(shape))).reshape(
        (GLOBAL_STARTS,) + tuple(shape)))

    def sample_loss(ui):
        lengths = data["dlb"] * (data["dub"] / data["dlb"]) ** ui
        return _diag_loss(lengths, data), lengths

    losses, lengths = jax.lax.map(sample_loss, u)
    best = jnp.argmin(losses)
    return lengths[best]


@jax.jit
def _global_candidates_off(data):
    """Halton sweep of the OFF-DIAGONAL element's full parameter box.

    The reference's global stage searches every element's own bounds
    (opt.cpp:372-384), not just the diagonal lengths; this is its complex-
    kernel counterpart.  Magnitudes and lengths stratify in log space, the
    Re-Im correlation linearly (its box may be zero-width under
    reference_parity, where lb = ub = 1 collapses the axis).  Returns the
    candidate off-parameter vector with the smallest unconstrained loss."""
    olb, oub = data["olb"], data["oub"]
    d = olb.shape[0]
    u = jnp.asarray(_halton(GLOBAL_STARTS, int(d)))
    # log-stratify all strictly-positive axes; the final axis (corr) is linear
    log_axes = jnp.arange(d) < d - 1
    safe_lb = jnp.where(log_axes, jnp.maximum(olb, 1e-30), olb)

    def decode(ui):
        logv = safe_lb * (oub / safe_lb) ** ui
        linv = olb + (oub - olb) * ui
        return jnp.where(log_axes, logv, linv)

    def sample_loss(ui):
        off = decode(ui)
        return _off_loss(off, data), off

    losses, offs = jax.lax.map(sample_loss, u)
    best = jnp.argmin(losses)
    return offs[best]


@jax.jit
def _analytic_magnitudes(diag_lengths, off_flat, data):
    states = _diag_states(diag_lengths, data)
    mags = jax.vmap(RK.optimal_magnitude)(states)
    off_mag = CK.optimal_magnitude_complex(_off_state(off_flat, data))
    return mags, off_mag


@partial(jax.jit, static_argnums=(3,))
def _fit_once_diagnostics(diag_lengths, off_flat, data, block_diag: bool = False):
    """ONE fit of every element -> (log error, analytic magnitudes).

    The moment optimizer needs both the run.log error diagnostic and the
    analytic magnitudes; deriving them from the same fitted states halves
    the closed-form reoptimization's O(N^3) cost (the fits are the whole
    cost -- there is no search).  ``block_diag``: the moment optimizer's
    corr = 0 invariant splits the complex fit into two (N, N) blocks."""
    dstates = _diag_states(diag_lengths, data)
    ostate = _off_state(off_flat, data, block_diag)
    err = _diag_loss_from_states(dstates, data) + _off_loss_from_state(ostate, data)
    mags = jax.vmap(RK.optimal_magnitude)(dstates)
    off_mag = CK.optimal_magnitude_complex(ostate)
    return err, mags, off_mag


class OptResult(NamedTuple):
    error: float
    steps: list
    opt_type: str


@dataclasses.dataclass
class Optimizer:
    """Targets, parameter state, and the restart ladder
    (reference class Optimization, opt.h:17-105)."""

    model: str
    mass: float
    total_energy: float
    purity: float
    sigma_r0: np.ndarray                  # initial characteristic-length guess
    diag_lengths: np.ndarray = None       # (2, PhaseDim)
    off_params: np.ndarray = None         # (7,): m_R, l_R(2), m_I, l_I(2), corr
    diag_magnitudes: np.ndarray = None    # (2,) analytic magnitudes
    off_magnitude: float = 1.0
    lbfgs_steps: int = LBFGS_STEPS
    #: (lb, ub) of the learnable Re-Im correlation rho; pin lb = ub = 1.0 to
    #: hard-wire the reference kernel (complex_kernel.h:12-13) -- the
    #: sigmoid-bounds transform collapses a zero-width box to its value, the
    #: same mechanism the reference uses for magnitude/noise (opt.cpp:25-27)
    corr_bounds: tuple = (-CORR_BOUND, CORR_BOUND)
    #: "cpu" pins the whole ladder to the host (reference-style, fast zoom
    #: linesearch); "default" runs it on the session backend (GPU: scan-based
    #: fixed-fan linesearch, one long first compile)
    device: str = "cpu"
    #: "ladder" runs the reference-style constrained restart ladder
    #: (opt.cpp:1019-1392); "moment" sets moment-based hyperparameters
    #: directly (lengths = |label|-weighted cloud std / 2, corr = 0, analytic
    #: magnitudes) with no iterative search.  Measured on Tully SAC: equal
    #: full-trajectory accuracy at 5.3x less wall (RMSE 0.0385 @ 1038 s vs
    #: 0.0390 @ 5501 s, x0=-4 N=256, benchmarks/parity.py) and half the RMSE
    #: on the 240-tick crossing segment (0.0188 vs 0.0355 at N=64,
    #: benchmarks/moment_opt_ab.py) -- the conservation constraints pin GP
    #: *totals* but distort the lengthscales that control the fit the
    #: evolution actually reads.
    opt_mode: str = "moment"
    #: moment-mode COHERENCE lengthscale divisor: off lengths = |label|-
    #: weighted cloud std / off_len_div.  The diagonal fields are smooth
    #: (std/2 is essentially exact at any N) but the coherence develops
    #: fringes; resolving them needs BOTH a denser cloud and proportionally
    #: shorter lengths.  Measured on the carried-label decomposition channel
    #: (SAC crossing, 240 ticks, benchmarks/decompose.py, 2026-08-18):
    #: n=64/div 2: 0.0514; n=256/div 2: 0.0346; n=256/div 6: **0.0130** --
    #: at the ideal-label bound (0.0122).  Neither lever works alone
    #: (length scans at n=64 were a measured dead end).  Default 2 preserves
    #: the round-2 behavior; raise together with the coherence point budget
    #: (GPLEConfig.coh_fit_extra).
    off_len_div: float = 2.0
    #: moment-mode coherence boost: include the first ``coh_fit_extra``
    #: off-diagonal EXTRA points in the moment statistics, matching the
    #: boosted fit (GPLEConfig.coh_fit_extra / storage.fit_gp_states)
    coh_fit_extra: int = 0

    def __post_init__(self):
        self.sigma_r0 = np.asarray(self.sigma_r0, dtype=np.float64)
        if self.diag_lengths is None:
            self.diag_lengths = np.tile(self.sigma_r0, (2, 1))
        if self.off_params is None:
            self.off_params = self._initial_off()
        elif np.asarray(self.off_params).shape[0] == 2 * len(self.sigma_r0) + 2:
            # legacy (pre-corr) parameter vector, e.g. from an old checkpoint:
            # corr = 1 reproduces the reference kernel those params were fit with
            self.off_params = np.concatenate([np.asarray(self.off_params), [1.0]])
        if self.diag_magnitudes is None:
            self.diag_magnitudes = np.ones(2)
        self._tick = 0
        #: (2, 3) warm-start AL multipliers (diag pass, full pass) from the
        #: previously ACCEPTED stage; None until the first reopt completes
        self._al_lam = None

    def _initial_off(self):
        # corr starts at 0 (independent Re/Im): the coherence is a quadrature
        # field, and 0 is the neutral point of the [-1, 1] range
        return np.concatenate(
            [[INITIAL_MAGNITUDE], self.sigma_r0, [INITIAL_MAGNITUDE], self.sigma_r0,
             [0.0]]
        )

    # -- bounds from the point cloud (opt.cpp:1026-1052) ---------------------------
    @staticmethod
    def length_bounds(points):
        n = points.shape[0]
        mean = np.mean(points, axis=0)
        std = np.sqrt(np.maximum(np.mean(points**2, axis=0) - mean**2, 0.0))
        std = np.maximum(std, MIN_CHAR_LENGTH)
        return np.maximum(std / np.sqrt(n), MIN_CHAR_LENGTH), 2.0 * std

    def _pack_data(self, density: Density, extra: Density, surface_energies):
        active = np.asarray(density.active)
        diag_idx = jnp.asarray(list(DIAG_INDICES))
        dlb, dub = [], []
        for k in DIAG_INDICES:
            lb, ub = self.length_bounds(np.asarray(density.points[k]))
            dlb.append(lb)
            dub.append(ub)
        olb, oub = self.length_bounds(np.asarray(density.points[OFFDIAG_INDEX]))
        data = dict(
            dpts=density.points[diag_idx],
            drho=density.rho[diag_idx][..., 0],
            depts=extra.points[diag_idx],
            derho=extra.rho[diag_idx][..., 0],
            opts=density.points[OFFDIAG_INDEX],
            orho=density.rho[OFFDIAG_INDEX],
            oepts=extra.points[OFFDIAG_INDEX],
            oerho=extra.rho[OFFDIAG_INDEX],
            dmask=jnp.asarray(active[list(DIAG_INDICES)], dtype=jnp.float64),
            omask=jnp.asarray(float(active[OFFDIAG_INDEX])),
            energies=jnp.asarray(surface_energies),
            dlb=jnp.asarray(np.stack(dlb)),
            dub=jnp.asarray(np.stack(dub)),
            olb=jnp.concatenate([jnp.asarray([COMPLEX_MAG_LB]), jnp.asarray(olb),
                                 jnp.asarray([COMPLEX_MAG_LB]), jnp.asarray(olb),
                                 jnp.asarray([self.corr_bounds[0]])]),
            oub=jnp.concatenate([jnp.asarray([COMPLEX_MAG_UB]), jnp.asarray(oub),
                                 jnp.asarray([COMPLEX_MAG_UB]), jnp.asarray(oub),
                                 jnp.asarray([self.corr_bounds[1]])]),
            targets=jnp.asarray([1.0, self.total_energy, self.purity]),
        )
        return data, bool(active[OFFDIAG_INDEX])

    # -- the main entry (reference Optimization::optimize, opt.cpp:1019) -----------
    def optimize(self, density: Density, extra: Density, surface_energies) -> OptResult:
        """Runs on the host CPU by default (``device="cpu"``), where the
        reference runs NLopt too: the point sets are tiny and the zoom
        linesearch is cheap in-process.  ``device="default"`` keeps the data
        where it is and uses the scan-based fixed-fan L-BFGS, which has no
        data-dependent control flow."""
        cpu_devices = jax.local_devices(backend="cpu")
        if self.device == "cpu" and cpu_devices and jax.default_backend() != "cpu":
            with jax.default_device(cpu_devices[0]):
                density = jax.device_put(density, cpu_devices[0])
                extra = jax.device_put(extra, cpu_devices[0])
                surface_energies = jax.device_put(
                    jnp.asarray(surface_energies), cpu_devices[0]
                )
                return self._optimize_impl(density, extra, surface_energies)
        return self._optimize_impl(density, extra, jnp.asarray(surface_energies))

    def _optimize_impl(self, density: Density, extra: Density, surface_energies) -> OptResult:
        data, off_active = self._pack_data(density, extra, surface_energies)
        self._tick += 1
        if self.opt_mode == "moment":
            k = min(int(self.coh_fit_extra), extra.points.shape[1])
            off_extra = (
                (extra.points[OFFDIAG_INDEX, :k], extra.rho[OFFDIAG_INDEX, :k])
                if k > 0 else None
            )
            return self._moment_impl(density, data, off_extra)

        def run(start_diag, start_off, tag):
            # the warm stage reuses the previous reopt's converged Lagrange
            # multipliers and spends half the outer AL updates; cold restarts
            # re-derive them from zero with the full schedule
            warm = tag == "local_previous" and self._al_lam is not None
            lam0 = jnp.asarray(self._al_lam if warm else np.zeros((2, 3)))
            dl, of, err, avgs, lam = _run_stage(
                jnp.asarray(start_diag), jnp.asarray(start_off), lam0, data,
                off_active, self.lbfgs_steps, AL_OUTER // 2 if warm else AL_OUTER,
            )
            check = self._check_averages(np.asarray(avgs), off_active)
            return dict(
                diag_lengths=np.asarray(dl), off_params=np.asarray(of),
                error=float(err), check=check, tag=tag, lam=np.asarray(lam),
            )

        # clip starts into the current bounds (move_into_bounds, opt.cpp:1054-1067)
        def clipped(diag, off):
            d = np.clip(diag, np.asarray(data["dlb"]), np.asarray(data["dub"]))
            o = np.clip(off, np.asarray(data["olb"]), np.asarray(data["oub"]))
            return d, o

        res = run(*clipped(self.diag_lengths, self.off_params), "local_previous")
        if self._accepts(res):
            return self._finish(res, data)
        init_diag = np.tile(self.sigma_r0, (2, 1))
        res2 = run(*clipped(init_diag, self._initial_off()), "local_initial")
        res = self._compare(res, res2)
        if self._accepts(res):
            return self._finish(res, data)
        gdiag = np.asarray(_global_candidates(data))
        if off_active:
            goff = np.asarray(_global_candidates_off(data))
        else:
            goff = np.concatenate([[1.0], gdiag[0], [1.0], gdiag[0], [0.0]])
        res3 = run(*clipped(gdiag, goff), "global")
        res = self._compare(res, res3)
        return self._finish(res, data)

    # -- moment-based hyperparameters (opt_mode="moment") ---------------------------
    @staticmethod
    def _weighted_std(points, weights):
        """|weight|-weighted per-axis standard deviation of a point cloud."""
        w = np.maximum(np.abs(np.asarray(weights)), 1e-30)
        pts = np.asarray(points)
        mu = (pts * w[:, None]).sum(0) / w.sum()
        var = (((pts - mu) ** 2) * w[:, None]).sum(0) / w.sum()
        return np.sqrt(np.maximum(var, MIN_CHAR_LENGTH**2))

    def _moment_impl(self, density: Density, data, off_extra=None) -> OptResult:
        """Moment-based hyperparameters: no search, no constraints.

        Lengthscales are the |label|-weighted cloud std / 2 per axis (the
        scale over which the density actually varies), Re/Im treated
        independently (corr = 0), magnitudes analytic.  Beats the constrained
        ladder on measured crossing accuracy (see class docstring) because it
        tracks the *shape* each reoptimization instead of trading shape
        fidelity for integral constraints the MC estimator satisfies anyway."""
        pts = np.asarray(density.points)
        rho = np.asarray(density.rho)
        active = np.asarray(density.active)
        diag = np.array(self.diag_lengths, dtype=np.float64)
        for d, k in enumerate(DIAG_INDICES):
            if active[k]:
                diag[d] = self._weighted_std(pts[k], rho[k, :, 0]) / 2.0
        off = np.asarray(self._initial_off())
        if active[OFFDIAG_INDEX]:
            o, orho = pts[OFFDIAG_INDEX], rho[OFFDIAG_INDEX]
            if off_extra is not None:
                o = np.concatenate([o, np.asarray(off_extra[0])], axis=0)
                orho = np.concatenate([orho, np.asarray(off_extra[1])], axis=0)
            lr = self._weighted_std(o, orho[:, 0]) / self.off_len_div
            li = self._weighted_std(o, orho[:, 1]) / self.off_len_div
            mr = float(np.sqrt(np.mean(orho[:, 0] ** 2)) + 1e-30)
            mi = float(np.sqrt(np.mean(orho[:, 1] ** 2)) + 1e-30)
            off = np.concatenate([[mr], lr, [mi], li, [0.0]])
        else:
            off = np.asarray(self.off_params)
        err, mags, off_mag = _fit_once_diagnostics(
            jnp.asarray(diag), jnp.asarray(off), data,
            float(off[-1]) == 0.0,
        )
        res = dict(
            diag_lengths=diag, off_params=off, error=float(err), tag="moment",
            mags=mags, off_mag=off_mag,
            lam=self._al_lam if self._al_lam is not None else np.zeros((2, 3)),
        )
        return self._finish(res, data)

    def _check_averages(self, avgs, off_active) -> np.ndarray:
        targets = np.asarray([1.0, self.total_energy, self.purity])
        rel = np.abs(avgs / targets - 1.0)
        return np.where(rel < AVERAGE_TOLERANCE, 0.0, rel)

    @staticmethod
    def _accepts(res) -> bool:
        return bool(np.all(res["check"] == 0.0))

    @staticmethod
    def _compare(old, new) -> dict:
        """compare_and_overwrite (opt.cpp:1272-1318)."""
        c_old, c_new = old["check"], new["check"]
        better = int(np.sum((c_new < c_old) & (c_old > 2 * AVERAGE_TOLERANCE)))
        worse = int(np.sum((c_new > c_old) & (c_new > 2 * AVERAGE_TOLERANCE)))
        if better > worse or (better == worse and c_new.sum() < c_old.sum()):
            return new
        if better == worse and new["error"] < old["error"]:
            return new
        return old

    def _finish(self, res, data) -> OptResult:
        self.diag_lengths = res["diag_lengths"]
        self.off_params = res["off_params"]
        self._al_lam = res["lam"]
        if "mags" in res:  # already fitted once (moment path) -- don't refit
            mags, off_mag = res["mags"], res["off_mag"]
        else:
            mags, off_mag = _analytic_magnitudes(
                jnp.asarray(self.diag_lengths), jnp.asarray(self.off_params), data
            )
        dmask = np.asarray(data["dmask"]) > 0
        self.diag_magnitudes = np.where(dmask, np.asarray(mags), 1.0)
        self.off_magnitude = float(off_mag) if float(data["omask"]) > 0 else 1.0
        return OptResult(error=res["error"], steps=[self.lbfgs_steps], opt_type=res["tag"])

    # -- fitted parameters ----------------------------------------------------------
    def fitted_params(self):
        """(diag KernelParams with analytic magnitudes, ComplexKernelParams).

        Every scalar gets an EXPLICIT dtype: a python-float leaf is weak-typed,
        and a weak/strong mismatch against the in-graph reopt's strongly-typed
        params re-traces and re-compiles every consumer of these pytrees --
        measured as duplicate persistent-cache entries for
        _ticks_scan/_ticks_scan_fused."""
        f64 = jnp.asarray(self.diag_lengths).dtype
        diag = RK.KernelParams(
            magnitude=jnp.asarray(self.diag_magnitudes, dtype=f64),
            lengths=jnp.asarray(self.diag_lengths, dtype=f64),
            noise=jnp.full(2, INITIAL_NOISE, dtype=f64),
        )
        off = jnp.asarray(self.off_params, dtype=f64)
        d = (off.shape[0] - 3) // 2
        off_p = CK.ComplexKernelParams(
            magnitude=jnp.asarray(self.off_magnitude, dtype=f64),
            real_magnitude=off[0],
            real_lengths=off[1 : 1 + d],
            imag_magnitude=off[1 + d],
            imag_lengths=off[2 + d : 2 + 2 * d],
            noise=jnp.asarray(INITIAL_NOISE, dtype=f64),
            corr=off[-1],
        )
        return diag, off_p
