"""Coherence purity-conservation rescale (GPLEConfig.coh_boost_rescale).

One scalar per reoptimization shrinks all off-diagonal labels (main cloud +
carried booster slots) so the MC purity never exceeds the run's initial
purity -- the clamp on the carried-booster feedback loop, measured to
diverge on the CPU at N = 256 (GPLEConfig.coh_boost_rescale).  The move mirrors
the reference's conservation rescale for population+energy
(test/gpr.cpp:913-992).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gple_tpu import observables as OBS
from gple_tpu.config import GPLEConfig
from gple_tpu.driver import GPLEDriver, OFFDIAG_INDEX
from gple_tpu.utils.constants import purity_factor


@pytest.fixture()
def driver():
    # function-scoped: the inflation test mutates the driver, and under
    # reordered test execution a shared instance sitting exactly at the
    # purity budget can rescale by s marginally below 1.0 and break the
    # no-op test's exact-equality assertion
    cfg = GPLEConfig(
        model="SAC", mass=2000.0, x0=-2.0, p0=20.0, sigma_p0=1.0,
        output_time=2.0, reopt_time=2.0, dt=1.0, num_points=16,
        coh_fit_extra=16, coh_len_div=6.0, coh_boost_rescale=True,
    )
    drv = GPLEDriver(cfg)
    drv.initialize()
    return drv


def _total_purity(drv):
    pf = purity_factor(drv.cfg.dim) * drv.purity_ratio
    return float(np.sum(np.asarray(OBS.purity_each_element(drv.density)))) * pf


def test_noop_when_within_budget(driver):
    before = driver.density.rho.copy()
    s = driver._coh_purity_rescale()
    assert s == 1.0
    np.testing.assert_array_equal(np.asarray(driver.density.rho),
                                  np.asarray(before))


def test_inflated_coherence_is_clamped_back_to_initial_purity(driver):
    # activate the off-diagonal element with labels 10x too hot
    pts = driver.density.points[OFFDIAG_INDEX]
    amp = 2.0 * float(jnp.abs(driver.density.rho).max())
    hot = amp * jnp.exp(-0.05 * jnp.sum((pts - pts.mean(0)) ** 2, axis=-1))
    driver.density = driver.density._replace(
        rho=driver.density.rho.at[OFFDIAG_INDEX, :, 0].set(hot),
        active=jnp.asarray([True, True, True]),
    )
    driver.extra = driver.extra._replace(
        rho=driver.extra.rho.at[OFFDIAG_INDEX, :, 0].set(1.0),
        active=jnp.asarray([True, True, True]),
    )
    assert _total_purity(driver) > driver.purity  # precondition: blown up
    booster_before = np.asarray(
        driver.extra.rho[OFFDIAG_INDEX, : driver._coh_k]
    )
    diag_before = np.asarray(driver.density.rho)[[0, 2]]
    s = driver._coh_purity_rescale()
    assert 0.0 < s < 1.0
    # total purity restored to the initial budget
    assert _total_purity(driver) == pytest.approx(driver.purity, rel=1e-9)
    # diagonals untouched; booster slots scaled by the same factor
    np.testing.assert_array_equal(
        np.asarray(driver.density.rho)[[0, 2]], diag_before
    )
    np.testing.assert_allclose(
        np.asarray(driver.extra.rho[OFFDIAG_INDEX, : driver._coh_k]),
        booster_before * s, rtol=1e-12,
    )
    assert driver.stats["coh_rescales"] == 1


def test_rescale_forces_chunked_path():
    cfg = GPLEConfig(
        model="SAC", mass=2000.0, x0=-2.0, p0=20.0, sigma_p0=1.0,
        output_time=2.0, reopt_time=2.0, dt=1.0, num_points=16,
        fused_chunk=10, coh_boost_rescale=True,
    )
    # mirrors the use_fused condition in GPLEDriver.run: the in-graph fused
    # reopt has no rescale, so the flag must force the chunked path
    assert cfg.opt_mode == "moment" and cfg.fused_chunk > 0
    drv = GPLEDriver(cfg)
    hist = drv.run(max_ticks=6)
    assert drv.phase_times["fused"] == 0.0
    assert len(hist) > 0


def test_pop_rescale_pins_the_total_diagonal_sum(driver):
    """GPLEConfig.pop_rescale: inflated diagonal labels are rescaled back to
    the run's initial total population numerator at reoptimization (the
    reference's population equality constraint, opt.cpp:644-719, as a
    moment-mode scalar)."""
    from gple_tpu.storage import DIAG_INDICES

    di = jnp.asarray(DIAG_INDICES)
    ref = driver._pop_sum0
    assert ref > 0.0
    # inflate both diagonals by 30% (the measured div-6 failure inflated the
    # GP population integral to ~1.02 and MC purity to 1.3 by t=350)
    driver.density = driver.density._replace(
        rho=driver.density.rho.at[di, :, 0].multiply(1.3))
    s = driver._pop_conservation_rescale()
    assert s == pytest.approx(1.0 / 1.3, rel=1e-12)
    tot = float(jnp.sum(driver.density.rho[di][..., 0]))
    assert tot == pytest.approx(ref, rel=1e-12)
    assert driver.stats.get("pop_rescales", 0) == 1
    # a corrupt measurement (factor outside [0.5, 2]) is skipped, not applied
    driver.density = driver.density._replace(
        rho=driver.density.rho.at[di, :, 0].multiply(3.0))
    before = np.asarray(driver.density.rho).copy()
    assert driver._pop_conservation_rescale() == 1.0
    np.testing.assert_array_equal(np.asarray(driver.density.rho), before)
