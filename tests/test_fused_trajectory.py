"""Fused-segment trajectory scan must reproduce the boundary-chunked path.

``GPLEDriver._advance_fused`` folds whole reoptimization periods -- ticks,
scheduled moment reopts, extra-point regeneration, observables -- into one
``_ticks_scan_fused`` dispatch (driver.py), syncing with the host once per
segment.  It replaces the chunked host loop's blocking round-trips, so it
must take IDENTICAL physics
decisions: same RNG stream (pre-split keys), same reopt parameters, same
conservation-drift checks, same emitted records.  Mirrors the per-tick
control flow of the reference main program (main.cpp:135-202), which has a
single code path and no such equivalence to prove.
"""

import numpy as np
import pytest

from gple_tpu.config import GPLEConfig
from gple_tpu.driver import GPLEDriver


def _run(fused_chunk: int, max_ticks: int):
    cfg = GPLEConfig(
        model="DAC", mass=2000.0, x0=-10.0, p0=30.0, sigma_p0=1.5,
        output_time=1.0, reopt_time=1.0, dt=0.5, num_points=32,
        fused_chunk=fused_chunk,
    )
    drv = GPLEDriver(cfg)  # no writers: the fused path requires none
    hist = drv.run(max_ticks=max_ticks)
    return drv, hist


@pytest.fixture(scope="module")
def fused_pair():
    drv_c, hist_c = _run(fused_chunk=0, max_ticks=20)
    drv_f, hist_f = _run(fused_chunk=10, max_ticks=20)
    return drv_c, hist_c, drv_f, hist_f


def test_fused_path_taken(fused_pair):
    _, _, drv_f, _ = fused_pair
    assert drv_f.phase_times["fused"] > 0.0, (
        "config was expected to exercise _advance_fused; if eligibility "
        "rules changed, update this test's config"
    )


def test_fused_records_match_chunked(fused_pair):
    _, hist_c, _, hist_f = fused_pair
    assert len(hist_f) == len(hist_c)
    for rc, rf in zip(hist_c, hist_f):
        assert rf.time == rc.time
        assert rf.opt_type == rc.opt_type
        np.testing.assert_allclose(
            rf.population_mci, rc.population_mci, rtol=1e-6, atol=1e-9
        )
        assert rf.population_prm == pytest.approx(rc.population_prm, rel=1e-6)
        assert rf.energy_mci == pytest.approx(rc.energy_mci, rel=1e-6)
        assert rf.purity_prm == pytest.approx(rc.purity_prm, rel=1e-6)
        assert rf.x_average == pytest.approx(rc.x_average, rel=1e-6)


def test_fused_final_state_matches_chunked(fused_pair):
    drv_c, _, drv_f, _ = fused_pair
    np.testing.assert_allclose(
        np.asarray(drv_f.density.points), np.asarray(drv_c.density.points),
        rtol=1e-7, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(drv_f.density.rho), np.asarray(drv_c.density.rho),
        rtol=1e-6, atol=1e-12,
    )
    # the RNG keys must agree exactly -- the fused path pre-splits the same
    # stream the host loop would consume, so a later event replay resumes
    # identically
    assert np.array_equal(np.asarray(drv_f.key), np.asarray(drv_c.key))
    # optimizer state synced from the in-graph reopt matches the host reopt
    np.testing.assert_allclose(
        drv_f.optimizer.diag_lengths, drv_c.optimizer.diag_lengths, rtol=1e-7
    )
    np.testing.assert_allclose(
        drv_f.optimizer.off_params, drv_c.optimizer.off_params, rtol=1e-7
    )
