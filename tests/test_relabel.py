"""Cloud re-selection relabeling as a first-class tested mechanism.

`GPLEDriver._track_clouds` re-walks a drifted element's points and relabels
them from the backward-branching predictor -- the reference's mid-run seeding
machinery (mc.cpp:407-537) applied on drift.  Round 3 isolated this relabel as
the booster divergence trigger (purity 5.9, diagonal populations
corrupted): a fresh Metropolis sample
does not reproduce the trajectory-ensemble normalization of the point-sum
estimators.  The reference survives the same event because its post-seeding
reoptimization pins population/purity as equality constraints
(opt.cpp:644-719 via main.cpp:145-163); the moment-mode equivalent is the
conservation-preserving relabel (GPLEConfig.relabel_conserve) tested here.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import gple_tpu.driver as drv_mod
from gple_tpu import observables as OBS
from gple_tpu.config import GPLEConfig
from gple_tpu.driver import GPLEDriver
from gple_tpu.storage import DIAG_INDICES, OFFDIAG_INDEX


def _sums(density):
    """(diag0 sum-Re, diag1 sum-Re, offdiag sum-|rho|^2) raw MC integrals."""
    rho = np.asarray(density.rho)
    return (
        float(rho[DIAG_INDICES[0], :, 0].sum()),
        float(rho[DIAG_INDICES[1], :, 0].sum()),
        float((rho[OFFDIAG_INDEX] ** 2).sum()),
    )


@pytest.fixture()
def crossing_driver():
    """A driver mid-crossing with an ACTIVE, fringed, boosted coherence."""
    cfg = GPLEConfig(
        model="SAC", mass=2000.0, x0=-2.0, p0=20.0, sigma_p0=1.0,
        output_time=2.0, reopt_time=2.0, dt=1.0, num_points=32,
        coh_fit_extra=32, coh_len_div=6.0, coh_boost_rescale=True,
        relabel_conserve=True,  # the booster config the flag is kept for
        seed=3,
    )
    drv = GPLEDriver(cfg)
    drv.initialize()
    # manufacture a mid-crossing state: both surfaces populated, coherence
    # carrying p-fringes (the div-6 surface whose relabel kills the booster)
    pts = np.array(drv.density.points)
    rho = np.array(drv.density.rho)
    rng = np.random.default_rng(0)
    for k in range(3):
        pts[k] = np.stack([
            rng.normal(0.0, 0.4, pts.shape[1]),
            rng.normal(20.0, 1.2, pts.shape[1]),
        ], axis=-1)
    env0 = np.exp(-0.5 * ((pts[0][:, 1] - 20.0) / 1.2) ** 2)
    env2 = np.exp(-0.5 * ((pts[2][:, 1] - 19.0) / 1.2) ** 2)
    rho[DIAG_INDICES[0], :, 0] = 0.10 * env0
    rho[DIAG_INDICES[0], :, 1] = 0.0
    rho[DIAG_INDICES[1], :, 0] = 0.04 * env2
    rho[DIAG_INDICES[1], :, 1] = 0.0
    fr = 4.0 * pts[OFFDIAG_INDEX][:, 1]  # ~4 rad per unit p: tight fringes
    envc = np.exp(-0.5 * ((pts[OFFDIAG_INDEX][:, 1] - 19.5) / 1.2) ** 2)
    rho[OFFDIAG_INDEX, :, 0] = 0.05 * envc * np.cos(fr)
    rho[OFFDIAG_INDEX, :, 1] = 0.05 * envc * np.sin(fr)
    drv.density = drv.density._replace(
        points=jnp.asarray(pts), rho=jnp.asarray(rho),
        active=jnp.asarray([True, True, True]),
    )
    e_pts = np.array(drv.extra.points)
    e_rho = np.array(drv.extra.rho)
    kk = drv._coh_k
    e_pts[OFFDIAG_INDEX, :kk] = pts[OFFDIAG_INDEX]
    e_rho[OFFDIAG_INDEX, :kk] = rho[OFFDIAG_INDEX]
    drv.extra = drv.extra._replace(
        points=jnp.asarray(e_pts), rho=jnp.asarray(e_rho),
        active=jnp.asarray([True, True, True]),
    )
    energies = OBS.total_energy_each_surface(cfg.model, drv.density, cfg.mass)
    drv.optimizer.optimize(drv.density, drv.extra, energies)
    drv.gps = drv._refit(drv.density)
    return drv


def _force_reselect(monkeypatch, flags):
    monkeypatch.setattr(
        drv_mod, "_cloud_drift_flags",
        lambda density: jnp.asarray(flags),
    )


def test_relabel_preserves_element_integrals(crossing_driver, monkeypatch):
    """A forced all-element re-selection must keep every element's raw MC
    integral continuous (diagonal sum-rho exactly, coherence sum-|rho|^2
    exactly, up to the scalar applied) -- red under the pre-fix relabel."""
    drv = crossing_driver
    pre = _sums(drv.density)
    _force_reselect(monkeypatch, [True, True, True])
    new_density = drv._track_clouds(drv.density)
    post = _sums(new_density)
    rejected = drv.stats.get("relabel_rejects", 0)
    rescaled = drv.stats.get("relabel_rescales", 0)
    assert rejected + rescaled == 3
    # every accepted relabel preserves its element's integral to float
    # precision; rejected ones keep the old points (trivially preserved)
    for a, b in zip(pre, post):
        assert b == pytest.approx(a, rel=1e-9)


def test_relabel_bounds_purity_jump(crossing_driver, monkeypatch):
    """The coherence's purity share is pinned EXACTLY (it is the booster
    feedback channel); the diagonals pin their population estimator instead,
    so the total purity may move a little -- but it must stay bounded, unlike
    the pre-fix relabel (purity 5.9 from ~1.0 in the round-3 run)."""
    drv = crossing_driver
    m_pre = np.asarray(OBS.purity_each_element(drv.density))
    _force_reselect(monkeypatch, [True, True, True])
    new_density = drv._track_clouds(drv.density)
    m_post = np.asarray(OBS.purity_each_element(new_density))
    # off-diagonal share exact (when the relabel was accepted; a reject
    # preserves it trivially)
    assert m_post[0, 1] == pytest.approx(m_pre[0, 1], rel=1e-9)
    # total purity continuous to well under the drift-trigger scale
    assert np.sum(m_post) == pytest.approx(np.sum(m_pre), rel=0.15)


def test_relabel_scale_band_and_sign_rules():
    cfg = GPLEConfig(model="SAC", num_points=8)
    drv = GPLEDriver(cfg)
    old_d = np.zeros((4, 2))
    old_d[:, 0] = 0.25
    new_d = np.zeros((4, 2))
    # exact factor recovered inside the band
    new_d[:, 0] = 0.5
    assert drv._relabel_scale(0, old_d, new_d) == pytest.approx(0.5)
    # out-of-band inflation -> rejected
    new_d[:, 0] = 10.0
    assert drv._relabel_scale(0, old_d, new_d) is None
    # sign flip -> rejected
    new_d[:, 0] = -0.25
    assert drv._relabel_scale(0, old_d, new_d) is None
    # off-diagonal: |rho|^2 continuity, phase structure untouched
    old_o = np.stack([np.full(4, 0.1), np.full(4, 0.1)], axis=-1)
    new_o = 2.0 * old_o
    assert drv._relabel_scale(OFFDIAG_INDEX, old_o, new_o) == pytest.approx(0.5)
    # zero relabel -> rejected, not a divide-by-zero
    assert drv._relabel_scale(OFFDIAG_INDEX, old_o, np.zeros((4, 2))) is None


def test_nascent_element_relabel_bypasses_the_band():
    """A nascent element (integral tiny vs the total diagonal population)
    must ACCEPT the predictor's fresh labels unscaled instead of rejecting:
    the conservation ratio is noise over noise and its field is growing
    (measured starvation: four straight (1, 1) rejections through the SAC
    transfer onset)."""
    cfg = GPLEConfig(model="SAC", num_points=8)
    drv = GPLEDriver(cfg)
    old_d = np.zeros((4, 2))
    old_d[:, 0] = 1e-4     # ppl ~ 1e-4 of the system total
    new_d = np.zeros((4, 2))
    new_d[:, 0] = 0.02     # predictor sees the grown field: ratio 1/200
    # without the reference scale: out of band -> rejected (legacy rule)
    assert drv._relabel_scale(0, old_d, new_d) is None
    # with it: nascent -> accepted unscaled
    assert drv._relabel_scale(0, old_d, new_d, nascent_ref=1.0) == 1.0
    assert drv.stats.get("relabel_nascent", 0) == 1
    # a HEALTHY element (integral at system scale) keeps the band
    old_d[:, 0] = 0.25
    assert drv._relabel_scale(0, old_d, new_d, nascent_ref=1.0) is None
    # nascent coherence: same bypass on the |rho| L1 scale
    old_o = np.full((4, 2), 1e-4)
    new_o = np.full((4, 2), 0.015)
    assert drv._relabel_scale(OFFDIAG_INDEX, old_o, new_o,
                              nascent_ref=1.0) == 1.0


def test_nascent_bypass_sanity_bounds():
    """The bypass trusts the predictor only within nascent SCALE: a relabel
    claiming a net-negative diagonal or a many-times-threshold integral is a
    corrupt query, not growth (the div-6 coh-cutoff probe's one-tick -2.8
    population jump)."""
    cfg = GPLEConfig(model="SAC", num_points=8, relabel_conserve=True)
    drv = GPLEDriver(cfg)
    old_d = np.zeros((4, 2))
    old_d[:, 0] = 1e-4        # nascent: pre far below 5% of ref
    # net-NEGATIVE relabel of a growing diagonal -> rejected
    neg = np.zeros((4, 2))
    neg[:, 0] = -0.7
    assert drv._relabel_scale(0, old_d, neg, nascent_ref=1.0) is None
    # far beyond the nascent band (> 2 x 5% of ref) -> rejected
    huge = np.zeros((4, 2))
    huge[:, 0] = 0.2          # sum 0.8 >> 0.1
    assert drv._relabel_scale(0, old_d, huge, nascent_ref=1.0) is None
    # coherence: L1 far beyond the band -> rejected
    old_o = np.full((4, 2), 1e-4)
    big_o = np.full((4, 2), 0.2)
    assert drv._relabel_scale(OFFDIAG_INDEX, old_o, big_o,
                              nascent_ref=1.0) is None
    assert drv.stats.get("relabel_nascent", 0) == 0


def test_resolved_coherence_is_not_nascent_at_production_n():
    """At production cloud sizes (N = 256) a RESOLVED coherence --
    per-point |rho| comparable to the diagonal mean -- must NOT classify as
    nascent.  The pre-fix rule compared an L2 norm (scales sqrt(N) * rms)
    against 5% of a linear point-sum (scales N * mean), so the threshold was
    cloud-size dependent: exactly this case slipped under it."""
    cfg = GPLEConfig(model="SAC", num_points=256, relabel_conserve=True)
    drv = GPLEDriver(cfg)
    n = 256
    # diagonals carry population 1.0 spread over N points
    nascent_ref = 1.0
    # resolved coherence: |rho| half the diagonal per-point mean
    amp = 0.5 * (nascent_ref / n)
    old_o = np.zeros((n, 2))
    old_o[:, 0] = amp * np.cos(np.linspace(0, 30, n))
    old_o[:, 1] = amp * np.sin(np.linspace(0, 30, n))
    # sanity: the legacy L2 rule WOULD have classified this nascent
    l2 = np.sqrt(np.sum(old_o**2))
    assert l2 < drv.RELABEL_NASCENT_FRAC * nascent_ref
    # a relabel doubling the purity share must be caught by the band (scale
    # 1/sqrt(2)), NOT accepted unscaled through the nascent bypass
    new_o = np.sqrt(2.0) * old_o
    s = drv._relabel_scale(OFFDIAG_INDEX, old_o, new_o, nascent_ref=nascent_ref)
    assert s == pytest.approx(1.0 / np.sqrt(2.0))
    assert drv.stats.get("relabel_nascent", 0) == 0
    # a genuinely tiny coherence still takes the bypass -- for growth that
    # stays within the 2x nascent band (a post integral far beyond it is a
    # corrupt query, test_nascent_bypass_sanity_bounds)
    s2 = drv._relabel_scale(OFFDIAG_INDEX, old_o * 1e-3, old_o * 0.05,
                            nascent_ref=nascent_ref)
    assert s2 == 1.0
    assert drv.stats.get("relabel_nascent", 0) == 1


def test_relabel_conserve_off_reproduces_legacy_jump(crossing_driver,
                                                     monkeypatch):
    """With the knob off, the relabeled integrals are whatever the predictor
    says (the legacy behavior whose jump was the divergence trigger)."""
    drv = crossing_driver
    object.__setattr__(drv.cfg, "relabel_conserve", False)
    pre = _sums(drv.density)
    _force_reselect(monkeypatch, [True, True, True])
    new_density = drv._track_clouds(drv.density)
    post = _sums(new_density)
    assert drv.stats.get("relabel_rescales", 0) == 0
    # the point of the fix: unconstrained relabels generally DO jump
    jumps = [abs(b / a - 1.0) for a, b in zip(pre, post) if a != 0.0]
    assert max(jumps) > 1e-6


def test_masked_diagonal_relabel(crossing_driver, monkeypatch):
    """relabel_mask_coh: diagonal relabel labels must be computed with the
    coherence contribution zeroed (differs from the unmasked labels when the
    coherence is hot)."""
    drv = crossing_driver
    _force_reselect(monkeypatch, [True, False, False])
    # unmasked run
    key_before = drv.key
    d_unmasked = drv._track_clouds(drv.density)
    # masked run from the SAME rng stream
    drv.key = key_before
    object.__setattr__(drv.cfg, "relabel_mask_coh", True)
    d_masked = drv._track_clouds(drv.density)
    assert not np.allclose(
        np.asarray(d_masked.rho[0]), np.asarray(d_unmasked.rho[0])
    )


def test_coh_fit_health_backoff_wiring(crossing_driver):
    """A purity integral above the health factor times the target must
    stickily halve the effective coherence lengthscale divisor (floor 2),
    then EJECT the booster if still detached (coh_fit_health_factor)."""
    drv = crossing_driver
    assert drv._coh_div_eff == 6.0
    assert drv._coh_k > 0
    # a tiny health factor makes ANY fit "unhealthy": the escalation must
    # walk 6 -> 3 -> 2, then eject the booster, then stop (nothing left)
    object.__setattr__(drv.cfg, "coh_fit_health_factor", 1e-9)
    drv._reoptimize(target_purity=1.0)
    assert drv._coh_div_eff == 2.0
    assert drv.stats.get("coh_len_backoffs", 0) == 2
    assert drv.optimizer.off_len_div == 2.0
    assert drv._coh_k == 0
    assert drv.optimizer.coh_fit_extra == 0
    assert drv.stats.get("coh_boost_ejected", 0) == 1


def test_coh_reselect_off_freezes_coherence_cloud(crossing_driver,
                                                  monkeypatch):
    """coh_reselect=False with a live booster: a forced all-element drift
    event re-walks the diagonals but must leave the coherence cloud (main +
    booster slots) bitwise untouched -- its points follow their own
    characteristics and its labels are carried (the decompose harness's
    stable no-reselection structure, docs/DESIGN.md round-3 reading)."""
    drv = crossing_driver
    object.__setattr__(drv.cfg, "coh_reselect", False)
    pre_pts = np.asarray(drv.density.points[OFFDIAG_INDEX]).copy()
    pre_rho = np.asarray(drv.density.rho[OFFDIAG_INDEX]).copy()
    pre_extra = np.asarray(drv.extra.rho[OFFDIAG_INDEX]).copy()
    _force_reselect(monkeypatch, [True, True, True])
    new_density = drv._track_clouds(drv.density)
    np.testing.assert_array_equal(
        np.asarray(new_density.points[OFFDIAG_INDEX]), pre_pts)
    np.testing.assert_array_equal(
        np.asarray(new_density.rho[OFFDIAG_INDEX]), pre_rho)
    np.testing.assert_array_equal(
        np.asarray(drv.extra.rho[OFFDIAG_INDEX]), pre_extra)
    # the diagonals DID move (reselected or conservatively rejected, but at
    # least one diagonal relabel event was processed)
    assert (drv.stats.get("relabel_rescales", 0)
            + drv.stats.get("relabel_rejects", 0)) >= 1
    # with the booster ejected the knob must stop applying: the coherence
    # re-walks like any element again
    drv._coh_k = 0
    drv.key = drv.key  # keep rng stream; just exercising the gate
    d2 = drv._track_clouds(new_density)
    assert (np.asarray(d2.points[OFFDIAG_INDEX]) != pre_pts).any()
