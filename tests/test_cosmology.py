"""Cosmology unit tests with closed-form oracles (SURVEY.md section 4 item 2)."""

import math

import numpy as np
import pytest

from so_jax.cosmology import (CSM, EPSCOSMO, csm_comove_drift_fac,
                              csm_comove_kick_fac, csm_exp2hub, csm_exp2time,
                              csm_time2exp, csm_time2hub, omega_f,
                              rhovir_over_rhobar, rhovir_over_rhobar_jax,
                              threshold_in_box_units)
from so_jax.numerics import dromberg_o, romberg_jax


def test_delta_vir_omega1():
    # Omega=1 -> 178 exactly (so.c:72-74)
    assert rhovir_over_rhobar(1.0, False, 0.0) == 178.0
    assert rhovir_over_rhobar(1.0, True, 5.0) == 178.0


def test_omega_f_limits():
    assert omega_f(1.0, 0.0, 0.0) == 1.0
    # Omega(z) -> 1 at high z for any open cosmology
    assert abs(omega_f(0.3, 0.7, 50.0) - 1.0) < 0.01
    assert abs(omega_f(0.3, 0.0, 0.0) - 0.3) < 1e-12


def test_delta_vir_lambda_fit():
    # flat-Lambda fit: 18 pi^2 (1 + 0.4093 w^0.9052), w = 1/Omega(z) - 1
    om, z = 0.3, 0.0
    w = 1.0 / omega_f(om, 0.7, z) - 1.0
    want = 18 * math.pi ** 2 * (1 + 0.4093 * w ** 0.9052)
    assert rhovir_over_rhobar(om, True, z) == pytest.approx(want, rel=1e-14)
    # w -> 0 (high z): approaches 18 pi^2
    assert rhovir_over_rhobar(0.3, True, 100.0) == pytest.approx(
        18 * math.pi ** 2, rel=0.01)


def test_delta_vir_open_fit():
    # open-universe form approaches 178 as Omega -> 1
    assert rhovir_over_rhobar(0.999, False, 0.0) == pytest.approx(178.0, rel=0.01)
    # and grows as Omega decreases
    assert (rhovir_over_rhobar(0.2, False, 0.0)
            > rhovir_over_rhobar(0.5, False, 0.0) > 178.0)


def test_delta_vir_jax_matches_scalar():
    oms = np.array([0.2, 0.3, 0.7, 1.0])
    zs = np.array([0.0, 0.5, 2.0, 1.0])
    for lam in (False, True):
        got = np.asarray(rhovir_over_rhobar_jax(oms, lam, zs))
        want = [rhovir_over_rhobar(float(o), lam, float(z))
                for o, z in zip(oms, zs)]
        np.testing.assert_allclose(got, want, rtol=2e-6)


def test_threshold_rule():
    # auto: Delta_vir * Omega; user -delta: delta * Omega (so.c:477-481)
    assert threshold_in_box_units(1.0, False, 0.0) == 178.0
    assert threshold_in_box_units(0.3, True, 0.0, user_delta=200.0) == pytest.approx(60.0)


def test_romberg_polynomial():
    # exact for smooth integrands
    got = dromberg_o(lambda x: 3 * x * x, 0.0, 2.0, 1e-10)
    assert got == pytest.approx(8.0, rel=1e-9)
    got = dromberg_o(math.exp, 0.0, 1.0, 1e-10)
    assert got == pytest.approx(math.e - 1.0, rel=1e-9)


def test_romberg_jax_matches_host():
    import jax.numpy as jnp
    a = np.array([0.0, 0.5])
    b = np.array([2.0, 1.5])
    got = np.asarray(romberg_jax(lambda x: 3 * x * x, a, b, eps=1e-6))
    want = [dromberg_o(lambda x: 3 * x * x, float(aa), float(bb), 1e-10)
            for aa, bb in zip(a, b)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_exp2time_closed_forms():
    # Einstein-de Sitter: t(a) = 2/(3 H0) a^1.5 (cosmo.c:76-80)
    csm = CSM(dHubble0=2.0, dOmega0=1.0, bComove=True)
    assert csm_exp2time(csm, 1.0) == pytest.approx(2.0 / 6.0)
    assert csm_exp2time(csm, 0.0) == 0.0
    # empty universe: t = a/H0 (cosmo.c:104-108)
    csm = CSM(dHubble0=2.0, dOmega0=0.0, bComove=True)
    assert csm_exp2time(csm, 0.5) == pytest.approx(0.25)


def test_exp2time_romberg_branch_matches_closed_form_limit():
    # Lambda ~ 0 via the Romberg branch should approach the Lambda == 0
    # closed form (open universe)
    closed = CSM(dHubble0=1.0, dOmega0=0.3, bComove=True)
    romb = CSM(dHubble0=1.0, dOmega0=0.3, dLambda=1e-12, bComove=True)
    assert csm_exp2time(romb, 1.0) == pytest.approx(
        csm_exp2time(closed, 1.0), rel=1e-6)


def test_time2exp_roundtrip():
    for csm in (CSM(dHubble0=1.5, dOmega0=1.0, bComove=True),
                CSM(dHubble0=1.0, dOmega0=0.3, bComove=True),
                CSM(dHubble0=1.0, dOmega0=2.0, bComove=True),
                CSM(dHubble0=1.0, dOmega0=0.3, dLambda=0.7, bComove=True)):
        for a in (0.2, 0.7, 1.0):
            t = csm_exp2time(csm, a)
            assert csm_time2exp(csm, t) == pytest.approx(a, rel=1e-5)
    assert csm_time2exp(CSM(bComove=False), 123.0) == 1.0


def test_exp2hub_friedmann():
    csm = CSM(dHubble0=1.0, dOmega0=1.0, bComove=True)
    # EdS: H(a) = H0 a^-1.5
    assert csm_exp2hub(csm, 0.25) == pytest.approx(0.25 ** -1.5)
    csm = CSM(dHubble0=1.0, dOmega0=0.3, dLambda=0.7, bComove=True)
    assert csm_exp2hub(csm, 1.0) == pytest.approx(1.0)


def test_time2hub():
    csm = CSM(dHubble0=1.0, dOmega0=1.0, bComove=True)
    t1 = csm_exp2time(csm, 0.5)
    assert csm_time2hub(csm, t1) == pytest.approx(0.5 ** -1.5, rel=1e-5)


def test_drift_kick_closed_vs_romberg():
    """The Lambda=0 closed forms must agree with direct Romberg integration
    of the same integrands (validates both paths, cosmo.c:162-284)."""
    from so_jax.cosmology import _drift_int, _kick_int

    for om in (0.3, 2.0):
        csm = CSM(dHubble0=1.0, dOmega0=om, bComove=True)
        t1 = csm_exp2time(csm, 0.5)
        dt = csm_exp2time(csm, 0.8) - t1
        for fac, integ in ((csm_comove_drift_fac, _drift_int),
                           (csm_comove_kick_fac, _kick_int)):
            closed = fac(csm, t1, dt)
            direct = dromberg_o(lambda x: integ(csm, x),
                                1.0 / csm_time2exp(csm, t1),
                                1.0 / csm_time2exp(csm, t1 + dt), EPSCOSMO)
            assert closed == pytest.approx(direct, rel=1e-5)


def test_drift_kick_eds():
    # EdS closed forms (cosmo.c:172-174, 236-238)
    csm = CSM(dHubble0=1.0, dOmega0=1.0, bComove=True)
    t1 = csm_exp2time(csm, 0.25)
    dt = csm_exp2time(csm, 0.64) - t1
    assert csm_comove_drift_fac(csm, t1, dt) == pytest.approx(
        2.0 * (1 / 0.5 - 1 / 0.8), rel=1e-6)
    assert csm_comove_kick_fac(csm, t1, dt) == pytest.approx(
        2.0 * (0.8 - 0.5), rel=1e-6)
    assert csm_comove_drift_fac(CSM(bComove=False), 0.0, 0.125) == 0.125
