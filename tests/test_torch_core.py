"""The port's cost model and tuners (``repro_torch.core``) against the JAX
package's (``repro.core``), at small sizes on the CPU.

Inputs are made with numpy from a seed and fed to both.  The cost model
agrees to rel 1e-5.  The tuners are fed the same multi-starts (the JAX
package's ``random_inits_many``); 30 Adam steps of float32 trajectories
may drift apart slowly between XLA and torch, so parity is stated on the
re-scored exact cost (rel 1e-4), and the design and integral tuning must
match wherever LEVELING and TIERING differ by more than that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import lsm_cost as jcost
from repro.core.designs import random_inits_many as jax_random_inits_many
import repro_torch.core as T
from repro_torch.core import designs as tdesigns


def _phi_grid(seed=0, n=40):
    rng = np.random.default_rng(seed)
    Ts = rng.uniform(2.0, 100.0, n).astype(np.float32)
    Ts[:4] = [2.0, 3.0, 10.0, 100.0]
    mf = (rng.uniform(0.0, 9.9, n) * 1e10).astype(np.float32)
    Ks = rng.uniform(0.5, 99.0, (n, 24)).astype(np.float32)
    Ks[::3] = 1.0                                       # leveling rows
    return Ts, mf, Ks


@pytest.mark.parametrize("smooth", [False, True])
def test_cost_vector_matches_reference(smooth):
    Ts, mf, Ks = _phi_grid()
    sys_j, sys_t = R.LSMSystem(), T.LSMSystem()
    ref = np.stack([np.asarray(jcost.cost_vector(
        jcost.Phi(jnp.float32(t), jnp.float32(m), jnp.asarray(k)), sys_j,
        smooth=smooth)) for t, m, k in zip(Ts, mf, Ks)])
    got = T.cost_vector(T.Phi(torch.from_numpy(Ts), torch.from_numpy(mf),
                              torch.from_numpy(Ks)), sys_t,
                        smooth=smooth).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    w = np.array([0.33, 0.33, 0.33, 0.01], np.float32)
    phi_t = T.Phi(torch.tensor(Ts[5]), torch.tensor(mf[5]),
                  torch.from_numpy(Ks[5]))
    phi_j = jcost.Phi(jnp.float32(Ts[5]), jnp.float32(mf[5]),
                      jnp.asarray(Ks[5]))
    np.testing.assert_allclose(
        float(T.expected_cost(torch.from_numpy(w), phi_t, sys_t)),
        float(jcost.expected_cost(jnp.asarray(w), phi_j, sys_j)), rtol=1e-5)
    np.testing.assert_allclose(
        float(T.num_levels(phi_t.T, sys_t.m_total_bits - phi_t.mfilt_bits,
                           sys_t)),
        float(jcost.num_levels(phi_j.T, sys_j.m_total_bits
                               - phi_j.mfilt_bits, sys_j)))


@pytest.mark.parametrize("design", [d for d in R.DesignSpace
                                    if d is not R.DesignSpace.CLASSIC])
def test_to_phi_matches_reference(design):
    sys_j, sys_t = R.LSMSystem(), T.LSMSystem()
    p = R.designs.n_params(design, sys_j)
    theta = np.random.default_rng(1).uniform(-3, 3, (12, p)).astype(
        np.float32)
    got = T.to_phi(torch.from_numpy(theta), tdesigns.DesignSpace(design.value),
                   sys_t)
    for i in range(len(theta)):
        ref = R.to_phi(jnp.asarray(theta[i]), design, sys_j)
        np.testing.assert_allclose(float(got.T[i]), float(ref.T), rtol=1e-6)
        np.testing.assert_allclose(float(got.mfilt_bits[i]),
                                   float(ref.mfilt_bits), rtol=1e-6)
        np.testing.assert_allclose(got.K[i].numpy(), np.asarray(ref.K),
                                   rtol=1e-6)
        assert T.describe(T.Phi(got.T[i], got.mfilt_bits[i], got.K[i]),
                          sys_t) == R.describe(ref, sys_j)


def test_kl_divergence_and_rho_from_history():
    rng = np.random.default_rng(2)
    P = rng.dirichlet(np.ones(4), 30)
    P[0, 2] = 0.0                                   # 0 log 0 := 0
    Q = rng.dirichlet(np.ones(4), 30)
    np.testing.assert_allclose(T.kl_divergence(P, Q).numpy(),
                               np.asarray(R.kl_divergence(P, Q)), rtol=1e-6)
    for hist in (P[:3], P, rng.dirichlet(np.ones(4) * 0.3, 12)):
        assert T.rho_from_history(hist) == pytest.approx(
            R.rho_from_history(hist), rel=1e-6)
    assert T.rho_from_pair(P[1], P[2]) == pytest.approx(
        R.rho_from_pair(P[1], P[2]), rel=1e-6)


@pytest.mark.parametrize("rho", [0.0, 0.1, 0.5, 2.0, 30.0])
def test_worst_case_workload_matches_reference(rho):
    rng = np.random.default_rng(int(rho * 10))
    c = rng.gamma(2.0, 3.0, 4).astype(np.float32)
    w = rng.dirichlet(np.ones(4)).astype(np.float32)
    got = T.worst_case_workload(c, w, rho).numpy()
    ref = np.asarray(R.worst_case_workload(c, w, rho))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_worst_case_workload_flat_costs_is_an_intended_divergence():
    """Flat costs: the port returns ``w`` (its guard tests the raw span);
    the JAX package clamps the span to >= 1e-12 before testing it, so its
    guard never fires and it returns the tilt at tiny lambda, uniform
    here.  Recorded in ROADMAP.md queue 3."""
    c = np.full(4, 3.0, np.float32)
    w = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    np.testing.assert_allclose(T.worst_case_workload(c, w, 0.5).numpy(), w,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(R.worst_case_workload(c, w, 0.5)),
                               np.full(4, 0.25), rtol=1e-6)


def test_robust_cost_and_cold_solve_match_reference():
    rng = np.random.default_rng(4)
    C = rng.gamma(2.0, 3.0, (24, 4)).astype(np.float32)
    W = rng.dirichlet(np.ones(4), 24).astype(np.float32)
    rhos = np.tile(np.array([0.0, 0.05, 0.5, 3.0], np.float32), 6)
    got = T.robust_cost(torch.from_numpy(C), torch.from_numpy(W),
                        torch.from_numpy(rhos)).numpy()
    gv, gl = T.dual_solve_cold(torch.from_numpy(C), torch.from_numpy(W),
                               torch.from_numpy(rhos))
    args = (jnp.asarray(C), jnp.asarray(W), jnp.asarray(rhos))
    np.testing.assert_allclose(got, np.asarray(jax.vmap(R.robust_cost)(
        *args)), rtol=1e-5)
    rv, _ = jax.vmap(R.dual_solve_cold)(*args)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-5)
    # strong duality: the dual value is the primal worst case
    phi = T.make_phi(8.0, 4e10, 1.0, T.LSMSystem())
    w_hat, primal = T.primal_worst_case(phi, W[2], 0.5, T.LSMSystem())
    assert float(w_hat.sum()) == pytest.approx(1.0, rel=1e-6)
    dual = T.robust_cost(T.cost_vector(phi, T.LSMSystem()),
                         torch.from_numpy(W[2]), 0.5)
    assert float(primal) == pytest.approx(float(dual), rel=1e-4)


WORKLOADS = np.array([[0.33, 0.33, 0.33, 0.01],
                      [0.05, 0.10, 0.05, 0.80]], np.float32)
RHOS = [0.25, 1.0]


def _shared_starts(n_problems, n_starts=8):
    return np.asarray(jax_random_inits_many(
        jax.random.PRNGKey(0), n_problems, n_starts, R.DesignSpace.CLASSIC,
        R.LSMSystem()))


def _assert_tunings_agree(ref, got):
    """Exact cost to rel 1e-4; design and integral tuning where the
    problem is not a LEVELING/TIERING near-tie."""
    for a, b in zip(ref, got):
        assert b.cost == pytest.approx(a.cost, rel=1e-4)
        assert b.design.value == a.design.value
        assert float(b.phi.T) == float(a.phi.T)
        np.testing.assert_array_equal(b.phi.K.numpy(), np.asarray(a.phi.K))
        assert float(b.phi.mfilt_bits) == pytest.approx(
            float(a.phi.mfilt_bits), rel=1e-3)


def test_nominal_tuner_grid_matches_reference():
    ref = R.tune_nominal_many(WORKLOADS, R.LSMSystem(), n_starts=8,
                              steps=30)
    got = T.tune_nominal_many(WORKLOADS, T.LSMSystem(), n_starts=8,
                              steps=30, device="cpu",
                              starts=_shared_starts(2))
    _assert_tunings_agree(ref, got)


def test_robust_tuner_grid_matches_reference():
    ref = R.tune_robust_many(WORKLOADS, RHOS, R.LSMSystem(), n_starts=8,
                             steps=30)
    got = T.tune_robust_many(WORKLOADS, RHOS, T.LSMSystem(), n_starts=8,
                             steps=30, device="cpu",
                             starts=_shared_starts(4))
    _assert_tunings_agree(sum(ref, []), sum(got, []))
    # the winner's reported cost is the cold re-score of its integral phi
    r = got[1][1]
    c = T.cost_vector(r.phi, T.LSMSystem())
    assert float(T.robust_cost(c, torch.from_numpy(WORKLOADS[1]), RHOS[1])) \
        == pytest.approx(r.cost, rel=1e-6)


def test_tuner_draws_its_own_starts_from_a_generator():
    a = T.tune_nominal(WORKLOADS[0], T.LSMSystem(), n_starts=4, steps=5,
                       seed=3, device="cpu")
    b = T.tune_nominal(WORKLOADS[0], T.LSMSystem(), n_starts=4, steps=5,
                       seed=3, device="cpu")
    assert a.cost == b.cost and np.isfinite(a.cost)
    with pytest.raises(ValueError):
        T.tune_nominal_many(WORKLOADS, T.LSMSystem(), n_starts=4, steps=2,
                            device="cpu", starts=_shared_starts(2))
