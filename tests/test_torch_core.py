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


# ---------------------------------------------------------------------------
# the unfused cost terms, the policy map, the metrics and rho_from_ranges
# ---------------------------------------------------------------------------

TERMS = ("level_fprs", "level_mask", "empty_read_cost", "nonempty_read_cost",
         "range_cost", "write_cost")


def _design_thetas(design, n=10, seed=7):
    """``n`` tunings of ``design`` as (port Phi batch, reference Phis)."""
    sys_j, sys_t = R.LSMSystem(), T.LSMSystem()
    dj = R.DesignSpace.LEVELING if design is R.DesignSpace.CLASSIC \
        else design
    p = R.designs.n_params(dj, sys_j)
    theta = np.random.default_rng(seed).uniform(-3, 3, (n, p)).astype(
        np.float32)
    if design is R.DesignSpace.CLASSIC:        # both folded branches
        pol = np.arange(n, dtype=np.float32) % 2
        got = T.to_phi_policy(torch.from_numpy(theta), torch.from_numpy(pol),
                              sys_t)
        refs = [R.to_phi_policy(jnp.asarray(t), jnp.float32(q), sys_j)
                for t, q in zip(theta, pol)]
    else:
        got = T.to_phi(torch.from_numpy(theta),
                       tdesigns.DesignSpace(design.value), sys_t)
        refs = [R.to_phi(jnp.asarray(t), design, sys_j) for t in theta]
    return got, refs


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("design", list(R.DesignSpace))
def test_unfused_cost_terms_match_reference_and_fused(design, smooth):
    """Each unfused term (rel 1e-5) against the JAX package's, and the four
    costs against the fused ``cost_vector``'s columns (rel 1e-5)."""
    from repro_torch.core import lsm_cost as tcost
    sys_j, sys_t = R.LSMSystem(), T.LSMSystem()
    got, refs = _design_thetas(design)
    for name in TERMS:
        fn = jax.jit(jax.vmap(lambda t, m, k, f=getattr(jcost, name):
                              f(jcost.Phi(t, m, k), sys_j, smooth=smooth)))
        ref = fn(jnp.stack([r.T for r in refs]),
                 jnp.stack([r.mfilt_bits for r in refs]),
                 jnp.stack([jnp.broadcast_to(r.K, (sys_j.max_levels,))
                            for r in refs]))
        np.testing.assert_allclose(
            getattr(tcost, name)(got, sys_t, smooth=smooth).numpy(),
            np.asarray(ref), rtol=1e-5, err_msg=name)
    fused = T.cost_vector(got, sys_t, smooth=smooth).numpy()
    for j, name in enumerate(TERMS[2:]):
        np.testing.assert_allclose(
            getattr(tcost, name)(got, sys_t, smooth=smooth).numpy(),
            fused[:, j], rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("smooth", [False, True])
def test_cost_across_memory_matches_reference(smooth):
    sys_j, sys_t = R.LSMSystem(), T.LSMSystem()
    budgets = np.array([2.0, 5.0, 10.0, 16.0, 40.0], np.float32)
    Ts, mf, Ks = _phi_grid(seed=3, n=6)
    for t, m, k in zip(Ts, mf, Ks):
        m = m / 10.0                     # a split the 2-bit budget can hold
        ref = jcost.cost_across_memory(
            jcost.Phi(jnp.float32(t), jnp.float32(m), jnp.asarray(k)),
            sys_j, jnp.asarray(budgets), smooth=smooth)
        got = T.cost_across_memory(
            T.Phi(torch.tensor(t), torch.tensor(m), torch.from_numpy(k)),
            sys_t, budgets, smooth=smooth)
        assert got.shape == (5, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("policy", R.ENGINE_POLICIES)
def test_policy_effective_phi_matches_reference(policy):
    assert T.ENGINE_POLICIES == R.ENGINE_POLICIES
    assert T.LAZY_LEVELING_FILL == R.LAZY_LEVELING_FILL
    sys_j, sys_t = R.LSMSystem(), T.LSMSystem()
    for t, m, k in zip(*_phi_grid(seed=5, n=4)):
        for params in ((), (("fill", 0.5),)):
            ref = R.policy_effective_phi(
                jcost.Phi(jnp.float32(t), jnp.float32(m), jnp.asarray(k)),
                sys_j, policy, params)
            got = T.policy_effective_phi(
                T.Phi(torch.tensor(t), torch.tensor(m), torch.from_numpy(k)),
                sys_t, policy, params)
            np.testing.assert_allclose(got.K.numpy(), np.asarray(ref.K),
                                       rtol=1e-6)
            assert float(got.T) == float(ref.T)
    with pytest.raises(ValueError, match="unknown engine policy"):
        T.policy_effective_phi(T.leveling_phi(10.0, 5e10, sys_t), sys_t,
                               "leveled")


def test_rho_from_ranges_matches_reference():
    lo, hi = [0.05, 0.1, 0.0, 0.2], [0.4, 0.5, 0.3, 0.6]
    for seed in (0, 3):
        assert T.rho_from_ranges(lo, hi, n_samples=512, seed=seed) \
            == pytest.approx(R.rho_from_ranges(lo, hi, n_samples=512,
                                               seed=seed), rel=1e-6)


def test_metrics_match_reference():
    sys_j, sys_t = R.LSMSystem(), T.LSMSystem()
    W = R.sample_benchmark(300, seed=2)
    pairs = [((8.0, 4e10, 1.0), (5.0, 6e10, 4.0)),
             ((20.0, 9e10, 3.0), (3.0, 2e10, 1.0))]
    for a, b in pairs:
        pj = [R.make_phi(*x, sys_j) for x in (a, b)]
        pt = [T.make_phi(*x, sys_t) for x in (a, b)]
        np.testing.assert_allclose(
            float(T.delta_throughput(W[0], *pt, sys_t)),
            float(R.delta_throughput(jnp.asarray(W[0], jnp.float32), *pj,
                                     sys_j)), rtol=1e-5)
        np.testing.assert_allclose(
            T.delta_throughput_batch(W, *pt, sys_t).numpy(),
            np.asarray(R.delta_throughput_batch(
                jnp.asarray(W, jnp.float32), *pj, sys_j)), rtol=1e-5,
            atol=1e-7)
        for p_t, p_j in zip(pt, pj):
            np.testing.assert_allclose(
                float(T.throughput_range(W, p_t, sys_t)),
                float(R.throughput_range(jnp.asarray(W, jnp.float32), p_j,
                                         sys_j)), rtol=1e-5)


# ---------------------------------------------------------------------------
# the SLSQP tuners
# ---------------------------------------------------------------------------

def _jax_slsqp_objective(w, design, rho=None):
    """The JAX package's SLSQP objective and gradient, as its tuners
    write them (``nominal.py:94``, ``robust.py:209``)."""
    from repro.core import robust as jrobust
    sys_j = R.LSMSystem()
    n = R.designs.n_params(design, sys_j)
    w = jnp.asarray(w, jnp.float32)

    def obj(x):
        phi = R.to_phi(x[:n], design, sys_j, smooth=True)
        if rho is None:
            return R.expected_cost(w, phi, sys_j, smooth=True)
        c = R.cost_vector(phi, sys_j, smooth=True)
        return jrobust.dual_objective_explicit(c, w, rho, jnp.exp(x[n]),
                                               x[n + 1])
    vag = jax.jit(jax.value_and_grad(obj))
    return lambda x: tuple(np.asarray(a, np.float64)
                           for a in vag(jnp.asarray(x, jnp.float32)))


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("design", [R.DesignSpace.LEVELING,
                                    R.DesignSpace.TIERING,
                                    R.DesignSpace.FLUID, R.DesignSpace.KLSM])
def test_slsqp_objective_and_starts_match_reference(monkeypatch, design,
                                                    robust):
    """What SciPy sees: the same numpy starts, and at each of them the same
    value and gradient (rel 1e-5; gradient entries to 1e-5 of the largest)
    as the JAX package's objective.  Where the value overflows, it does in
    both; where it exceeds 1e30 (the robust objective at lam = 1, far from
    its optimum), the two autograds' op orders may overflow different
    gradient entries, and the entries finite in both agree."""
    from repro_torch.core import nominal as tnominal
    from repro_torch.core import robust as trobust
    seen = []

    def capture(f, starts, bounds, maxiter):
        seen.append((f, [np.array(s) for s in starts], bounds, maxiter))
        return None                              # -> the Adam fallback

    mod = trobust if robust else tnominal
    monkeypatch.setattr(mod, "_slsqp_best", capture)
    monkeypatch.setattr(mod, "tune_robust" if robust else "tune_nominal",
                        lambda *a, **k: "adam")
    w = np.array([0.33, 0.33, 0.33, 0.01])
    d = tdesigns.DesignSpace(design.value)
    if robust:
        out = T.tune_robust_slsqp(w, 0.5, T.LSMSystem(), d, n_starts=3,
                                  seed=4, device="cpu")
    else:
        out = T.tune_nominal_slsqp(w, T.LSMSystem(), d, n_starts=3, seed=4,
                                   device="cpu")
    assert out == "adam"
    (f, starts, bounds, maxiter), = seen
    n = R.designs.n_params(design, R.LSMSystem())
    rng = np.random.default_rng(4)
    for s in starts:
        np.testing.assert_array_equal(s[:n], rng.uniform(-3, 3, n))
    from repro.core.nominal import _theta_bounds
    assert bounds[:n] == _theta_bounds(design, R.LSMSystem())
    assert maxiter == (300 if robust else 200)
    ref = _jax_slsqp_objective(w, design, 0.5 if robust else None)
    xs = starts + [np.clip(s + 0.7, -8, 8) for s in starts]
    for x in xs:
        (v, g), (rv, rg) = f(x), ref(x)
        if not np.isfinite(rv):          # exp overflowed in both packages
            assert v == rv
            continue
        assert v == pytest.approx(float(rv), rel=1e-5)
        ok = np.isfinite(rg) & np.isfinite(g)
        if abs(rv) < 1e30:   # float32 headroom: no entry overflows in either
            assert ok.all()
        np.testing.assert_allclose(g[ok], rg[ok], rtol=1e-5,
                                   atol=1e-5 * np.abs(rg[ok]).max())


@pytest.mark.parametrize("robust", [False, True])
def test_slsqp_tuners_match_reference(robust):
    """CLASSIC, 2 starts, seed 0, the quickstart's expected workload (rho
    1.0 robust, as fig10): the same design, cost to rel 1e-4.  The
    objective is flat near its optimum (here T 40 against 39 nominal, 37
    against 33 robust, at equal cost), and a 1-ulp gradient difference can
    send a start elsewhere: with 2 starts the packages differ by up to 1.7%
    nominal (w7) and 34% robust (w10 at rho 1.0), 0.9% at this workload and
    rho 0.5 (ROADMAP.md queue 3)."""
    w = np.array([0.33, 0.33, 0.33, 0.01])
    if robust:
        ref = R.tune_robust_slsqp(w, 1.0, R.LSMSystem(), n_starts=2, seed=0)
        got = T.tune_robust_slsqp(w, 1.0, T.LSMSystem(), n_starts=2, seed=0,
                                  device="cpu")
        assert got.cost == pytest.approx(float(T.robust_cost(
            T.cost_vector(got.phi, T.LSMSystem()), torch.tensor(w), 1.0)),
            rel=1e-6)
    else:
        ref = R.tune_nominal_slsqp(w, R.LSMSystem(), n_starts=2, seed=0)
        got = T.tune_nominal_slsqp(w, T.LSMSystem(), n_starts=2, seed=0,
                                   device="cpu")
    assert got.solver == ref.solver == "slsqp"
    assert got.design.value == ref.design.value
    assert got.cost == pytest.approx(ref.cost, rel=1e-4)


@pytest.mark.parametrize("robust", [False, True])
def test_slsqp_lets_objective_errors_through(monkeypatch, robust):
    """An error raised inside the objective (torch, the device) propagates;
    a start that SciPy itself fails is skipped, and when SciPy fails every
    start the Adam tuner answers."""
    import scipy.optimize
    from repro_torch.core import nominal as tnominal
    from repro_torch.core import robust as trobust
    w, d = np.array([0.33, 0.33, 0.33, 0.01]), T.DesignSpace.TIERING

    def tune(**kw):
        if robust:
            return T.tune_robust_slsqp(w, 0.5, T.LSMSystem(), d, n_starts=2,
                                       device="cpu", **kw)
        return T.tune_nominal_slsqp(w, T.LSMSystem(), d, n_starts=2,
                                    device="cpu", **kw)

    real = scipy.optimize.minimize
    calls = []

    def first_fails(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("SLSQP failed this start")
        return real(*a, **k)

    monkeypatch.setattr(scipy.optimize, "minimize", first_fails)
    assert tune().solver == "slsqp" and len(calls) == 2

    def always_fails(*a, **k):
        raise ValueError("SLSQP failed this start")

    monkeypatch.setattr(scipy.optimize, "minimize", always_fails)
    monkeypatch.setattr(trobust if robust else tnominal,
                        "tune_robust" if robust else "tune_nominal",
                        lambda *a, **k: "adam")
    assert tune() == "adam"

    monkeypatch.setattr(scipy.optimize, "minimize", real)

    def device_fault(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    if robust:
        monkeypatch.setattr(trobust, "dual_objective_explicit", device_fault)
    else:
        monkeypatch.setattr(tnominal, "expected_cost", device_fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tune()


def test_dual_objective_explicit_matches_reference():
    from repro.core import robust as jrobust
    rng = np.random.default_rng(6)
    C = rng.gamma(2.0, 3.0, (16, 4)).astype(np.float32)
    W = rng.dirichlet(np.ones(4), 16).astype(np.float32)
    lam = rng.uniform(0.1, 20.0, 16).astype(np.float32)
    eta = rng.uniform(-5.0, 20.0, 16).astype(np.float32)
    ref = jax.vmap(jrobust.dual_objective_explicit,
                   in_axes=(0, 0, None, 0, 0))(C, W, 0.7, lam, eta)
    got = T.robust.dual_objective_explicit(
        torch.from_numpy(C), torch.from_numpy(W), 0.7, torch.from_numpy(lam),
        torch.from_numpy(eta))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    phi = T.make_phi(8.0, 4e10, 1.0, T.LSMSystem())
    phi_j = R.make_phi(8.0, 4e10, 1.0, R.LSMSystem())
    assert float(T.robust.robust_phi_objective(
        phi, W[0], 0.5, T.LSMSystem())) == pytest.approx(float(
            jrobust.robust_phi_objective(phi_j, jnp.asarray(W[0]), 0.5,
                                         R.LSMSystem())), rel=1e-5)
