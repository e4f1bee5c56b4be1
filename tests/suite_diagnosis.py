"""Why fig6, tab5, api and online no longer reproduce their committed files:
the readings and cell searches behind ROADMAP.md section 3 (a script, not
a test module).

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python tests/suite_diagnosis.py \\
        readings [--root DIR]
    JAX_PLATFORMS=cpu PYTHONPATH=src:. python tests/suite_diagnosis.py \\
        lanes fig6 9 nominal
    JAX_PLATFORMS=cpu PYTHONPATH=src:. python tests/suite_diagnosis.py \\
        lanes fig6 12 0.25
    JAX_PLATFORMS=cpu PYTHONPATH=src:. python tests/suite_diagnosis.py \\
        lanes tab5 7 nominal
    JAX_PLATFORMS=cpu PYTHONPATH=src:. python tests/suite_diagnosis.py \\
        trajectory {32,64}

``readings``: the JAX package's suites from the committed starts (its
former PRNG), each held field the committed file misses, and each cell's
deployed tuning; ``--root`` reads another tree's JAX package and
benchmarks (a ``git archive`` of an older commit).  ``lanes``: every
distinct integral tuning the 128 lanes of one cell end on (the port's
float32 Adam from the committed starts), by exact cost, with what the
suite would read with it deployed: fig6 the cell's category averages,
tab5 the tree's ``engine_io`` over the four sessions.  ``trajectory``:
tab5's w7 nominal lanes through both packages' Adam in float32 or
float64, where and how fast their thetas part.
"""

import argparse
import json
import sys

import numpy as np


def readings(root):
    if root:
        sys.path[:0] = [f"{root}/src", root]
    import jax
    from benchmarks import (bench_api, bench_online_drift,
                            bench_robust_vs_nominal, bench_system_eval)
    from repro_torch.bench import run
    from repro_torch.api.report import Row
    for suite, bench in (("fig6", bench_robust_vs_nominal),
                         ("tab5", bench_system_eval), ("api", bench_api),
                         ("online", bench_online_drift)):
        reports = []
        real = bench.run_experiment

        def recorded(spec, *a, **kw):
            reports.append(real(spec, *a, **kw))
            return reports[-1]

        bench.run_experiment = recorded
        try:
            with jax.threefry_partitionable(False):
                rows = bench.run()
        finally:
            bench.run_experiment = real
        rows = [Row(r.name, 0.0, **r.derived) for r in rows]
        cmp = run.compare(rows, 0.0, run.load_baseline(suite, run.REPO_ROOT))
        print(f"{suite}: {len(cmp['held'])} held, missed:")
        for field, got, want in cmp["missed"]:
            print(f"  {field}: {got} (committed {want})")
        for report in reports[:1]:
            for cell in report.cells:
                r = report.tuning(cell)
                print(f"  cell {cell}: {r.design.value} "
                      f"{r.describe(report.sys)} raw T "
                      f"{float(np.asarray(r.raw_phi.T)):.4f} h "
                      f"{float(np.asarray(r.phi.mfilt_bits)):.6g} "
                      f"cost {float(r.cost):.5f}")


def _lane_ends(spec, widx_in_spec, rho):
    """The port's 128 lanes (64 committed starts x leveling, tiering) of
    one cell: raw and integral phis, exact costs, policies, the system."""
    import torch
    from repro_torch.api import compile_spec
    from repro_torch.bench import common
    from repro_torch.core import DesignSpace, batch, cost_vector, robust
    from repro_torch.core._opt import minimize_adam, minimize_adam_carry
    torch.set_num_threads(1)
    cx = compile_spec(spec)
    sys_ = cx.sys
    n = 64
    base = common.committed_starts(DesignSpace.CLASSIC, n, 0)
    base = torch.cat([base, base], dim=1)[0]
    pol = torch.cat([torch.zeros(n), torch.ones(n)])
    W = torch.tensor(np.asarray(cx.W[widx_in_spec], np.float32)).repeat(
        2 * n, 1)
    R = torch.full((2 * n,), float(rho or 0.0))

    def cvec(theta, smooth):
        return cost_vector(batch._phi_of(theta, pol, DesignSpace.CLASSIC,
                                         sys_, smooth), sys_, smooth=smooth)
    if rho:
        with torch.no_grad():
            _, llam0 = robust.dual_solve_cold(cvec(base, True), W, R)
        best, _, _ = minimize_adam_carry(
            lambda t, ll: robust.dual_solve_warm(cvec(t, True), W, R, ll),
            base, llam0, steps=250, lr=0.25)
    else:
        best, _ = minimize_adam(lambda t: (W * cvec(t, True)).sum(-1), base,
                                steps=250, lr=0.25)
    with torch.no_grad():
        raw = batch._phi_of(best, pol, DesignSpace.CLASSIC, sys_, False)
        phi = raw.round_integral(sys_)
        c = cost_vector(phi, sys_, smooth=False)
        exact = robust.robust_cost(c, W, R) if rho else (W * c).sum(-1)
    return cx, raw, phi, c.numpy().astype(np.float64), exact.numpy(), pol


def lanes(suite, widx, rho, top=7):
    from repro_torch.api import run_experiment
    from repro_torch.api.report import delta_tp
    from repro_torch.bench import common, fig6, tab5
    from repro_torch.core import WORKLOAD_CATEGORY
    spec = fig6.SPEC if suite == "fig6" else tab5.make_spec((widx,))
    i = widx if suite == "fig6" else 0
    cx, raw, phi, c, exact, pol = _lane_ends(spec, i, rho)
    seen = []
    for j in np.argsort(exact):
        key = (float(phi.T[j]), tuple(phi.K[j][:2].tolist()), int(pol[j]))
        if key not in [k for k, _ in seen]:
            seen.append((key, j))
        if len(seen) == top:
            break
    if suite == "fig6":
        report = run_experiment(spec, device="cpu",
                                starts=common.committed_starts)
        B = np.asarray(report.bench_set, np.float64)
        cat = WORKLOAD_CATEGORY[widx]
    else:
        from repro_torch.api import TrialPlan
        from repro_torch.api.backends import execute_trial
        from repro_torch.api.compile import TreeBuild
        tr = spec.trial
        plan = TrialPlan(
            trees=[TreeBuild(cell=(0, None), policy="klsm", policy_params=(),
                             T=float(phi.T[j]),
                             mfilt_bits=float(phi.mfilt_bits[j]),
                             K=tuple(float(k) for k in phi.K[j].tolist()),
                             key_group=0, key_seed=tr.key_seed + widx,
                             session_seeds=tuple(tr.key_seed + widx + s
                                                 for s in range(4)))
                   for _, j in seen],
            sessions=tr.sessions, n_keys=tr.n_keys, n_queries=tr.n_queries,
            key_space=tr.key_space, range_fraction=tr.range_fraction,
            entry_bytes=tr.entry_bytes, delete_fraction=tr.delete_fraction,
            f_a=tr.f_a, f_seq=tr.f_seq, zipf_a=tr.zipf_a,
            bits_per_entry=cx.sys.bits_per_entry, sys_N=cx.sys.N)
        trial = execute_trial(plan, device="cpu")[0]
    for n, (key, j) in enumerate(seen):
        head = (f"lane {j} {'tiering' if key[2] else 'leveling'} T {key[0]:g}"
                f" K {key[1]} h {float(phi.mfilt_bits[j]) / cx.sys.N:.4f}"
                f" b/e raw T {float(raw.T[j]):.4f} exact {exact[j]:.5f}")
        if suite == "fig6":
            avgs = {}
            for r in fig6.RHOS:
                vals = []
                for w in range(15):
                    if WORKLOAD_CATEGORY[w] != cat:
                        continue
                    cn = report.bench_costs[(w, None)]
                    cr = report.bench_costs[(w, r)]
                    if w == widx and rho is None:
                        cn = B @ c[j]
                    if w == widx and rho == r:
                        cr = B @ c[j]
                    vals.append(delta_tp(cn, cr).mean())
                avgs[r] = round(float(np.mean(vals)), 3)
            print(head, f"{cat} averages by rho {avgs}")
        else:
            print(head, "engine_io %.3f" % np.mean(
                [s.avg_io_per_query for s in trial[n]]))


def trajectory(bits):
    import jax
    import jax.numpy as jnp
    import torch
    if bits == 64:
        jax.config.update("jax_enable_x64", True)
    import repro.core as R
    import repro_torch.core as T
    from repro.core import _opt as ropt, batch as rbatch
    from repro.core.designs import random_inits
    from repro_torch.bench import tab5
    from repro_torch.core import _opt as topt, batch as tbatch
    torch.set_num_threads(1)
    pairs = dict(tab5.make_spec().system)
    rsys, tsys = R.LSMSystem(**pairs), T.LSMSystem(**pairs)
    with jax.threefry_partitionable(False):
        base = np.asarray(random_inits(jax.random.PRNGKey(0), 64,
                                       R.DesignSpace.CLASSIC, rsys),
                          np.float32)
    thetas = np.concatenate([base, base])
    pols = np.concatenate([np.zeros(64), np.ones(64)])
    w = np.asarray(R.EXPECTED_WORKLOADS[7])
    dt = np.float64 if bits == 64 else np.float32
    rec = []

    def run(theta0, pol, lane):
        def obj(theta):
            jax.debug.callback(lambda t, i: rec.append((int(i),
                                                        np.asarray(t))),
                               theta, lane)
            return R.expected_cost(jnp.asarray(w, theta.dtype),
                                   rbatch._phi_of(theta, pol,
                                                  R.DesignSpace.CLASSIC,
                                                  rsys, True),
                                   rsys, smooth=True)
        return ropt.minimize_adam(obj, theta0, steps=250, lr=0.25)[0]

    jax.jit(jax.vmap(run))(jnp.asarray(thetas, dt), jnp.asarray(pols, dt),
                           jnp.arange(128))
    traj_r = np.zeros((251, 128, 2))
    seen = np.zeros(128, int)
    for lane, t in rec:
        traj_r[seen[lane], lane] = t
        seen[lane] += 1
    tdt = torch.float64 if bits == 64 else torch.float32
    Wt = torch.tensor(np.repeat(w[None], 128, 0), dtype=tdt)
    pol = torch.tensor(pols, dtype=tdt)
    traj_t = []

    def obj_t(theta):
        traj_t.append(theta.detach().numpy().copy())
        c = T.cost_vector(tbatch._phi_of(theta, pol, T.DesignSpace.CLASSIC,
                                         tsys, True), tsys, smooth=True)
        return (Wt * c).sum(-1)

    topt.minimize_adam(obj_t, torch.tensor(thetas, dtype=tdt), steps=250,
                       lr=0.25)
    d = np.abs(np.stack(traj_t) - traj_r).max(axis=-1)
    print(json.dumps({"bits": bits, "max_gap_by_step": {
        s: float(d[s].max()) for s in (1, 2, 5, 10, 20, 30, 40, 50, 60,
                                       80, 100, 150, 250)},
        "start21_gap_by_step": {s: float(d[s, 21]) for s in
                                (1, 5, 10, 30, 50, 60, 100, 250)}}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("readings")
    r.add_argument("--root", default=None)
    ln = sub.add_parser("lanes")
    ln.add_argument("suite", choices=("fig6", "tab5"))
    ln.add_argument("widx", type=int)
    ln.add_argument("rho")
    tr = sub.add_parser("trajectory")
    tr.add_argument("bits", type=int, choices=(32, 64))
    args = ap.parse_args(argv)
    if args.cmd == "readings":
        readings(args.root)
    elif args.cmd == "lanes":
        lanes(args.suite, args.widx,
              None if args.rho == "nominal" else float(args.rho))
    else:
        trajectory(args.bits)


if __name__ == "__main__":
    main()
