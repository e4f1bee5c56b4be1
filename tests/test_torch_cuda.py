"""The port's CUDA kernels, engine and LM serving on the card (marked
``cuda``).

Each kernel against its plain PyTorch version on the same CUDA tensors,
and the engine's and the reduced LM server's kernel paths against their
CPU plain paths from the same seed or weights.  These tests import neither
jax nor the JAX package, so they run on a machine with a card and no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card (or without ``nvcc``) they skip with the reason.
"""


import numpy as np
import pytest
import torch

import repro_torch.core as core
import repro_torch.lsm as P
from repro_torch.kernels import _build
from repro_torch.kernels.bloom_probe.ops import bloom_probe_kernel
from repro_torch.kernels.bloom_probe.ref import (build_plane, mix32,
                                                 probe_ref)
from repro_torch.kernels.dual_solve.ops import dual_solve_warm_batch
from repro_torch.configs import get_config
from repro_torch.kernels.dual_solve.ref import (dual_solve_warm_ref,
                                                envelope_grad)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.merge import ops as merge_ops
from repro_torch.kernels.merge.ops import merge_runs, two_way_merge
from repro_torch.kernels.point_read.ops import point_read_level
from repro_torch.kernels.rwkv6.ops import rwkv6
from repro_torch.kernels.rwkv6.ref import rwkv6_ref
from repro_torch.launch.serve import serve_batch
from repro_torch.lsm import store
from repro_torch.models import build_model
from repro_torch.utils import u64

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    try:
        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    _build.build()
    return torch.device("cuda")


def _u64_keys(rng, n):
    keys = np.unique(rng.integers(0, 2 ** 64 - 1, 2 * n + 16,
                                  dtype=np.uint64, endpoint=True))
    return np.sort(rng.choice(keys, n, replace=False))


@pytest.mark.parametrize("L,n", [(9600, 4), (1237, 4), (77, 9)])
def test_dual_solve_kernel_matches_plain(dev, L, n):
    rng = np.random.default_rng(L)
    C = torch.tensor(rng.gamma(2.0, 2.0, (L, n)), dtype=torch.float32,
                     device=dev)
    W = torch.tensor(rng.dirichlet(np.ones(n), L), dtype=torch.float32,
                     device=dev)
    rho = torch.tensor(rng.uniform(0, 3, L), dtype=torch.float32,
                       device=dev)
    rho[::5] = 0.0
    llam = torch.log(C.max(1).values - C.min(1).values)
    before = _build.LAUNCHES["dual_solve"]
    v1, l1 = dual_solve_warm_batch(C, W, rho, llam)
    assert _build.LAUNCHES["dual_solve"] == before + 1
    v2, l2 = dual_solve_warm_ref(C, W, rho, llam)
    assert ((v1 - v2).abs() / v2.abs()).max().item() <= 1e-5
    dl = (l1 - l2).abs()
    assert (dl <= 1e-5).float().mean().item() >= 0.99
    assert dl.max().item() <= 0.1


@pytest.mark.parametrize("n", [1, 4, 5, 16])
@pytest.mark.parametrize("L", [1, 127, 1237, 9600])
def test_dual_solve_groups_and_dc_match_plain(dev, L, n):
    """Both thread groups (4 threads for n <= 4, 16 above), lane counts
    that leave a block's last groups past L, one lane in five with rho = 0,
    and the envelope gradient ``dc``, against the plain version on the
    card: values rel 1e-5, log lambda within 1e-5 (bit for bit) on 99% of
    lanes, dc rel 1e-5 at the kernel's lambda (w itself where rho = 0)."""
    rng = np.random.default_rng(L * 31 + n)
    C = torch.tensor(rng.gamma(2.0, 2.0, (L, n)), dtype=torch.float32,
                     device=dev)
    W = torch.tensor(rng.dirichlet(np.ones(n), L), dtype=torch.float32,
                     device=dev)
    rho = torch.tensor(rng.uniform(0, 3, L), dtype=torch.float32,
                       device=dev)
    rho[::5] = 0.0
    llam = torch.tensor(rng.normal(1.0, 1.5, L), dtype=torch.float32,
                        device=dev)
    before = _build.LAUNCHES["dual_solve"]
    v1, l1, dc1 = dual_solve_warm_batch(C, W, rho, llam, grad=True)
    v0, l0 = dual_solve_warm_batch(C, W, rho, llam)
    assert _build.LAUNCHES["dual_solve"] == before + 2
    assert torch.equal(v0, v1) and torch.equal(l0, l1)
    v2, l2, dc2 = dual_solve_warm_ref(C, W, rho, llam, grad=True)
    assert ((v1 - v2).abs() / v2.abs()).max().item() <= 1e-5
    # a lane whose compare flips on a 1-ulp difference between the
    # kernel's expf and torch.exp lands in a neighbouring bracket: the
    # largest such move on these inputs is 0.12724 (L 9,600, n 4), the
    # same for the one-thread kernel this one replaced (chip_smoke.py
    # --dual-solve, ``test_cases``, on an H100); its value agrees
    dl = (l1 - l2).abs()
    assert (dl <= 1e-5).float().mean().item() >= (0.99 if L > 100 else 1.0)
    assert dl.max().item() <= 0.13
    # dc is the envelope gradient at the kernel's own lambda: the plain
    # formula there, and the plain version's dc wherever the two lambdas
    # agree (a flipped lane's gradient is taken at another lambda)
    assert dc1.shape == (L, n)
    torch.testing.assert_close(dc1, envelope_grad(C, W, rho, l1),
                               rtol=1e-5, atol=0)
    same = l1 == l2
    assert same.float().mean().item() >= (0.99 if L > 100 else 1.0)
    torch.testing.assert_close(dc1[same], dc2[same], rtol=1e-5, atol=0)
    assert torch.equal(dc1[rho == 0], W[rho == 0])


@pytest.mark.parametrize("n", [17, 33, 64])
@pytest.mark.parametrize("L", [1, 127, 1024, 9600])
def test_dual_solve_wide_lanes_match_plain(dev, L, n):
    """The large group with 4 components a thread (17 <= n <= 64; the
    kernels suite's 64 costs a lane) against the plain version: values
    rel 1e-5 on every lane, log lambda bit for bit on 99% of lanes and
    inside the scan's bracket (llam +- 0.8) on all, dc rel 1e-5 at the
    kernel's lambda and equal to the plain version's where the lambdas
    agree.  (The sum over 64 terms runs in index order in the kernel and
    pairwise in torch, so more compares flip than at n = 4.)"""
    rng = np.random.default_rng(L * 37 + n)
    C = torch.tensor(rng.gamma(2.0, 2.0, (L, n)), dtype=torch.float32,
                     device=dev)
    W = torch.tensor(rng.dirichlet(np.ones(n), L), dtype=torch.float32,
                     device=dev)
    rho = torch.tensor(rng.uniform(0, 3, L), dtype=torch.float32,
                       device=dev)
    rho[::5] = 0.0
    llam = torch.tensor(rng.normal(1.0, 1.5, L), dtype=torch.float32,
                        device=dev)
    v1, l1, dc1 = dual_solve_warm_batch(C, W, rho, llam, grad=True)
    v2, l2, dc2 = dual_solve_warm_ref(C, W, rho, llam, grad=True)
    assert ((v1 - v2).abs() / v2.abs()).max().item() <= 1e-5
    dl = (l1 - l2).abs()
    assert (dl <= 1e-5).float().mean().item() >= (0.99 if L > 100 else 1.0)
    lspan = torch.log(torch.clamp(C.max(1).values - C.min(1).values,
                                  min=1e-9))
    lo = torch.minimum(torch.maximum(llam - 0.8, lspan - 16.0), lspan + 16.0)
    hi = torch.minimum(torch.maximum(llam + 0.8, lspan - 16.0), lspan + 16.0)
    assert ((l1 >= lo - 1e-5) & (l1 <= hi + 1e-5)).all()
    torch.testing.assert_close(dc1, envelope_grad(C, W, rho, l1),
                               rtol=1e-5, atol=0)
    same = l1 == l2
    torch.testing.assert_close(dc1[same], dc2[same], rtol=1e-5, atol=0)
    assert torch.equal(dc1[rho == 0], W[rho == 0])


@pytest.mark.parametrize("na,nb", [(50_000, 70_000), (1, 0), (0, 3),
                                   (129, 1)])
def test_merge_kernel_matches_plain(dev, na, nb):
    rng = np.random.default_rng(na + nb)
    pool = _u64_keys(rng, int(1.5 * (na + nb)) + 4)
    a = np.sort(rng.choice(pool, na, replace=False))
    b = np.sort(rng.choice(pool, nb, replace=False))
    args = [u64.to_device_keys(a, dev), torch.arange(na, device=dev),
            u64.to_device_keys(b, dev), torch.arange(nb, device=dev) + 10**9]
    k, v = two_way_merge(*args)
    rk, rv = two_way_merge(*(t.cpu() for t in args))
    assert torch.equal(k.cpu(), rk) and torch.equal(v.cpu(), rv)
    k, v = merge_runs([args[0], args[2]], [args[1], args[3]])
    rk, rv = merge_runs([args[0].cpu(), args[2].cpu()],
                        [args[1].cpu(), args[3].cpu()])
    assert torch.equal(k.cpu(), rk) and torch.equal(v.cpu(), rv)


def _merge_step_runs(case, dev):
    """(A keys, A vals, B keys, B vals) on ``dev`` for the fold-step card
    tests: the four sizes of ``test_merge_kernel_matches_plain``, runs
    sharing most keys, a duplicate pair straddling every tile boundary
    (B holds one smaller key, then both runs hold the same even keys: A's
    copy of a key is output TILE - 1 of a tile, B's output TILE), runs of
    one key repeated, runs that are views one element into a buffer (at an
    8-byte offset: no 16-byte alignment), and runs of 1,024 tiles and more
    (where the partition probes 8 ways a boundary, not 32)."""
    rng = np.random.default_rng(len(case))
    tile = merge_ops._tile()
    if case == "misaligned":
        keys = u64.to_device_keys(_u64_keys(rng, 30_001), dev)
        vals = torch.arange(len(keys), device=dev)
        args = [keys[1:], vals[1:], keys[3::2].contiguous()[1:],
                vals[3::2].contiguous()[1:]]
        assert args[0].data_ptr() % 16 == 8 and args[2].data_ptr() % 16 == 8
        return args
    if isinstance(case, tuple):
        na, nb = case
        pool = _u64_keys(rng, int(1.5 * (na + nb)) + 4)
        a = np.sort(rng.choice(pool, na, replace=False))
        b = np.sort(rng.choice(pool, nb, replace=False))
    elif case == "shared":
        pool = _u64_keys(rng, 40_000)
        a, b = pool[::2], np.sort(np.concatenate([pool[::4], pool[1::6]]))
    elif case == "straddle":
        evens = np.arange(2, 2 * (3 * tile + 77), 2, dtype=np.uint64)
        a, b = evens, np.concatenate([[np.uint64(1)], evens])
    elif case == "repeated":
        a = np.full(2 * tile + 5, 2 ** 64 - 2, np.uint64)
        b = np.full(tile + 3, 2 ** 64 - 2, np.uint64)
    elif case == "1024_tiles":
        n = 1024 * tile + 17
        pool = _u64_keys(rng, int(1.3 * n))
        a = np.sort(rng.choice(pool, n // 2, replace=False))
        b = np.sort(rng.choice(pool, n - n // 2, replace=False))
    return [u64.to_device_keys(a, dev), torch.arange(len(a), device=dev),
            u64.to_device_keys(b, dev),
            torch.arange(len(b), device=dev) + 10 ** 9]


@pytest.mark.parametrize("case", [(50_000, 70_000), (1, 0), (0, 3),
                                  (129, 1), "shared", "straddle",
                                  "repeated", "misaligned", "1024_tiles"])
def test_merge_newest_wins_matches_plain(dev, case):
    """The fold step on the card (one launch of the wrapper: the tiled
    merge with the drop fused in) equals the plain merge followed by the
    torch-op drop, bit for bit; and so does ``two_way_merge`` (the same
    kernels without the drop) equal the plain merge."""
    args = _merge_step_runs(case, dev)
    before = _build.LAUNCHES["merge"]
    k, v = merge_ops.merge_newest_wins(*args)
    launched = sum(t.numel() for t in args[::2]) > 0
    assert _build.LAUNCHES["merge"] == before + launched
    cpu = [t.cpu() for t in args]
    rk, rv = merge_ops.drop_adjacent_duplicates(*two_way_merge(*cpu))
    assert torch.equal(k.cpu(), rk) and torch.equal(v.cpu(), rv)
    k, v = two_way_merge(*args)
    rk, rv = two_way_merge(*cpu)
    assert torch.equal(k.cpu(), rk) and torch.equal(v.cpu(), rv)


def test_merge_runs_multi_run_fold_matches_plain(dev):
    """A five-run newest-first fold with overlaps, an empty run and a
    misaligned view: every step on the card, bit-identical to the CPU."""
    rng = np.random.default_rng(11)
    pool = _u64_keys(rng, 200_000)
    runs = [np.sort(rng.choice(pool, n, replace=False))
            for n in (70_000, 1, 0, 120_000, 33_333)]
    vals = [np.arange(len(r), dtype=np.int64) + 10 ** 6 * i
            for i, r in enumerate(runs)]
    out = {}
    for d in ("cpu", dev):
        ks = [u64.to_device_keys(r, d) for r in runs]
        vs = [torch.from_numpy(x).to(d) for x in vals]
        ks[3], vs[3] = (torch.cat([t[:1], t])[1:] for t in (ks[3], vs[3]))
        before = _build.LAUNCHES["merge"]
        out[str(d)] = merge_runs(ks, vs)
        if d == dev:
            assert _build.LAUNCHES["merge"] == before + 3
    assert torch.equal(out["cuda"][0].cpu(), out["cpu"][0])
    assert torch.equal(out["cuda"][1].cpu(), out["cpu"][1])


def test_point_read_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    keys = _u64_keys(rng, 60_000)
    runs = [keys[::3], keys[1::2], keys[::5], np.empty(0, np.uint64)]
    levels = {}
    for d in ("cpu", dev):
        lv = store.LevelStore(d)
        lv._set_runs([store.RunData.build(
            u64.to_device_keys(r, d), torch.arange(len(r), device=d) * 2 + 1,
            7.5, flushes=1) for r in runs])
        levels[str(d)] = lv
    q = np.concatenate([rng.choice(keys, 5000), _u64_keys(rng, 5000)])
    got = point_read_level(u64.to_device_keys(q, dev), levels["cuda"].keys,
                           levels["cuda"].vals, levels["cuda"].pack)
    want = point_read_level(u64.to_device_keys(q, "cpu"), levels["cpu"].keys,
                            levels["cpu"].vals, levels["cpu"].pack)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _point_read_level(d, runs, bpk):
    lv = store.LevelStore(d)
    lv._set_runs([store.RunData.build(
        u64.to_device_keys(r, d), torch.arange(len(r), device=d) * 2 + 1,
        bpk, flushes=1) for r in runs])
    return lv


@pytest.mark.parametrize("case", ["one_run_sampled", "one_run_short",
                                  "above_and_below_min_run", "tiered_10_runs",
                                  "misaligned_queries", "kmax_17",
                                  "kmax_32"])
def test_point_read_sampled_kernel_matches_plain(dev, case):
    """The kernel against its plain version on the CPU, bit for bit: one-run
    levels with and without a sample, a level of runs on both sides of
    ``SAMPLE_MIN_RUN``, a tiered level of 10 runs, queries as a view one
    element into a buffer, and filters of 17 and 32 (the bound) hashes."""
    from repro_torch.kernels.point_read import ops as read_ops
    rng = np.random.default_rng(len(case))
    keys = _u64_keys(rng, 120_000)
    m = read_ops.SAMPLE_MIN_RUN
    runs = {"one_run_sampled": [keys[::2]], "one_run_short": [keys[:m - 1]],
            "above_and_below_min_run": [keys[:m - 1], keys[1::3],
                                        keys[5:m + 5], keys[::7]],
            "tiered_10_runs": [np.sort(rng.choice(keys, n, replace=False))
                               for n in (100, 5000, 900, 20_000, 4096, 4095,
                                         0, 30_000, 60_000, 7)],
            "misaligned_queries": [keys[::3], keys[1::4]],
            "kmax_17": [keys[::5], keys[::11]],
            "kmax_32": [keys[::6]]}[case]
    bpk = {"kmax_17": 24.5, "kmax_32": 46.0}.get(case, 7.5)
    levels = {str(d): _point_read_level(d, runs, bpk) for d in ("cpu", dev)}
    kmax = max(levels["cpu"].ks)
    assert kmax <= read_ops.KMAX_BOUND
    q = np.concatenate([rng.choice(keys, 7000), _u64_keys(rng, 3001),
                        keys[[0, -1]]])
    qd = u64.to_device_keys(q, dev)
    if case == "misaligned_queries":
        qd = torch.cat([qd[:1], qd])[1:]
        assert qd.data_ptr() % 16 == 8
    before = _build.LAUNCHES["point_read"]
    got = point_read_level(qd, levels["cuda"].keys, levels["cuda"].vals,
                           levels["cuda"].pack)
    assert _build.LAUNCHES["point_read"] == before + 1
    want = point_read_level(u64.to_device_keys(q, "cpu"), levels["cpu"].keys,
                            levels["cpu"].vals, levels["cpu"].pack)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want[0].sum()) > 0


def test_policy_fleet_on_card_matches_cpu_plain_path(dev):
    """``run_policy_fleet``: two tunings x {klsm, lazy_leveling} x two
    sessions, every ``IOStats`` bit-identical on the card and the CPU."""
    sys_t = core.LSMSystem()
    phis = [core.make_phi(6.0, 5.0 * sys_t.N, 1.0, sys_t),
            core.make_phi(5.0, 3.0 * sys_t.N, 4.0, sys_t)]
    mixes = np.array([[0.33, 0.33, 0.33, 0.01], [0.05, 0.10, 0.05, 0.80]])
    before = dict(_build.LAUNCHES)
    out = {d: P.run_policy_fleet(phis, sys_t, ("klsm", "lazy_leveling"),
                                 mixes, n_keys=20_000, n_queries=2000,
                                 device=d)[1] for d in ("cpu", "cuda")}
    for k in ("merge", "point_read"):
        assert _build.LAUNCHES[k] > before[k]
    for a_row, b_row in zip(out["cpu"], out["cuda"]):
        for a_pol, b_pol in zip(a_row, b_row):
            for a, b in zip(a_pol, b_pol):
                assert a.io.as_dict() == b.io.as_dict()
                assert a.avg_io_per_query == b.avg_io_per_query


def test_api_trial_on_card_matches_cpu_plain_path(dev):
    """``run_experiment`` on the card (two workloads, nominal and rho 1,
    the K-LSM and lazy-leveling arms), then its ``TrialPlan`` through
    ``execute_trial`` on the card and on the CPU: every tree's
    ``IOStats``, I/O per query and ``TreeProbe`` bit-identical, tombstones
    included, and the card's trial launches ``merge`` and ``point_read``.
    The sharded backend on the card gives the inline tunings bit for
    bit."""
    import dataclasses

    import repro_torch.api as api
    spec = api.ExperimentSpec(
        name="api_card",
        workload=api.WorkloadSpec(indices=(4, 11), rhos=(1.0,)),
        design=api.DesignSpec(n_starts=16, steps=30, seed=0,
                              policies=("klsm", "lazy_leveling")),
        trial=api.TrialSpec(n_keys=20_000, n_queries=1000,
                            sessions=((0.05, 0.85, 0.05, 0.05),
                                      (0.05, 0.05, 0.05, 0.85)),
                            key_space=2 ** 24, range_fraction=1e-3,
                            per_workload_keys=True, key_seed=100,
                            delete_fraction=0.02),
        system=(("N", 20_000.0), ("entry_bits", 512.0),
                ("bits_per_entry", 6.0), ("min_buf_bits", 512.0 * 64),
                ("max_T", 20.0)))
    report = api.run_experiment(spec, device="cuda")
    sharded = api.run_experiment(spec, api.ShardedBackend(), device="cuda")
    assert sharded.walls["tuning_devices"] == torch.cuda.device_count()
    for cell in report.cells:
        for pol in spec.design.policies:
            a, b = report.tuning(cell, pol), sharded.tuning(cell, pol)
            assert torch.equal(a.phi.T, b.phi.T) and a.cost == b.cost
            assert torch.equal(a.phi.K, b.phi.K)
    plan = api.compile_spec(spec).build_trial(report)
    out = {}
    for d in ("cpu", "cuda"):
        before = dict(_build.LAUNCHES)
        results, probes, _, _ = api.execute_trial(plan, device=d)
        launches = {k: _build.LAUNCHES[k] - before[k]
                    for k in ("merge", "point_read")}
        out[d] = ([[r.io.as_dict() for r in row] for row in results],
                  [[r.avg_io_per_query for r in row] for row in results],
                  [dataclasses.asdict(p) for p in probes], launches)
    assert out["cuda"][:3] == out["cpu"][:3]
    assert all(out["cuda"][3].values()) and not any(out["cpu"][3].values())
    assert any(p["tomb_ages"] for p in out["cuda"][2])
    assert out["cuda"][0] == [[r.io.as_dict()
                               for r in report.fleet[(b.cell, b.policy)]]
                              for b in plan.trees]


@pytest.mark.parametrize("suite", ["fig7_8", "fig9", "fig19"])
def test_api_suites_launch_dual_solve(dev, monkeypatch, suite):
    """Each API suite (cut to 2 starts and 3 steps) tunes one robust grid
    through ``run_experiment``: one ``dual_solve`` launch per Adam step
    plus one for the final iterate, and its rows hold the committed
    keys."""
    import importlib

    from repro_torch.bench import run
    mod = importlib.import_module(f"repro_torch.bench.{suite}")
    for name in ("N_STARTS", "KLSM_STARTS"):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, 2)
    monkeypatch.setattr(mod, "STEPS", 3)
    before = _build.LAUNCHES["dual_solve"]
    result = run.run_suite(suite, device="cuda")
    assert _build.LAUNCHES["dual_solve"] - before == 3 + 1
    cmp = result["comparison"]
    assert all(got is not None for _, got, _ in cmp["missed"])


@pytest.mark.parametrize("robust", [False, True])
def test_slsqp_on_card_matches_cpu(dev, robust):
    """The SLSQP tuners with values and gradients on the card against the
    same tuners on the CPU (the same numpy starts): the same design, cost
    to rel 1e-3 (a 1-ulp difference of the card's exp/log can move an
    SLSQP step on the flat float32 objective)."""
    w = np.array([0.33, 0.33, 0.33, 0.01])
    sys_t = core.LSMSystem()
    if robust:
        got = {d: core.tune_robust_slsqp(w, 1.0, sys_t, n_starts=2, device=d)
               for d in ("cpu", "cuda")}
    else:
        got = {d: core.tune_nominal_slsqp(w, sys_t, n_starts=2, device=d)
               for d in ("cpu", "cuda")}
    assert got["cuda"].solver == got["cpu"].solver == "slsqp"
    assert got["cuda"].design is got["cpu"].design
    assert got["cuda"].cost == pytest.approx(got["cpu"].cost, rel=1e-3)


def test_fig10_suite_launches_dual_solve(dev, monkeypatch):
    """The runner's fig10 suite (cut to 2 starts and 3 steps) launches the
    ``dual_solve`` kernel once per robust Adam step plus once for the final
    iterate, at each of its five entry sizes, and its rows hold the
    committed keys."""
    from repro_torch.bench import fig10, run
    monkeypatch.setattr(fig10, "N_STARTS", 2)
    monkeypatch.setattr(fig10, "STEPS", 3)
    before = _build.LAUNCHES["dual_solve"]
    result = run.run_suite("fig10", device="cuda")
    assert _build.LAUNCHES["dual_solve"] - before \
        == len(fig10.ENTRY_BITS) * (3 + 1)
    cmp = result["comparison"]
    assert all(got is not None for _, got, _ in cmp["missed"])


def test_engine_on_card_matches_cpu_plain_path(dev):
    cfg = P.EngineConfig(T=5, K=(4,) * 8, buf_entries=300,
                         expected_entries=20_000, mfilt_bits_per_entry=6.0)
    trees = {d: P.LSMTree(cfg, device=d) for d in ("cpu", "cuda")}
    keys = {d: P.populate(t, 20_000, seed=3) for d, t in trees.items()}
    for s, mix in enumerate([[0.33, 0.33, 0.33, 0.01],
                             [0.05, 0.10, 0.05, 0.80]]):
        res = {d: P.run_session(t, keys[d], np.array(mix), n_queries=3000,
                                seed=s) for d, t in trees.items()}
        assert res["cpu"].io.as_dict() == res["cuda"].io.as_dict()
    for a, b in zip(trees["cpu"].store.levels, trees["cuda"].store.levels):
        assert torch.equal(a.keys, b.keys.cpu())
        assert torch.equal(a.vals, b.vals.cpu())
    q = keys["cpu"][:500]
    assert trees["cpu"].point_query_batch(q) \
        == trees["cuda"].point_query_batch(q)
    lo = np.sort(keys["cpu"][:20])
    assert trees["cpu"].range_query_batch(lo, lo + np.uint64(2 ** 36), True) \
        == trees["cuda"].range_query_batch(lo, lo + np.uint64(2 ** 36), True)


@pytest.mark.parametrize("B,S,H,KV,d,causal,window,dtype,strided", [
    (2, 128, 8, 2, 64, True, None, torch.float32, False),
    (2, 256, 4, 4, 96, False, None, torch.float32, False),
    (1, 300, 4, 1, 128, True, 100, torch.float32, True),   # ragged, window
    (2, 77, 2, 2, 16, True, None, torch.float32, False),
    (1, 65, 4, 2, 32, False, 30, torch.float32, True),
    (2, 256, 8, 2, 128, True, None, torch.bfloat16, False),
    (1, 300, 4, 1, 128, True, 100, torch.bfloat16, True),
    (2, 77, 2, 2, 16, True, None, torch.bfloat16, False),
    (1, 65, 4, 2, 32, False, None, torch.bfloat16, False),
    (2, 256, 4, 4, 96, True, None, torch.bfloat16, False),  # H = KV
    (1, 256, 32, 2, 128, True, None, torch.bfloat16, False),  # GQA 16
    (1, 1, 4, 2, 128, True, None, torch.bfloat16, False),
    (4, 1500, 8, 8, 64, False, None, torch.bfloat16, False),  # whisper enc
    (4, 1500, 8, 8, 64, True, None, torch.bfloat16, False),   # whisper dec
    (1, 2048, 64, 8, 128, True, None, torch.bfloat16, False),  # qwen2-vl
])
def test_flash_attention_kernel_matches_plain(dev, B, S, H, KV, d, causal,
                                              window, dtype, strided):
    """The kernel against its plain version: float32 to 2e-5, bfloat16 to
    2e-2 (one bfloat16 rounding of the output apart).  ``strided`` hands
    the kernel views whose batch/seq/head strides are not the packed ones.
    bfloat16 launches the tensor-core kernel, float32 the CUDA-core one."""
    g = torch.Generator(device=dev).manual_seed(S + d)

    def draw(n):
        wide = 2 * n if strided else n
        t = torch.randn((B, S, wide, d), generator=g, device=dev).to(dtype)
        return t[:, :, 1:n + 1] if strided else t

    q, k, v = draw(H), draw(KV), draw(KV)
    before = dict(_build.LAUNCHES)
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert _build.LAUNCHES["flash_attention"] \
        == before["flash_attention"] + 1
    served = {name for name in _build.VARIANTS
              if _build.LAUNCHES[name] != before[name]}
    assert served == {"flash_attention:bf16_tc" if dtype == torch.bfloat16
                      else "flash_attention:f32_cuda_core"}
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, H, d)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_bf16_copies_what_tma_cannot_read(dev):
    """bf16 q/k/v that TMA cannot read in place (a base one element off
    the 16-byte grid, a head stride of 136 bytes) are copied to packed
    tensors and still match the plain version."""
    g = torch.Generator(device=dev).manual_seed(5)
    flat = torch.randn(2 * 96 * 4 * 64 + 1, generator=g,
                       device=dev).to(torch.bfloat16)
    q = flat[1:].view(2, 96, 4, 64)                  # misaligned base
    k, v = (torch.randn((2, 96, 2, 68), generator=g, device=dev)
            .to(torch.bfloat16)[..., :64] for _ in range(2))
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def _to(tree, device):
    if isinstance(tree, list):
        return [_to(t, device) for t in tree]
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.detach().to(device)


def test_serve_batch_on_card_matches_cpu_plain_path(dev):
    """The reduced qwen3-14b server on the card (flash-attention kernel,
    one launch per layer) against the CPU plain path on the same weights:
    equal greedy tokens."""
    cfg = get_config("qwen3-14b").reduced()
    params = build_model(cfg, "cpu", seed=0).params
    args = ("qwen3-14b", True, 2, 40, 8)
    cpu = serve_batch(*args, seed=0, device="cpu", params=_to(params, "cpu"))
    before = _build.LAUNCHES["flash_attention"]
    gpu = serve_batch(*args, seed=0, device=dev, params=_to(params, dev))
    assert _build.LAUNCHES["flash_attention"] == before + cfg.num_layers
    assert gpu["logits_finite"] and gpu["device"].startswith("cuda")
    np.testing.assert_array_equal(gpu["tokens"], cpu["tokens"])


@pytest.mark.parametrize("arch,launches", [("whisper-base", 4),
                                           ("qwen2-vl-72b", 2)])
def test_encdec_and_stub_serve_on_card_match_cpu(dev, arch, launches):
    """The reduced whisper-base (2 non-causal encoder layers, 2 decoder
    layers, each launching the float32 flash-attention kernel) and
    qwen2-vl-72b (stub embeddings, decode fed ``embed_out``) served on the
    card against the CPU plain path on the same weights: equal greedy
    tokens, the cross K/V kept at the encoder's length."""
    cfg = get_config(arch).reduced()
    params = build_model(cfg, "cpu", seed=0).params
    args = (arch, True, 2, 40, 8)
    cpu = serve_batch(*args, seed=0, device="cpu", params=_to(params, "cpu"))
    before = _build.LAUNCHES["flash_attention:f32_cuda_core"]
    gpu = serve_batch(*args, seed=0, device=dev, params=_to(params, dev))
    assert _build.LAUNCHES["flash_attention:f32_cuda_core"] \
        == before + launches
    assert gpu["logits_finite"] and gpu["device"].startswith("cuda")
    assert gpu["kv_cache_bytes"] == cpu["kv_cache_bytes"]
    np.testing.assert_array_equal(gpu["tokens"], cpu["tokens"])


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x7b"])
def test_apply_moe_on_card_matches_cpu(dev, arch, cf):
    """One MoE layer of the reduced model (float32, 4 x 64 tokens; with
    capacity factor 0.5 tokens drop): the same experts and kept slots,
    the output to 1e-5 and the aux to rel 1e-5 (sums in another order);
    in bfloat16, two runs on the card give the same bits (dispatch and
    combine are plain indexing, no atomics)."""
    import dataclasses

    from repro_torch.models import moe
    cfg = get_config(arch).reduced()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    p = build_model(cfg, "cpu", seed=2).params["layers"][len(cfg.prelude)]
    p = p["mlp"]
    x = torch.randn((4, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want, waux = moe.apply_moe(p, x, cfg)
        got, gaux = moe.apply_moe(_to(p, dev), x.to(dev), cfg)
        _, _, e_cpu = moe.route(p, x, cfg)
        _, _, e_dev = moe.route(_to(p, dev), x.to(dev), cfg)
        cap = moe.capacity(cfg, 64)
        pos_c, keep_c = moe.slots(e_cpu, cfg.moe.num_experts, cap)
        pos_d, keep_d = moe.slots(e_dev, cfg.moe.num_experts, cap)
        assert torch.equal(e_dev.cpu(), e_cpu)
        assert torch.equal(keep_d.cpu(), keep_c)
        assert torch.equal(pos_d.cpu(), pos_c)
        assert bool(keep_c.all()) == (cf > 1)
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
        assert float(gaux) == pytest.approx(float(waux), rel=1e-5)
        def bf16(tree):
            return {k: (bf16(v) if isinstance(v, dict) else v if k ==
                        "router" else v.to(torch.bfloat16))
                    for k, v in tree.items()}

        pb = bf16(_to(p, dev))
        xb = x.to(dev, torch.bfloat16)
        a, _ = moe.apply_moe(pb, xb, cfg)
        b, _ = moe.apply_moe(pb, xb, cfg)
        assert torch.equal(a, b)


def test_deepseek_prefill_kernel_path_matches_plain_on_card(dev):
    """The reduced deepseek-moe-16b (a dense prelude layer, 2 MoE layers)
    in float32 on the card: last-position prefill logits through the
    float32 flash-attention kernel (one launch a layer, the prelude's
    included) against the plain path, to 1e-4 (the dense models'
    whole-model tolerance), and the plain path against the CPU's."""
    from repro_torch.models import lm
    cfg = get_config("deepseek-moe-16b").reduced()
    params = build_model(cfg, "cpu", seed=0).params
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 48)))
    with torch.no_grad():
        _build.reset_launches()
        kern, _ = lm.lm_prefill(_to(params, dev), {"tokens": toks.to(dev)},
                                cfg)
        assert _build.LAUNCHES["flash_attention:f32_cuda_core"] \
            == cfg.num_layers == 3
        plain_cfg = cfg.replace(attention_impl="plain")
        plain, _ = lm.lm_prefill(_to(params, dev), {"tokens": toks.to(dev)},
                                 plain_cfg)
        cpu, _ = lm.lm_prefill(params, {"tokens": toks}, plain_cfg)
    torch.testing.assert_close(kern.cpu(), plain.cpu(), atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(plain.cpu(), cpu, atol=1e-4, rtol=1e-4)


def test_mamba_on_card_matches_cpu(dev):
    """The reduced jamba's Mamba block in float32 (8-step chunks): a
    32-token ``mamba_full`` (four chunks, the state carried) and 4
    ``mamba_step``s on its cache, on the card against the CPU from the same
    weights and inputs, to 1e-5 (sums in another order); the path under
    autograd gives the chunked path's output to 1e-5 (its h.C products
    run as one batched product where the chunked path runs one a chunk,
    which cuBLAS may sum in another order), and its gradients match the
    CPU's to 1e-4 of each leaf's largest."""
    from repro_torch.models import mamba
    cfg = get_config("jamba-1.5-large-398b").reduced(mamba_chunk=8)
    p = mamba.init_mamba(torch.Generator().manual_seed(3), cfg)
    x = torch.randn((2, 36, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    outs = {}
    for device in ("cpu", "cuda"):
        pd, xd = _to(p, device), x.to(device)
        with torch.no_grad():
            y, cache = mamba.mamba_full(pd, xd[:, :32], cfg)
            steps = [mamba.mamba_step(pd, xd[:, i:i + 1], cache, cfg)[0]
                     for i in range(32, 36)]
        pg = {k: v.clone().requires_grad_(True) for k, v in pd.items()}
        yg, _ = mamba.mamba_full(pg, xd[:, :32], cfg)
        torch.testing.assert_close(yg.detach(), y, atol=1e-5, rtol=1e-5)
        grads = torch.autograd.grad((yg ** 2).sum(), list(pg.values()))
        outs[device] = [t.detach().cpu() for t in (
            y, cache["conv"], cache["ssm"], *steps)], [g.cpu() for g in grads]
    for a, b in zip(outs["cpu"][0], outs["cuda"][0]):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=1e-5)
    for a, b in zip(outs["cpu"][1], outs["cuda"][1]):
        torch.testing.assert_close(b, a, atol=1e-4 * float(a.abs().max()),
                                   rtol=0)


def test_jamba_prefill_kernel_path_matches_plain_on_card(dev):
    """The reduced jamba-1.5-large-398b (two 8-layer periods: 14 Mamba
    layers, 2 attention layers) in float32 on the card: last-position
    prefill logits through the float32 flash-attention kernel (one launch
    an attention layer) against the plain path, to 1e-4, and the plain
    path against the CPU's."""
    from repro_torch.models import lm
    cfg = get_config("jamba-1.5-large-398b").reduced()
    params = build_model(cfg, "cpu", seed=0).params
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 48)))
    with torch.no_grad():
        _build.reset_launches()
        kern, _ = lm.lm_prefill(_to(params, dev), {"tokens": toks.to(dev)},
                                cfg)
        assert _build.LAUNCHES["flash_attention:f32_cuda_core"] == 2
        plain_cfg = cfg.replace(attention_impl="plain")
        plain, _ = lm.lm_prefill(_to(params, dev), {"tokens": toks.to(dev)},
                                 plain_cfg)
        cpu, _ = lm.lm_prefill(params, {"tokens": toks}, plain_cfg)
    torch.testing.assert_close(kern.cpu(), plain.cpu(), atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(plain.cpu(), cpu, atol=1e-4, rtol=1e-4)


def test_mixtral_past_its_window_on_card_matches_cpu(dev):
    """The reduced mixtral-8x7b with a window of 8 in float32: a 24-token
    prompt (three windows) prefilled through the windowed float32
    flash-attention kernel (one launch a layer), then 6 decode steps on
    the ring cache of 8 slots, on the card against the CPU's plain path
    from the same weights and tokens: each step's logits to 1e-4."""
    from repro_torch.launch.serve import write_prefill_cache
    from repro_torch.models import LM
    cfg = get_config("mixtral-8x7b").reduced(window=8)
    params = build_model(cfg, "cpu", seed=1).params
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 30)))
    logits = {}
    for device in ("cpu", "cuda"):
        model = LM(cfg, _to(params, device), torch.device(device))
        _build.reset_launches()
        first, pcache = model.prefill(toks[:, :24].to(device))
        if device == "cuda":
            assert _build.LAUNCHES["flash_attention:f32_cuda_core"] \
                == cfg.num_layers == 2
        cache = model.init_cache(2, 30)
        assert cache[0]["mixer"]["k"].shape[1] == 8
        write_prefill_cache(cache, pcache)
        out = [first]
        for i in range(24, 30):
            step, cache = model.decode_step(cache,
                                            toks[:, i:i + 1].to(device), i)
            out.append(step)
        logits[device] = [t.cpu() for t in out]
    for a, b in zip(logits["cpu"], logits["cuda"]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


# (mean, sd) of ww, logw = -exp(ww): the model's init decay, a slow one
# (exp(logw) ~ 0.993, the state carries across the whole sequence) and a
# fast one (logw ~ -7.4, where a one-level chunked split overflows)
RWKV_DECAYS = {"model": (-0.6, 0.5), "slow": (-5.0, 0.1),
               "fast": (2.0, 0.1)}


@pytest.mark.parametrize("B,S,H,n,dtype,strided,decay", [
    (2, 128, 4, 64, torch.float32, False, "model"),
    (2, 96, 3, 32, torch.float32, False, "slow"),      # three chunks
    (1, 64, 2, 16, torch.float32, True, "model"),
    (2, 20, 4, 64, torch.float32, False, "model"),     # a single chunk
    (1, 2048, 2, 64, torch.float32, False, "slow"),    # slow decay, long
    (2, 256, 8, 64, torch.bfloat16, True, "model"),
    (1, 128, 4, 32, torch.bfloat16, False, "slow"),
    (4, 2048, 40, 64, torch.bfloat16, False, "model"),  # the prefill
    (4, 2048, 40, 64, torch.bfloat16, False, "slow"),
    (4, 2048, 40, 64, torch.bfloat16, False, "fast"),
    (2, 96, 3, 64, torch.bfloat16, False, "fast"),      # three chunks
    (2, 16, 4, 64, torch.bfloat16, False, "slow"),      # half a chunk
    (2, 20, 4, 32, torch.bfloat16, True, "model"),      # a ragged chunk
    (1, 256, 2, 16, torch.bfloat16, True, "fast"),
    (1, 1, 2, 16, torch.bfloat16, False, "model"),
])
def test_rwkv6_kernel_matches_plain(dev, B, S, H, n, dtype, strided, decay):
    """The kernel against its plain version (the per-step recurrence), y
    and the final state: float32 to 5e-4, bfloat16 r/k/v (float32 logw)
    to 5e-2, the JAX kernel test's tolerances.  ``strided`` hands the
    kernel views whose batch/seq/head strides are not the packed ones.
    bfloat16 launches the tensor-core kernel, float32 the per-step one."""
    g = torch.Generator(device=dev).manual_seed(S + n)

    def draw(dt, scale=1.0, shift=0.0):
        wide = 2 * H if strided else H
        t = (torch.randn((B, S, wide, n), generator=g, device=dev) * scale
             + shift).to(dt)
        return t[:, :, 1:H + 1] if strided else t

    r, k, v = draw(dtype), draw(dtype), draw(dtype)
    mean, sd = RWKV_DECAYS[decay]
    logw = -torch.exp(draw(torch.float32, sd, mean))
    u = torch.randn((H, n), generator=g, device=dev) * 0.1
    before = dict(_build.LAUNCHES)
    y, state = rwkv6(r, k, v, logw, u)
    assert _build.LAUNCHES["rwkv6"] == before["rwkv6"] + 1
    served = {name for name in _build.VARIANTS
              if _build.LAUNCHES[name] != before[name]}
    assert served == {"rwkv6:bf16_tc" if dtype == torch.bfloat16
                      else "rwkv6:f32_cuda_core"}
    want_y, want_s = rwkv6_ref(r, k, v, logw, u)
    torch.cuda.synchronize()
    assert y.dtype == state.dtype == torch.float32
    assert y.shape == (B, S, H, n) and state.shape == (B, H, n, n)
    tol = 5e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(y, want_y, atol=tol, rtol=tol)
    torch.testing.assert_close(state, want_s, atol=tol, rtol=tol)


def test_rwkv6_bf16_copies_what_cp_async_cannot_read(dev):
    """bf16 r/k/v and float32 logw that 16-byte copies cannot read in
    place (a base one element off the 16-byte grid, head strides of 72
    and 136 bytes) are copied to packed tensors and still match the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(7)
    flat = torch.randn(2 * 64 * 3 * 32 + 1, generator=g,
                       device=dev).to(torch.bfloat16)
    r = flat[1:].view(2, 64, 3, 32)                  # misaligned base
    k, v = (torch.randn((2, 64, 3, 36), generator=g, device=dev)
            .to(torch.bfloat16)[..., :32] for _ in range(2))
    logw = -torch.exp(torch.randn((2, 64, 3, 34), generator=g,
                                  device=dev)[..., :32] * 0.5 - 0.6)
    u = torch.randn((3, 32), generator=g, device=dev) * 0.1
    y, state = rwkv6(r, k, v, logw, u)
    want_y, want_s = rwkv6_ref(r, k, v, logw, u)
    torch.testing.assert_close(y, want_y, atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(state, want_s, atol=5e-2, rtol=5e-2)


def test_rwkv6_serve_batch_on_card_matches_cpu_plain_path(dev):
    """The reduced rwkv6-3b server on the card (the rwkv6 kernel, one
    launch per layer of the prefill) against the CPU plain path on the
    same weights: equal greedy tokens and cache bytes."""
    cfg = get_config("rwkv6-3b").reduced()
    params = build_model(cfg, "cpu", seed=0).params
    args = ("rwkv6-3b", True, 2, 64, 8)
    cpu = serve_batch(*args, seed=0, device="cpu", params=_to(params, "cpu"))
    before = _build.LAUNCHES["rwkv6"]
    gpu = serve_batch(*args, seed=0, device=dev, params=_to(params, dev))
    assert _build.LAUNCHES["rwkv6"] == before + cfg.num_layers
    assert gpu["logits_finite"] and gpu["device"].startswith("cuda")
    assert gpu["kv_cache_bytes"] == cpu["kv_cache_bytes"]
    np.testing.assert_array_equal(gpu["tokens"], cpu["tokens"])



def _bloom_keys(seed, n):
    """n distinct uint32 keys as int64, from a seeded numpy generator."""
    keys = np.random.default_rng(seed).choice(2 ** 32, n, replace=False)
    return torch.from_numpy(keys.astype(np.int64))


def _bloom_check(dev, inserted, absent, n_in, num_blocks, k):
    """Build a plane of 512-bit blocks from ``inserted`` on the card and
    probe the first ``n_in`` inserted keys, then ``absent``: the kernel
    equals the plain version bit for bit and finds every inserted key.
    Returns the plane, the probe keys and the kernel's result."""
    plane = build_plane(inserted, num_blocks, 512, k, device=dev)
    q = torch.cat([inserted[:n_in], absent]).to(dev)
    before = _build.LAUNCHES["bloom_probe"]
    got = bloom_probe_kernel(q, plane, num_hashes=k)
    assert _build.LAUNCHES["bloom_probe"] == before + 1
    want = probe_ref(q, plane, k)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.equal(got, want)
    assert bool((got[:n_in] == 1.0).all())
    return plane, q, got


@pytest.mark.parametrize("mix", ["present", "absent", "mixed"])
@pytest.mark.parametrize("k", [0, 1, 7, 16])
@pytest.mark.parametrize("n", [1, 255, 1_000_000])
def test_bloom_probe_stops_at_the_first_zero(dev, n, k, mix):
    """N keys all inserted, all absent or half and half, against a plane of
    10 bits a key in 512-bit blocks with k hashes: the kernel equals the
    plain version bit for bit, misses no inserted key, and counts the
    plane floats each key read as ``probe_loads_ref`` does."""
    from repro_torch.kernels.bloom_probe.ops import bloom_probe_loads
    from repro_torch.kernels.bloom_probe.ref import probe_loads_ref
    keys = _bloom_keys(n + k, 3 * n)
    n_in = {"present": n, "absent": 0, "mixed": (n + 1) // 2}[mix]
    plane = build_plane(keys[:2 * n], -(-20 * n // 512), 512, k, device=dev)
    q = torch.cat([keys[:n_in], keys[2 * n:3 * n - n_in]]).to(dev)
    got, loads = bloom_probe_loads(q, plane, k)
    assert torch.equal(got, probe_ref(q, plane, k))
    assert torch.equal(got, bloom_probe_kernel(q, plane, num_hashes=k))
    assert bool((got[:n_in] == 1.0).all())
    assert torch.equal(loads, probe_loads_ref(q, plane, k))


@pytest.mark.parametrize("n", [1, 1000, 1_000_000])
def test_bloom_probe_kernel_matches_plain(dev, n):
    """N keys (N = 1 is not a multiple of anything), half inserted, against
    a plane of 10 bits per inserted key, k = 7."""
    keys = _bloom_keys(n, 3 * n)
    n_in = (n + 1) // 2
    _bloom_check(dev, keys[:2 * n], keys[2 * n:3 * n - n_in], n_in,
                 -(-20 * n // 512), 7)


def test_bloom_probe_kernel_deployment_plane(dev):
    """10 M keys at 10 bits per key in 512-bit blocks, k = 7: the
    195,313 x 512 plane (400 MB) of chip_smoke.py's bloom phase, probed
    with 500,000 inserted and 500,000 absent keys."""
    keys = _bloom_keys(0, 10_500_000)
    plane, _, got = _bloom_check(dev, keys[:10_000_000], keys[10_000_000:],
                                 500_000, 195_313, 7)
    assert plane.shape == (195_313, 512)
    fp = (got[500_000:] > 0.5).float().mean().item()
    assert 0.005 <= fp <= 0.02


def test_bloom_probe_kernel_64bit_plane_index(dev):
    """A plane of 9,000,000 x 512 floats (4.6e9, past 2**32; 18.4 GB): the
    keys whose floats lie past 2**31 and past 2**32 are read at their
    64-bit index."""
    num_blocks = 9_000_000
    keys = _bloom_keys(1, 600_000)
    plane, q, _ = _bloom_check(dev, keys[:400_000], keys[400_000:],
                               200_000, num_blocks, 7)
    start = (mix32(q[:200_000], 1) % num_blocks) * 512
    assert int((start >= 2 ** 32).sum()) > 1000
    assert int(((start >= 2 ** 31) & (start < 2 ** 32)).sum()) > 1000
    del plane
    torch.cuda.empty_cache()


def _guarded_calls(d):
    """One small call of each kernel's wrapper on device ``d``, as
    (launch count to watch, thunk returning the outputs as a tuple)."""
    rng = np.random.default_rng(7)
    C = torch.tensor(rng.gamma(2.0, 2.0, (64, 4)), dtype=torch.float32,
                     device=d)
    W = torch.full((64, 4), 0.25, device=d)
    rho = torch.full((64,), 0.5, device=d)
    keys = _u64_keys(rng, 300)
    a, b = np.sort(keys[::2]), np.sort(keys[1::2])
    lv = store.LevelStore(d)
    lv._set_runs([store.RunData.build(u64.to_device_keys(a, d),
                                      torch.arange(len(a), device=d), 7.5,
                                      flushes=1)])
    q = u64.to_device_keys(keys[:50], d)
    g = torch.Generator().manual_seed(1)     # the same numbers on any d
    attn = [torch.randn((1, 40, n, 64), generator=g) for n in (4, 2, 2)]
    attn = {dt: [t.to(d, dt) for t in attn]
            for dt in (torch.bfloat16, torch.float32)}
    rkv = [torch.randn((1, 32, 2, 16), generator=g) for _ in range(3)]
    rkv = {dt: [t.to(d, dt) for t in rkv]
           for dt in (torch.bfloat16, torch.float32)}
    logw = -torch.exp(torch.randn((1, 32, 2, 16), generator=g)).to(d)
    u = (torch.randn((2, 16), generator=g) * 0.1).to(d)
    bkeys = _bloom_keys(3, 200)
    plane = build_plane(bkeys[:100], 4, 512, 7, device=d)
    return {
        "dual_solve": lambda: dual_solve_warm_batch(
            C, W, rho, torch.log(C.max(1).values))[:1],
        "merge": lambda: two_way_merge(
            u64.to_device_keys(a, d), torch.arange(len(a), device=d),
            u64.to_device_keys(b, d), torch.arange(len(b), device=d)),
        "point_read": lambda: point_read_level(q, lv.keys, lv.vals, lv.pack),
        "flash_attention:bf16_tc": lambda: (flash_attention(
            *attn[torch.bfloat16]),),
        "flash_attention:f32_cuda_core": lambda: (flash_attention(
            *attn[torch.float32]),),
        "rwkv6": lambda: rwkv6(*rkv[torch.float32], logw, u),
        "rwkv6:bf16_tc": lambda: rwkv6(*rkv[torch.bfloat16], logw, u),
        "bloom_probe": lambda: (bloom_probe_kernel(bkeys.to(d), plane, 7),),
    }


@pytest.mark.parametrize("kernel", [
    "dual_solve", "merge", "point_read", "flash_attention:bf16_tc",
    "flash_attention:f32_cuda_core", "rwkv6", "rwkv6:bf16_tc",
    "bloom_probe"])
def test_launch_inside_a_device_guard_stays_on_its_device(dev, kernel):
    """Each wrapper called inside ``torch.cuda.device(0)`` launches its
    kernel once and leaves every output on cuda:0, equal to the plain
    version on the CPU; with a second card, tensors on cuda:1 called while
    cuda:0 is current give the same outputs on cuda:1."""
    want = [t.cpu() for t in _guarded_calls("cpu")[kernel]()]
    # the kernels' contracts: dual_solve's value to rel 1e-5, float32
    # attention to 2e-5, bf16 attention to 2e-2, rwkv6 to 5e-4 in float32
    # and 5e-2 in bf16
    tol = {"dual_solve": (0.0, 1e-5), "flash_attention:bf16_tc": (2e-2, 2e-2),
           "flash_attention:f32_cuda_core": (2e-5, 2e-5),
           "rwkv6": (5e-4, 5e-4), "rwkv6:bf16_tc": (5e-2, 5e-2)}.get(kernel)
    targets = [(0, 0)] + ([(0, 1)] if torch.cuda.device_count() > 1 else [])
    for current, home in targets:
        d = torch.device("cuda", home)
        call = _guarded_calls(d)[kernel]
        before = _build.LAUNCHES[kernel]
        with torch.cuda.device(current):
            got = call()
            torch.cuda.synchronize(d)
        assert _build.LAUNCHES[kernel] == before + 1
        for g, w in zip(got, want):
            assert g.device == d
            if tol is None:
                assert torch.equal(g.cpu(), w)
            else:
                torch.testing.assert_close(g.cpu().float(), w.float(),
                                           atol=tol[0], rtol=tol[1])


@pytest.mark.parametrize("suite,sizes", [
    ("fig6", {}), ("tab5", dict(N_KEYS=20_000, QUERIES=1000)),
    ("api", {}), ("online", dict(N_KEYS=20_000, SEGMENTS=4,
                                  SEG_QUERIES=500)),
    ("memory", dict(N_KEYS=20_000, SEGMENTS=4, SEG_QUERIES=500)),
    ("compaction", dict(N_KEYS=20_000, QUERIES=1000)),
    ("scenarios", dict(N_KEYS=20_000, SEGMENTS=4, SEG_QUERIES=300))])
def test_cpu_held_suites_launch_their_kernels(dev, monkeypatch, suite,
                                              sizes):
    """fig6, tab5, api, online, memory, compaction and scenarios through
    the runner on the card (all but fig6 and api cut in size): every
    committed row and key present, one ``dual_solve`` launch per robust
    Adam step plus one per robust grid (and per robust re-tune storm of
    the drift loop or the memory arbiter; compaction runs no tuner), and
    the engine suites' trees on ``merge`` and ``point_read``."""
    import importlib

    from repro_torch.bench import run
    from repro_torch.online import memory, session
    mod = importlib.import_module(f"repro_torch.bench.{suite}")
    for name, value in sizes.items():
        monkeypatch.setattr(mod, name, value)
    robust_storms = []
    real = session.retune_fleet

    def storm(requests, sys, **kw):
        robust_storms.append(any(r.rho > 0 for r in requests))
        return real(requests, sys, **kw)

    monkeypatch.setattr(session, "retune_fleet", storm)
    monkeypatch.setattr(memory, "retune_fleet", storm)
    before = dict(_build.LAUNCHES)
    result = run.run_suite(suite, device="cuda")
    launches = {k: _build.LAUNCHES[k] - before[k]
                for k in ("dual_solve", "merge", "point_read")}
    cmp = result["comparison"]
    assert all(got is not None and want is not None
               for _, got, want in cmp["missed"])
    grids = {"fig6": 1, "tab5": 1, "api": 2, "online": 3, "memory": 3,
             "compaction": 0, "scenarios": 5}[suite]
    steps = 120 if suite == "api" else 250
    storm_steps = 120 if suite == "scenarios" else 200
    assert launches["dual_solve"] == grids * (steps + 1) \
        + sum(robust_storms) * (storm_steps + 1)
    assert (launches["merge"] > 0) == (launches["point_read"] > 0) \
        == (suite != "fig6")


def test_drift_on_card_matches_cpu_from_the_same_tunings(dev, monkeypatch):
    """A small flip drift (20,000 keys, 4 segments of 500 queries, a tight
    trigger) on the card, then its plan on the CPU with every storm
    answered by the card's: the same segment records and the same
    ``LSMTree.retune`` calls; the card's storms launch ``dual_solve``, its
    trees ``merge`` and ``point_read``."""
    import dataclasses

    import repro_torch.api as api
    from repro_torch.bench import online
    from repro_torch.lsm import LSMTree
    from repro_torch.online import execute_drift, session
    spec = online.make_spec("flip", 4, online.SCENARIOS[1][2],
                            n_keys=20_000, segments=4, seg_queries=500)
    spec = dataclasses.replace(
        spec, design=api.DesignSpec(n_starts=16, steps=60, seed=0),
        drift=dataclasses.replace(spec.drift, kl_threshold=0.05, cooldown=1,
                                  retune_starts=8, retune_steps=40))
    storms, calls = [], {"cuda": [], "cpu": []}
    real_fleet, real_retune = session.retune_fleet, LSMTree.retune
    where = {"dev": "cuda"}

    def record(requests, sys, **kw):
        out = real_fleet(requests, sys, **kw)
        storms.append((requests, out))
        return out

    def replay(requests, sys, **kw):
        want, out = storms[len(calls["replayed"])]
        calls["replayed"].append(requests)
        assert [(list(a.w), a.rho, a.reason) for a in requests] \
            == [(list(b.w), b.rho, b.reason) for b in want]
        return out

    def retune(tree, phi, sys):
        real_retune(tree, phi, sys)
        calls[where["dev"]].append((tree.obs_label, tree.cfg.T,
                                    tree.cfg.K, tree.cfg.buf_entries))

    monkeypatch.setattr(LSMTree, "retune", retune)
    monkeypatch.setattr(session, "retune_fleet", record)
    before = dict(_build.LAUNCHES)
    report = api.run_experiment(spec, device="cuda")
    launches = {k: _build.LAUNCHES[k] - before[k]
                for k in ("dual_solve", "merge", "point_read")}
    assert all(launches.values()), launches
    assert report.drift[(0, "online")].retunes >= 1
    calls["replayed"] = []
    where["dev"] = "cpu"
    monkeypatch.setattr(session, "retune_fleet", replay)
    plan = api.compile_spec(spec).build_drift(report)
    results, _ = execute_drift(plan, device="cpu")
    assert len(calls["replayed"]) == len(storms) >= 2
    assert calls["cpu"] == calls["cuda"] and calls["cuda"]
    for key, res in report.drift.items():
        a = [dataclasses.asdict(r) for r in res.records]
        b = [dataclasses.asdict(r) for r in results[key].records]
        for ra, rb in zip(a, b):
            for k in ra:
                np.testing.assert_array_equal(np.asarray(ra[k]),
                                              np.asarray(rb[k]))
        assert len(a) == len(b) == 4


def test_adversary_on_card_matches_cpu_from_the_same_tunings(dev,
                                                            monkeypatch):
    """The scenarios suite's adversary (20,000 keys, 4 segments of 300
    queries, a small first tuning) on the card, each window's attack
    recorded with the defender state it read; the same attack on the CPU
    from that state gives the card's regret record to rel 1e-5,
    ``le_dual_bound`` equal, and the claim holds on every window."""
    import dataclasses

    import repro_torch.api as api
    from repro_torch.bench import scenarios
    from repro_torch.scenarios import AdversaryScenario
    from repro_torch.scenarios.adversary import record_mismatches
    args, = [a for a in scenarios.SCENARIOS if a[0] == "adversary"]
    spec = scenarios.make_spec(*args, 20_000, 4, 300)
    spec = dataclasses.replace(
        spec, design=api.DesignSpec(n_starts=16, steps=60, seed=0),
        drift=dataclasses.replace(spec.drift, retune_starts=8,
                                  retune_steps=40))
    attacks = []
    real = AdversaryScenario.attack

    def record(self, phi, w_center, rho_live, sys, device=None):
        out = real(self, phi, w_center, rho_live, sys, device=device)
        attacks.append((self, phi, np.array(w_center), rho_live, sys,
                        device, dict(out[1])))
        return out

    monkeypatch.setattr(AdversaryScenario, "attack", record)
    report = api.run_experiment(spec, device="cuda")
    monkeypatch.setattr(AdversaryScenario, "attack", real)
    assert len(attacks) == len(report.regret[0]) == 4
    for scen, phi, w, rho, sys, device, card in attacks:
        assert device == "cuda"
        _, cpu = scen.attack(phi, w, rho, sys, device="cpu")
        assert card["le_dual_bound"] is True
        assert record_mismatches(cpu, card) == [], (cpu, card)


def test_memory_on_card_matches_cpu_from_the_same_tunings(dev, monkeypatch):
    """A small skew_flip memory run (two tenants of 20,000 keys, 4
    segments of 500 queries) on the card, then its plan on the CPU with
    every arbiter storm answered by the card's (its share checked): the
    same segment records, division events and ``LSMTree.retune`` calls;
    the card's storms launch ``dual_solve``, its trees ``merge`` and
    ``point_read``."""
    import dataclasses

    import repro_torch.api as api
    from repro_torch.bench import memory
    from repro_torch.lsm import LSMTree
    from repro_torch.online import execute_memory_fleet
    from repro_torch.online import memory as arbiter
    spec = memory.make_spec("skew_flip", memory.SCENARIOS[0][1],
                            n_keys=20_000, segments=4, seg_queries=500)
    spec = dataclasses.replace(
        spec, design=api.DesignSpec(n_starts=16, steps=60, seed=0),
        drift=dataclasses.replace(spec.drift, retune_starts=8,
                                  retune_steps=40))
    storms, calls = [], {"cuda": [], "cpu": [], "replayed": []}
    real_fleet, real_retune = arbiter.retune_fleet, LSMTree.retune
    where = {"dev": "cuda"}

    def record(requests, sys, **kw):
        out = real_fleet(requests, sys, **kw)
        storms.append((requests, out, sys.bits_per_entry))
        return out

    def replay(requests, sys, **kw):
        want, out, share = storms[len(calls["replayed"])]
        calls["replayed"].append(requests)
        assert sys.bits_per_entry == share
        assert [(list(a.w), a.rho, a.reason) for a in requests] \
            == [(list(b.w), b.rho, b.reason) for b in want]
        return out

    def retune(tree, phi, sys):
        real_retune(tree, phi, sys)
        calls[where["dev"]].append((tree.obs_label, tree.cfg.T,
                                    tree.cfg.K, tree.cfg.buf_entries,
                                    tree.cfg.mfilt_bits_per_entry))

    monkeypatch.setattr(LSMTree, "retune", retune)
    monkeypatch.setattr(arbiter, "retune_fleet", record)
    before = dict(_build.LAUNCHES)
    report = api.run_experiment(spec, device="cuda")
    launches = {k: _build.LAUNCHES[k] - before[k]
                for k in ("dual_solve", "merge", "point_read")}
    assert all(launches.values()), launches
    assert any(e["segment"] >= 0 for e in report.memory_events)
    where["dev"] = "cpu"
    monkeypatch.setattr(arbiter, "retune_fleet", replay)
    plan = api.compile_spec(spec).build_memory(report)
    results, events = execute_memory_fleet(plan, device="cpu")
    assert len(calls["replayed"]) == len(storms) >= 3
    assert events == report.memory_events
    assert calls["cpu"] == calls["cuda"] and calls["cuda"]
    for key, res in report.memory.items():
        a = [dataclasses.asdict(r) for r in res.records]
        b = [dataclasses.asdict(r) for r in results[key].records]
        for ra, rb in zip(a, b):
            for k in ra:
                np.testing.assert_array_equal(np.asarray(ra[k]),
                                              np.asarray(rb[k]))
        assert len(a) == len(b) == 4


def test_robust_layout_sweep_on_card_matches_cpu(dev):
    """``robust_layout_sweep`` over 64 seeded synthetic candidates x six
    rhos on the card and the CPU: the same picks, the worst-case grids
    within rel 1e-5, and ``adversarial_mix`` within 1e-5."""
    from repro_torch.core import robust_sharding as rs
    rng = np.random.default_rng(1)
    base = rng.uniform(0.5, 2.0, 64)
    costs = base[:, None] * rng.uniform(0.8, 1.2, (64, 4))
    costs[np.arange(64), rng.integers(0, 4, 64)] *= 1.0 + 40.0 / base ** 3
    mix = rng.dirichlet(np.ones(4) * 2.0)
    rhos = (0.1, 0.25, 0.5, 1.0, 2.0, 3.0)
    out = {}
    for d in ("cuda", "cpu"):
        cands = [rs.LayoutCandidate(f"c{i}", c) for i, c in enumerate(costs)]
        out[d] = (rs.worst_case_grid(cands, mix, rhos, device=d),
                  [c.name for c in rs.robust_layout_sweep(cands, mix, rhos,
                                                          device=d)],
                  rs.adversarial_mix(cands[0], mix, 1.0, device=d))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    assert out["cuda"][1] == out["cpu"][1]
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], atol=1e-5)


def test_retune_storm_on_card_pads_without_moving_results(dev):
    """A storm of five requests (two nominal, three robust at two budgets)
    on the card, padded to powers of two and not: the same tunings bit
    for bit; the robust grid launches ``dual_solve`` once per Adam step
    plus one."""
    from repro_torch.checkpoint.store import retune_storm
    W = np.array([[0.1, 0.1, 0.1, 0.7], [0.33, 0.33, 0.33, 0.01],
                  [0.475, 0.475, 0.04, 0.01], [0.2, 0.5, 0.2, 0.1],
                  [0.6, 0.2, 0.1, 0.1]])
    rhos = [0.0, 0.3, 0.3, 0.6, 0.0]
    sys_t = core.LSMSystem()
    out = {}
    for pad in (False, True):
        before = _build.LAUNCHES["dual_solve"]
        out[pad] = retune_storm(W, rhos, sys_t, n_starts=8, steps=30,
                                pad_pow2=pad, device="cuda")
        assert _build.LAUNCHES["dual_solve"] - before == 30 + 1
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a.phi.T, b.phi.T)
        assert torch.equal(a.phi.K, b.phi.K)
        assert torch.equal(a.phi.mfilt_bits, b.phi.mfilt_bits)
        assert a.cost == b.cost


def _chaos_spec():
    """The faults suite's spec at a small size, on the subprocess backend
    under its chaos schedule (a crash on shard 0, a corrupt result on
    shard 1)."""
    import dataclasses

    from repro_torch.bench import faults
    spec = dataclasses.replace(
        faults.make_spec(),
        trial=dataclasses.replace(faults.make_spec().trial, n_keys=6000,
                                  n_queries=400))
    return spec, faults.chaos_spec(spec)


def test_subprocess_chaos_on_card_matches_inline_and_cpu(dev):
    """Workers on the card: the chaos trial's IOStats, I/O per query and
    probes are the inline card trial's and the CPU trial's, and the
    workers' merge and point_read launches reach the parent's counts,
    equal to the same shards run in this process on the card."""
    import repro_torch.api as api
    from repro_torch.api import backends
    from repro_torch.bench.faults import trial_signature as trial
    spec, chaos_spec = _chaos_spec()

    inline = api.run_experiment(spec, device=dev)
    cpu = api.run_experiment(spec, device="cpu")
    _build.reset_launches()
    chaos = api.run_experiment(chaos_spec, device=dev)
    worker_launches = {k: _build.LAUNCHES[k]
                       for k in ("merge", "point_read", "dual_solve")}
    print("attempt latencies:", chaos.shard_attempts)
    assert chaos.walls["shard_retries"] == 2 and not chaos.failed_cells
    assert trial(chaos) == trial(inline) == trial(cpu)
    assert worker_launches["dual_solve"] == 0
    assert worker_launches["merge"] > 0 and worker_launches["point_read"] > 0
    cx = api.compile_spec(spec)
    plan = cx.build_trial(cx.select_arms({}))
    sub = backends.SubprocessBackend(workers=2)
    _build.reset_launches()
    for shard in sub._partition(plan):
        api.execute_trial(plan, [plan.trees[t] for t in shard], device=dev)
    assert {k: _build.LAUNCHES[k] for k in worker_launches} \
        == worker_launches


def _reduced_train_state(arch, device):
    from repro_torch.launch import train as TT
    from repro_torch.optim import adamw
    from repro_torch.utils.tree import tree_map
    cfg = TT.train_config(arch, reduced=True)
    params = tree_map(lambda t: t.detach().to(device).clone(),
                      build_model(cfg, "cpu", seed=0).params)
    model = build_model(cfg, torch.device(device), params=params)
    model.requires_grad_(True)
    opt_cfg = adamw.AdamWConfig(schedule=adamw.cosine_schedule(10, 30))
    step = TT.make_train_step(model, opt_cfg, cfg)
    return cfg, model, step, adamw.init(model.params)


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-3b",
                                  "deepseek-moe-16b",
                                  "jamba-1.5-large-398b", "whisper-base",
                                  "qwen2-vl-72b"])
def test_reduced_train_steps_on_card_match_cpu(dev, arch):
    """Three float32 train steps of the reduced model from the same
    weights and batches: losses and MoE aux rel 1e-5, gradient norms rel
    1e-4 (sums in
    another order), parameters within 6 lr (3 steps of AdamW, which moves a
    weight whose gradient rounds differently by up to 2 lr a step)."""
    from repro_torch.data.pipeline import DataConfig, shard_batch_at
    from repro_torch.launch import train as TT
    from repro_torch.utils.tree import leaves
    runs = {}
    for device in ("cpu", "cuda"):
        cfg, model, step, opt = _reduced_train_state(arch, device)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                          global_batch=4)
        params, mets = model.params, []
        _build.reset_launches()
        for s in range(3):
            batch = TT._prep_batch(shard_batch_at(dcfg, s, 0, 1), model,
                                   device)
            params, opt, m = step(params, opt, batch)
            mets.append({k: float(v) for k, v in m.items()})
        assert not any(_build.LAUNCHES.values())     # "plain": no kernel
        runs[device] = (mets, [p.detach().cpu() for p in leaves(params)])
    for a, b in zip(runs["cpu"][0], runs["cuda"][0]):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-5)
        assert b["aux"] == pytest.approx(a["aux"], rel=1e-5)
        assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=1e-4)
    for a, b in zip(runs["cpu"][1], runs["cuda"][1]):
        torch.testing.assert_close(b, a, atol=6 * 3e-4, rtol=0)


def test_checkpoint_store_on_card_matches_cpu(dev, tmp_path):
    """A store on the card (its manifest tuned and run there) and one on
    the CPU with the card's tuning: the same saves and lookups give the
    same ``IOStats``, shape and entries, through the card's ``merge`` and
    ``point_read`` launches."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.lsm import LSMTree
    card = CheckpointStore.create(str(tmp_path / "card"), device=dev)
    cpu = CheckpointStore(root=tmp_path / "cpu", manifest=LSMTree(
        card.manifest.cfg, device="cpu"))
    cpu.root.mkdir()
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(8, 4, generator=gen),
            "layers": [{"a": torch.randn(3, generator=gen)}
                       for _ in range(20)]}
    _build.reset_launches()
    for step in range(12):
        for s in (card, cpu):
            s.heartbeat(0, step, float(step))
            s.save(step, tree, data_state={"step": step + 1})
        assert card.manifest.stats.as_dict() == cpu.manifest.stats.as_dict()
        assert card.manifest.shape() == cpu.manifest.shape()
    assert _build.LAUNCHES["merge"] > 0
    assert card.latest_step() == cpu.latest_step() == 11
    assert _build.LAUNCHES["point_read"] > 0
    back, meta = card.restore(tree)
    assert meta == cpu.restore(tree)[1]
    assert back["w"].device.type == "cuda"
    assert torch.equal(back["w"].cpu(), tree["w"])
    assert card.manifest.stats.as_dict() == cpu.manifest.stats.as_dict()


def test_kernels_suite_on_card_holds_the_committed_counts(dev):
    """The ``kernels`` suite on the card: every held field of
    ``BENCH_kernels.json`` (the counts and effective bytes), each
    data-plane kernel launched."""
    from repro_torch.bench import run
    _build.reset_launches()
    res = run.run_suite("kernels", device="cuda", baseline_dir=run.REPO_ROOT)
    assert res["comparison"]["missed"] == []
    assert len(res["comparison"]["held"]) == 16
    assert all(_build.LAUNCHES[k] for k in ("dual_solve", "merge",
                                            "point_read"))


def test_dryrun_decode_cell_traces_on_a_cuda_mesh(dev, monkeypatch):
    """The dry run's fake tensors on the card's device type: a full-size
    decode cell over 256 fake ranks traces with no device memory."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "MESH_DEVICE", "cuda")
    before = torch.cuda.memory_allocated()
    rec = dryrun.run_cell("qwen3-14b", "decode_32k", "single", save=False,
                          verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["trace"]["flops_per_dev"] > 0
    assert torch.cuda.memory_allocated() == before
    assert not dist.is_initialized()
