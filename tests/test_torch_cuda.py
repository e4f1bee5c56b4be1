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
