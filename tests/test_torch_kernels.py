"""The port's three kernels (``repro_torch.kernels``) against the JAX
package's, at small sizes on the CPU.

On the CPU each ``ops.py`` wrapper runs its kernel's plain PyTorch version
(``ref.py``).  Each is held against the JAX package's plain reference and
against its Pallas kernel in interpret mode (``kernel.py`` called directly
under ``jax.enable_x64``), on the same numpy inputs:

* ``dual_solve``: values to rel 1e-5 on every lane; log lambda to abs 1e-5
  on >= 99% of lanes and within 0.1 on all (a golden-section comparison may
  flip on a 1-ulp difference of exp/log and move log lambda by up to the
  final bracket width, 1.6 * 0.618**6 ~ 0.09, while the value moves only to
  second order).  Observed here against both: value rel <= 1.5e-6, log
  lambda within 1e-5 on 99.67% of the 300-lane case (one lane flipped,
  by 0.045).  The backward matches ``jax.grad`` to rel 1e-5.
* ``merge`` and ``point_read``: bit-identical.

The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
compares them with the plain versions there.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dual_solve.kernel import dual_solve_warm_kernel
from repro.kernels.dual_solve.ops import dual_solve_warm_batch as jax_dual
from repro.kernels.dual_solve.ops import dual_solve_warm_fused
from repro.kernels.merge.kernel import two_way_merge_kernel
from repro.kernels.point_read.kernel import point_read_level_kernel
from repro.lsm import bloom as jbloom
from repro.lsm.merge_path import merge_runs_numpy
from repro.lsm.read_path import point_read_level_numpy
from repro.lsm.store import TOMB, LevelStore, RunData
from repro_torch.kernels.dual_solve.ops import (dual_solve_warm,
                                                dual_solve_warm_batch)
from repro_torch.kernels.dual_solve.ref import dual_solve_warm_ref
from repro_torch.kernels.merge.ops import merge_runs, two_way_merge
from repro_torch.kernels.point_read.ops import point_read_level
from repro_torch.lsm import bloom as tbloom
from repro_torch.lsm import store as tstore
from repro_torch.utils import u64

REPO = pathlib.Path(__file__).resolve().parent.parent


def _u64_keys(rng, n):
    """n sorted unique keys drawn from the whole uint64 range."""
    keys = np.unique(rng.integers(0, 2 ** 64 - 1, 2 * n + 16,
                                  dtype=np.uint64, endpoint=True))
    return np.sort(rng.choice(keys, n, replace=False))


# ---------------------------------------------------------------------------
# dual_solve
# ---------------------------------------------------------------------------

def _dual_inputs(L, n=4, seed=0, shared_w=False):
    rng = np.random.default_rng(seed)
    C = rng.gamma(2.0, 2.0, (L, n)).astype(np.float32)
    W = (rng.dirichlet(np.ones(n)) if shared_w
         else rng.dirichlet(np.ones(n), L)).astype(np.float32)
    rho = rng.uniform(0.0, 3.0, L).astype(np.float32)
    rho[::5] = 0.0                                   # nominal lanes
    span = C.max(1) - C.min(1)
    llam = (np.log(span) + rng.normal(0, 1.5, L)).astype(np.float32)
    return C, W, rho, llam


def _check_dual(val, lnew, val_ref, lnew_ref):
    val, lnew = np.asarray(val), np.asarray(lnew)
    rel = np.abs(val - val_ref) / np.abs(val_ref)
    assert rel.max() <= 1e-5, rel.max()
    dl = np.abs(lnew - lnew_ref)
    assert (dl <= 1e-5).mean() >= 0.99, (dl <= 1e-5).mean()
    assert dl.max() <= 0.1, dl.max()


@pytest.mark.parametrize("L,n,shared_w", [(300, 4, False), (129, 4, True),
                                          (64, 7, False), (1, 4, False)])
def test_dual_solve_plain_vs_jax_fused_and_pallas(L, n, shared_w):
    C, W, rho, llam = _dual_inputs(L, n, seed=L + n, shared_w=shared_w)
    val, lnew = dual_solve_warm_batch(*map(torch.from_numpy,
                                           (C, W, rho, llam)))
    fv, fl = jax_dual(C, W, rho, llam, impl="fused")
    _check_dual(val, lnew, np.asarray(fv), np.asarray(fl))
    Wb = np.broadcast_to(W, C.shape)
    kv, kl = dual_solve_warm_kernel(jnp.asarray(C), jnp.asarray(Wb),
                                    jnp.asarray(rho), jnp.asarray(llam),
                                    interpret=True)
    _check_dual(val, lnew, np.asarray(kv), np.asarray(kl))


def test_dual_solve_backward_matches_jax_grad():
    """The autograd.Function's envelope gradient == jax.grad of the fused
    path (rel 1e-5), and == autograd through the plain version."""
    C, W, rho, llam = _dual_inputs(200, seed=3)

    def jax_total(c):
        v, _ = jax.vmap(dual_solve_warm_fused)(c, jnp.asarray(W),
                                                jnp.asarray(rho),
                                                jnp.asarray(llam))
        return jnp.sum(v * jnp.arange(1, 201, dtype=jnp.float32))

    g_ref = np.asarray(jax.grad(jax_total)(jnp.asarray(C)))
    weights = torch.arange(1, 201, dtype=torch.float32)
    for fn in (dual_solve_warm, dual_solve_warm_ref):
        c = torch.from_numpy(C).requires_grad_(True)
        v, _ = fn(c, torch.from_numpy(W), torch.from_numpy(rho),
                  torch.from_numpy(llam))
        (v * weights).sum().backward()
        g = c.grad.numpy()
        np.testing.assert_allclose(g, g_ref, rtol=1e-5, atol=1e-7,
                                   err_msg=fn.__name__)


@pytest.mark.parametrize("n", [1, 3, 4, 6])
def test_dual_solve_dc_matches_jax_grad(n):
    """The plain version's envelope gradient ``dc`` (the kernel's third
    output) == ``jax.grad`` of the JAX package's vmapped fused solve, on
    257 lanes, one in five with rho = 0 (dc = w there), at rel 1e-5; and
    the wrapper's CPU path returns the same ``dc``."""
    C, W, rho, llam = _dual_inputs(257, n, seed=40 + n)
    assert (rho == 0).sum() > 50
    if n == 1:              # a span of 0: log lambda from no span at all
        llam = np.random.default_rng(n).normal(0, 1.5, 257).astype(
            np.float32)

    def jax_total(c):
        v, _ = jax.vmap(dual_solve_warm_fused)(c, jnp.asarray(W),
                                                jnp.asarray(rho),
                                                jnp.asarray(llam))
        return jnp.sum(v)

    want = np.asarray(jax.grad(jax_total)(jnp.asarray(C)))
    args = [torch.from_numpy(a) for a in (C, W, rho, llam)]
    val, lnew, dc = dual_solve_warm_ref(*args, grad=True)
    assert dc.shape == (257, n) and dc.dtype == torch.float32
    np.testing.assert_allclose(dc.numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(dc.numpy()[rho == 0], W[rho == 0])
    got = dual_solve_warm_batch(*args, grad=True)
    for a, b in zip(got, (val, lnew, dc)):
        assert torch.equal(a, b)


def _plain_backward(C, W, rho, lnew, g_val):
    """The port's backward before the forward wrote ``dc``: the softmax
    recomputed from the saved inputs at the returned log lambda."""
    W = W.expand_as(C)
    lam = torch.clamp(torch.exp(lnew), min=1e-12)
    x = torch.log(W) + C / lam[:, None]
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    dc = torch.where((rho <= 0.0)[:, None], W, e / e.sum(-1, keepdim=True))
    return g_val[:, None] * dc


@pytest.mark.parametrize("n,shared_w", [(4, False), (4, True), (6, False)])
def test_dual_solve_autograd_uses_the_saved_dc(n, shared_w):
    """``DualSolveWarm``'s gradient, the saved ``dc`` times the incoming
    gradient, equals the plain backward it replaced on the same inputs."""
    C, W, rho, llam = _dual_inputs(257, n, seed=7 + n, shared_w=shared_w)
    c = torch.from_numpy(C).requires_grad_(True)
    Wt, rt, lt = (torch.from_numpy(a) for a in (W, rho, llam))
    v, lnew = dual_solve_warm(c, Wt, rt, lt)
    g_val = torch.linspace(-2.0, 3.0, 257)
    (v * g_val).sum().backward()
    want = _plain_backward(torch.from_numpy(C), Wt, rt, lnew, g_val)
    np.testing.assert_allclose(c.grad.numpy(), want.numpy(), rtol=1e-6,
                               atol=0)


def test_dual_solve_group_sizes_match_the_wrapper():
    """The kernel's thread groups, as its constants and its comment state
    them, take the cost vectors the wrapper lets through: the small group
    is 4 threads, the large one 16 (one component each), and the large
    group with ``kPartsWide`` components a thread reaches ``N_MAX``."""
    import re
    from repro_torch.kernels.dual_solve import ops as dual_ops
    src = (REPO / "src/repro_torch/csrc/dual_solve.cu").read_text()
    small = int(re.search(r"kGroupSmall = (\d+);", src).group(1))
    large = int(re.search(r"kGroupLarge = (\d+);", src).group(1))
    wide = int(re.search(r"kPartsWide = (\d+);", src).group(1))
    assert (small, large) == (4, 16)
    assert large * wide == dual_ops.N_MAX
    text = " ".join(" ".join(ln.strip().lstrip("/") for ln in
                             src.splitlines()).split())
    assert f"kGroupSmall = {small} threads for n <= {small}" in text
    assert f"kGroupLarge = {large} for n <= {large}" in text
    assert f"P = kPartsWide = {wide} components a thread for n <= " \
        f"{dual_ops.N_MAX}" in text
    assert 32 % large == 0 and large % small == 0


def test_dual_solve_wrapper_checks_inputs():
    C, W, rho, llam = map(torch.from_numpy, _dual_inputs(8))
    with pytest.raises(ValueError):
        dual_solve_warm_batch(C, W[:3], rho, llam)
    with pytest.raises(TypeError):
        dual_solve_warm_batch(C.double(), W, rho, llam)


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

def _merge_cases():
    rng = np.random.default_rng(5)
    big = _u64_keys(rng, 900)
    high = big[big >= np.uint64(1 << 63)]
    return {
        "duplicates": [np.arange(0, 300, 3), np.arange(0, 300, 2),
                       np.arange(100, 400, 5)],
        "empty_runs": [np.array([], np.uint64), np.arange(10, 20),
                       np.array([], np.uint64), np.arange(15, 40)],
        "high_keys": [big[::3], big[1::3], high[::2], big[:50]],
        "single": [np.array([7]), np.array([7]), np.array([2 ** 64 - 1])],
        "all_empty": [np.array([], np.uint64)] * 2,
    }


@pytest.mark.parametrize("case", sorted(_merge_cases()))
def test_merge_fold_bit_equal_to_merge_runs_numpy(case):
    runs = [np.asarray(r, np.uint64) for r in _merge_cases()[case]]
    vals = [np.arange(len(r), dtype=np.int64) * 2 + 1 + 10_000 * i
            for i, r in enumerate(runs)]
    ref_k, ref_v = merge_runs_numpy(runs, vals)
    k, v = merge_runs([u64.to_device_keys(r, "cpu") for r in runs],
                      [torch.from_numpy(x) for x in vals])
    np.testing.assert_array_equal(u64.unorder_keys(k), ref_k)
    np.testing.assert_array_equal(v.numpy(), ref_v)


@pytest.mark.parametrize("na,nb,dups", [(37, 91, True), (128, 128, False),
                                        (1, 0, False), (0, 5, False),
                                        (200, 3, True)])
def test_two_way_merge_bit_equal_to_pallas_interpret(na, nb, dups):
    rng = np.random.default_rng(na * 7 + nb)
    pool = _u64_keys(rng, 600)
    a = np.sort(rng.choice(pool, na, replace=False))
    b = np.sort(rng.choice(pool if dups else np.setdiff1d(pool, a), nb,
                           replace=False))
    av = np.arange(na, dtype=np.int64)
    bv = np.arange(nb, dtype=np.int64) + 1000
    k, v = two_way_merge(u64.to_device_keys(a, "cpu"), torch.from_numpy(av),
                         u64.to_device_keys(b, "cpu"), torch.from_numpy(bv))
    if na and nb:
        with jax.enable_x64(True):
            pk, pv = two_way_merge_kernel(
                jnp.asarray(a, jnp.uint64), jnp.asarray(av),
                jnp.asarray(b, jnp.uint64), jnp.asarray(bv), interpret=True)
            pk, pv = np.asarray(pk), np.asarray(pv)
    else:         # the Pallas kernel takes no empty run: the other run
        pk, pv = np.concatenate([a, b]), np.concatenate([av, bv])
    np.testing.assert_array_equal(u64.unorder_keys(k), pk)
    np.testing.assert_array_equal(v.numpy(), pv)


# ---------------------------------------------------------------------------
# point_read
# ---------------------------------------------------------------------------

def _levels(run_specs, bpk=8.0):
    """(reference LevelStore, port LevelStore) from newest-first specs."""
    runs = [RunData.build(np.asarray(k, np.uint64), np.asarray(v, np.int64),
                          bpk, flushes=1) for k, v in run_specs]
    ref = LevelStore()
    ref._set_runs(runs)
    port = tstore.LevelStore("cpu")
    port._set_runs([tstore.RunData.build(
        u64.to_device_keys(r.keys, "cpu"), torch.from_numpy(r.vals), bpk,
        flushes=1) for r in runs])
    return ref, port


def _assert_point_read_bit_equal(run_specs, q):
    q = np.asarray(q, np.uint64)
    ref_lv, port_lv = _levels(run_specs)
    hit, enc, probes, reads, fps = point_read_level(
        u64.to_device_keys(q, "cpu"), port_lv.keys, port_lv.vals,
        port_lv.pack)
    rh, re, rp, rr, rf = point_read_level_numpy(ref_lv, q)
    np.testing.assert_array_equal(hit.numpy(), rh)
    np.testing.assert_array_equal(enc.numpy()[rh], re[rh])
    assert (int(probes.sum()), int(reads.sum()), int(fps.sum())) \
        == (rp, rr, rf)
    if len(q) == 0 or len(ref_lv.keys) == 0:
        return
    pack = ref_lv.pack
    with jax.enable_x64(True):
        out = point_read_level_kernel(
            jnp.asarray(q, jnp.uint64), jnp.asarray(ref_lv.keys, jnp.uint64),
            jnp.asarray(ref_lv.vals), jnp.asarray(pack.words, jnp.uint64),
            tuple(int(s) for s in ref_lv.starts),
            tuple(int(b) for b in pack.n_bits),
            tuple(int(k) for k in pack.ks),
            tuple(int(k) for k in ref_lv.min_keys),
            tuple(int(k) for k in ref_lv.max_keys), interpret=True)
        out = [np.asarray(o) for o in out]
    for name, mine, pallas in zip(("hit", "probes", "reads", "fps"),
                                  (hit, probes, reads, fps),
                                  (out[0], out[2], out[3], out[4])):
        np.testing.assert_array_equal(mine.numpy(), pallas, err_msg=name)
    np.testing.assert_array_equal(enc.numpy()[out[0]], out[1][out[0]])


def test_point_read_multi_run_level_bit_equal():
    rng = np.random.default_rng(0)
    pool = rng.choice(1 << 48, 3000, replace=False).astype(np.uint64)
    specs = [(np.sort(pool[:900]), np.arange(900)),
             (np.sort(pool[900:1100]), np.arange(200) + 10_000),
             (np.sort(pool[1100:2400]), np.arange(1300) + 50_000)]
    q = np.concatenate([pool[rng.integers(0, 2400, 120)],
                        pool[2400:2470], pool[:10]])
    _assert_point_read_bit_equal(specs, q)


def test_point_read_overlapping_runs_newest_wins():
    keys = np.arange(100, 200, dtype=np.uint64)
    specs = [(keys[:60], np.full(60, 1)), (keys[20:80], np.full(60, 2)),
             (keys, np.full(100, 3))]
    _assert_point_read_bit_equal(specs, keys)


@pytest.mark.parametrize("case", ["empty_run", "single_entry",
                                  "all_tombstone", "odd_batch",
                                  "high_keys"])
def test_point_read_edge_cases(case):
    rng = np.random.default_rng(len(case))
    if case == "empty_run":
        specs = [(np.arange(10, 20), np.arange(10)), ([], []),
                 (np.arange(15, 40), np.arange(25))]
        q = np.arange(5, 45)
    elif case == "single_entry":
        specs = [([7], [70]), ([7], [71]), ([9], [90])]
        q = np.array([7, 8, 9, 7])
    elif case == "all_tombstone":
        keys = np.arange(50, 80, dtype=np.uint64)
        specs = [(keys, np.full(30, TOMB)), (keys, np.arange(30))]
        q = np.arange(40, 90)
    elif case == "odd_batch":
        keys = np.sort(rng.choice(1 << 32, 500, replace=False)
                       .astype(np.uint64))
        specs = [(keys[::2], np.arange(250))]
        q = rng.choice(keys, 37)
    else:                           # keys >= 2**63 (signed order differs)
        keys = _u64_keys(rng, 800)
        specs = [(keys[::3], np.arange(267)), (keys[1::2], np.arange(400))]
        q = np.concatenate([keys[::5], _u64_keys(rng, 50)])
    _assert_point_read_bit_equal(specs, q)


def test_point_read_empty_level_and_empty_batch():
    _assert_point_read_bit_equal([(np.arange(5), np.arange(5))],
                                 np.empty(0, np.uint64))
    _assert_point_read_bit_equal([([], []), ([], [])],
                                 np.arange(3, dtype=np.uint64))


# ---------------------------------------------------------------------------
# the 64-bit codec and the Bloom words it builds
# ---------------------------------------------------------------------------

def test_u64_codec_matches_numpy_uint64():
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.integers(0, 2 ** 63, 500, dtype=np.uint64) * 2
                        + rng.integers(0, 2, 500, dtype=np.uint64),
                        np.array([0, 1, 2 ** 63, 2 ** 64 - 1], np.uint64)])
    bits = torch.from_numpy(x.view(np.int64))
    for seed in (1, 2, 7):
        ref = jbloom.splitmix64(x, np.uint64(seed))
        np.testing.assert_array_equal(
            u64.splitmix64(bits, seed).numpy().view(np.uint64), ref)
    for n in (64, 1000, 12_345_677, 2 ** 61 + 3):
        np.testing.assert_array_equal(
            u64.umod(bits, n).numpy().view(np.uint64), x % np.uint64(n))
    np.testing.assert_array_equal(u64.lsr(bits, 7).numpy().view(np.uint64),
                                  x >> np.uint64(7))
    ok = u64.to_device_keys(x, "cpu")
    np.testing.assert_array_equal(u64.unorder_keys(ok), x)
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(torch.argsort(ok, stable=True).numpy(),
                                  order)


@pytest.mark.parametrize("n,bpk", [(1, 8.0), (777, 5.5), (3000, 12.0)])
def test_bloom_words_bit_equal(n, bpk):
    rng = np.random.default_rng(n)
    keys = _u64_keys(rng, n)
    n_bits, k = tbloom.bloom_params(n, bpk)
    assert (n_bits, k) == jbloom.bloom_params(n, bpk)
    words = tbloom.build_words(u64.to_device_keys(keys, "cpu"), n_bits, k)
    np.testing.assert_array_equal(words.numpy().view(np.uint64),
                                  jbloom.build_words(keys, n_bits, k))


# ---------------------------------------------------------------------------
# what the port imports, and what runs only on the card
# ---------------------------------------------------------------------------

def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Nor the JAX package's suites (``benchmarks``): the port's runner,
    ``repro_torch.bench``, reads their committed results as data only."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    assert {"base.py", "library.py", "adversary.py"} <= {
        p.name for p in files if p.parent.name == "scenarios"}
    by_dir = {}
    for p in files:
        by_dir.setdefault(p.parent.name, set()).add(p.name)
    assert {"retry.py", "artifacts.py", "spec.py"} <= by_dir["faults"]
    assert {"core.py", "trace.py", "calibrate.py"} <= by_dir["obs"]
    assert {"faults.py", "obs.py"} <= by_dir["bench"]
    assert {"pipeline.py"} <= by_dir["data"]
    assert {"adamw.py", "compression.py"} <= by_dir["optim"]
    assert {"train.py", "elastic.py", "serve.py"} <= by_dir["launch"]
    assert {"tree.py"} <= by_dir["utils"]
    assert "train_lm.py" in by_dir["repro_torch"]
    for path in files:
        roots = set(_imported_roots(path))
        bad = roots & {"jax", "jaxlib", "repro", "flax", "optax",
                       "benchmarks"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
    # the subprocess backend's worker command is code too
    from repro_torch.api import backends
    flag, code = backends.WORKER_CMD
    assert flag == "-c"
    tree = ast.parse(code)
    assert {n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom)} == {"repro_torch.api.backends"}
    assert not any(isinstance(n, ast.Import) for n in ast.walk(tree))


def test_wrappers_refuse_other_devices():
    meta = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        two_way_merge(meta, meta, meta, meta)
