"""The point read's sampled search (``csrc/point_read.cu``) on the CPU.

The kernel cannot run here, so its algorithm is held through its twin,
``repro_torch.kernels.point_read.ref.point_read_sampled_ref``: the Bloom
test with each hash reduced by the run's reciprocal (``utils/u64.py``'s
``umod_magic``), and per run with a sample, the lower bound found through
the top, the sample range and the window of ``stride`` keys.  At small
strides, sample thresholds and top capacities (so that a few hundred keys
cross every stage), the twin and the wrapper's CPU route must be
bit-identical to

* the JAX package's ``point_read_level_kernel`` in interpret mode, per key
  (hit, the value where hit, probes, reads, false positives);
* ``point_read_level_numpy``, the engine's reference (hits, values, the
  counters' sums).

Keys cross between the packages as numpy uint64 and enter the port in its
ordered int64 form.  Also here: the reciprocal modulo against Python's
``%``, the sample's layout and its rebuild when a level's runs change, and
the wrapper's routing (CUDA tensors to the C entry with the sample,
CPU tensors to the plain version), with recorders.
"""

import contextlib
import functools
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.point_read.kernel import point_read_level_kernel
from repro.lsm.read_path import point_read_level_numpy
from repro.lsm.store import TOMB, LevelStore, RunData
from repro_torch.kernels import _build
from repro_torch.kernels.point_read import ops as read_ops
from repro_torch.kernels.point_read.ref import point_read_sampled_ref
from repro_torch.lsm import store as tstore
from repro_torch.utils import u64

# (level 1's stride, the later levels' fanout, the least run that has a
# sample, the level's top capacity)
SAMPLES = [(2, 2, 1, 3), (4, 2, 16, 6), (8, 4, 8, 64), (3, 5, 4, 10)]
MASK64 = (1 << 64) - 1


def _u64_keys(rng, n):
    """n sorted unique keys over the whole uint64 range."""
    keys = np.unique(rng.integers(0, 2 ** 64 - 1, 2 * n + 16,
                                  dtype=np.uint64, endpoint=True))
    return np.sort(rng.choice(keys, n, replace=False))


def _case(name):
    """(newest-first run specs (keys, values), query keys) as uint64."""
    rng = np.random.default_rng(len(name))
    u = functools.partial(np.asarray, dtype=np.uint64)
    if name == "shorter_than_stride":
        specs = [([5], [50]), ([3, 9], [30, 90]), ([1, 4, 9], [1, 4, 9]),
                 ([2, 6, 7, 11, 13, 17, 19], np.arange(7))]
        return specs, np.arange(0, 22)
    if name == "stride_multiples":   # lengths 8k and 8k +- 1, 4k +- 1
        pool = _u64_keys(rng, 400)
        lens = [64, 63, 65, 33, 31, 16, 15, 9]
        specs, at = [], 0
        for n in lens:
            specs.append((np.sort(pool[at:at + n]), np.arange(n) + 1000 * n))
            at += n
        q = np.concatenate([pool[:at], _u64_keys(rng, 60)])
        return specs, rng.permutation(q)
    if name == "sample_and_fence_keys":
        keys = np.arange(1000, 1000 + 7 * 90, 7, dtype=np.uint64)
        specs = [(keys[::2], np.arange(45)), (keys[1::2], np.arange(45) + 99)]
        strided = np.concatenate([keys[::s] for s in (2, 4, 8, 16)])
        ends = np.concatenate([keys[[0, -2, -1, 1]], keys[[0, -1]] - 1,
                               keys[[0, -1]] + 1])
        return specs, np.concatenate([strided, strided + 1, ends])
    if name == "empty_runs":
        specs = [(np.arange(10, 40), np.arange(30)), ([], []),
                 (np.arange(25, 90, 2), np.arange(33)), ([], [])]
        return specs, np.arange(0, 100)
    if name == "overlapping":        # the newest run wins
        keys = np.arange(100, 260, dtype=np.uint64)
        specs = [(keys[:70], np.full(70, 1)), (keys[30:120], np.full(90, 2)),
                 (keys, np.full(160, 3))]
        return specs, np.concatenate([keys, keys[::3] + 1000])
    if name == "all_tombstone":
        keys = np.arange(50, 130, dtype=np.uint64)
        specs = [(keys, np.full(80, TOMB)), (keys[::2], np.arange(40))]
        return specs, np.arange(40, 140)
    if name == "high_keys":          # keys >= 2**63: signed order differs
        keys = _u64_keys(rng, 900)
        specs = [(keys[::3], np.arange(300)), (keys[1::2], np.arange(450))]
        return specs, np.concatenate([keys[::5], _u64_keys(rng, 80),
                                      u([2 ** 64 - 1, 2 ** 63, 0])])
    if name == "ten_runs":
        pool = _u64_keys(rng, 1500)
        specs = [(np.sort(rng.choice(pool, n, replace=False)),
                  np.arange(n) * 10 + r)
                 for r, n in enumerate([5, 40, 17, 120, 64, 0, 200, 33, 90,
                                        300])]
        return specs, np.concatenate([rng.choice(pool, 300),
                                      _u64_keys(rng, 50)])
    if name == "odd_batch":
        keys = np.sort(rng.choice(1 << 40, 700, replace=False)
                       .astype(np.uint64))
        specs = [(keys[::2], np.arange(350))]
        return specs, rng.choice(keys, 37)
    raise KeyError(name)


CASES = ["shorter_than_stride", "stride_multiples", "sample_and_fence_keys",
         "empty_runs", "overlapping", "all_tombstone", "high_keys",
         "ten_runs", "odd_batch"]


def _levels(specs, bpk=6.5):
    """(the JAX package's LevelStore, the port's, on the CPU)."""
    runs = [RunData.build(np.asarray(k, np.uint64), np.asarray(v, np.int64),
                          bpk, flushes=1) for k, v in specs]
    ref = LevelStore()
    ref._set_runs(runs)
    port = tstore.LevelStore("cpu")
    port._set_runs([tstore.RunData.build(
        u64.to_device_keys(r.keys, "cpu"), torch.from_numpy(r.vals), bpk,
        flushes=1) for r in runs])
    return ref, port


@functools.lru_cache(maxsize=None)
def _reference(name):
    """Case ``name`` through the JAX package: the Pallas kernel in
    interpret mode (per key) and ``point_read_level_numpy``."""
    specs, q = _case(name)
    q = np.asarray(q, np.uint64)
    ref_lv, _ = _levels(specs)
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
        pallas = [np.asarray(o) for o in out]
    return pallas, point_read_level_numpy(ref_lv, q)


def _assert_matches(name, got):
    hit, enc, probes, reads, fps = (t.numpy() for t in got)
    pallas, (rh, re_, rp, rr, rf) = _reference(name)
    for what, mine, theirs in zip(("hit", "probes", "reads", "fps"),
                                  (hit, probes, reads, fps),
                                  (pallas[0], pallas[2], pallas[3],
                                   pallas[4])):
        np.testing.assert_array_equal(mine, theirs, err_msg=what)
    np.testing.assert_array_equal(enc[hit], pallas[1][pallas[0]])
    np.testing.assert_array_equal(hit, rh)
    np.testing.assert_array_equal(enc[hit], re_[rh])
    assert (int(probes.sum()), int(reads.sum()), int(fps.sum())) \
        == (rp, rr, rf)


def _sampled_layout(lv, stride, fanout, min_run, top_cap):
    """The port level's layout with its sample rebuilt at these sizes."""
    p = lv.pack
    return read_ops.LevelLayout(
        starts=p.starts, n_bits=p.n_bits, ks=p.ks, fence_lo=p.fence_lo,
        fence_hi=p.fence_hi, word_off=p.word_off, words=p.words,
        **read_ops.sample_runs(lv.keys, p.starts, stride, fanout, min_run,
                               top_cap))


@pytest.mark.parametrize("stride,fanout,min_run,top_cap", SAMPLES)
@pytest.mark.parametrize("name", CASES)
def test_sampled_twin_bit_equal_to_pallas_interpret_and_numpy(
        name, stride, fanout, min_run, top_cap):
    specs, q = _case(name)
    _, lv = _levels(specs)
    layout = _sampled_layout(lv, stride, fanout, min_run, top_cap)
    assert any(layout.top_level) or name == "shorter_than_stride" \
        and min_run > 7
    got = point_read_sampled_ref(u64.to_device_keys(q, "cpu"), lv.keys,
                                 lv.vals, layout)
    _assert_matches(name, got)


@pytest.mark.parametrize("name", CASES)
def test_wrapper_on_cpu_bit_equal_to_pallas_interpret_and_numpy(name):
    specs, q = _case(name)
    _, lv = _levels(specs)
    got = read_ops.point_read_level(u64.to_device_keys(q, "cpu"), lv.keys,
                                    lv.vals, lv.pack)
    _assert_matches(name, got)


def test_every_stage_is_crossed():
    """At a small sample, the twin's keys reach each stage: runs with and
    without a sample, tops of more than one entry, levels below the top
    (so nodes are read, padding included), and windows cut by a run's
    end."""
    specs, _ = _case("stride_multiples")
    _, lv = _levels(specs)
    layout = _sampled_layout(lv, 4, 2, 16, 12)
    lens = np.diff(layout.starts)
    assert {f > 0 for f in layout.top_level} == {True, False}
    assert max(np.diff(layout.top_off)) > 1
    assert max(layout.top_level) >= 3
    assert (layout.sample == (1 << 63) - 1).any()
    assert any((n - 1) % 4 for n, f in zip(lens, layout.top_level) if f)
    assert any(n % 4 == 0 for n, f in zip(lens, layout.top_level) if f)


# ---------------------------------------------------------------------------
# the reciprocal modulo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 65, 127, 1000, 37_433_814, 2 ** 40 - 1,
                               2 ** 40, 2 ** 61 + 3])
def test_reciprocal_modulo_equals_python_mod_on_edges(n):
    xs = [0, 1, n - 1, n, n + 1, 2 * n - 1, 2 * n, MASK64, MASK64 - 1,
          2 ** 63, 2 ** 63 - 1, 2 ** 63 + 1]
    top = MASK64 // n
    xs += [top * n + d for d in (-1, 0, 1) if 0 <= top * n + d <= MASK64]
    xs += [k * n + d for k in (3, 2 ** 20 + 7, top - 1)
           for d in (-1, 0, 1) if k * n + d <= MASK64]
    x = np.asarray(xs, np.uint64)
    got = u64.umod_magic(torch.from_numpy(x.view(np.int64)), n,
                         u64.mod_magic(n))
    assert got.numpy().view(np.uint64).tolist() == [v % n for v in xs]


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.integers(0, MASK64), min_size=1, max_size=64),
       st.integers(64, 2 ** 40))
def test_reciprocal_modulo_property(xs, n):
    x = torch.from_numpy(np.asarray(xs, np.uint64).view(np.int64))
    got = u64.umod_magic(x, n, u64.mod_magic(n))
    assert got.numpy().view(np.uint64).tolist() == [v % n for v in xs]
    hi = u64.umulhi(x, u64.mod_magic(n)).numpy().view(np.uint64).tolist()
    assert hi == [(v * u64.mod_magic(n)) >> 64 for v in xs]


# ---------------------------------------------------------------------------
# the sample and the level's layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_cap", [read_ops.TOP_CAP, 300])
def test_sample_layout_of_a_level(top_cap):
    """Level l of a run keeps every (stride fanout**(l-1))-th key; the
    levels below the top are padded to whole nodes with the largest int64;
    the top is the first level within the run's share of the capacity."""
    rng = np.random.default_rng(3)
    lens = [50_000, 100, 0, 4096, 9001]
    pool = _u64_keys(rng, sum(lens))
    keys, starts = [], [0]
    for n in lens:
        keys.append(np.sort(rng.choice(pool, n, replace=False)))
        starts.append(starts[-1] + n)
    arena = u64.to_device_keys(np.concatenate(keys), "cpu")
    smp = read_ops.sample_runs(arena, starts, top_cap=top_cap)
    stride, fanout = read_ops.SAMPLE_STRIDE, read_ops.SAMPLE_FANOUT
    share = top_cap // 3

    def every(lvl):
        return stride * fanout ** (lvl - 1)

    assert smp["stride"] == stride
    assert smp["top_off"][-1] <= top_cap
    for r, n in enumerate(lens):
        s0, s1 = smp["sample_off"][r], smp["sample_off"][r + 1]
        t0, t1 = smp["top_off"][r], smp["top_off"][r + 1]
        f = smp["top_level"][r]
        if n < read_ops.SAMPLE_MIN_RUN:
            assert s0 == s1 and t0 == t1 and f == 0
            continue
        run = arena[starts[r]:starts[r + 1]]
        assert torch.equal(smp["top"][t0:t1], run[::every(f)])
        assert t1 - t0 <= share < (-(-n // every(f - 1)) if f > 1 else n)
        at = s0
        sizes = read_ops.level_sizes(n, stride, fanout)
        for lvl, size in enumerate(sizes[:f - 1], 1):
            level = smp["sample"][at:at + size]
            real = run[::every(lvl)]
            assert torch.equal(level[:len(real)], real)
            assert (level[len(real):] == (1 << 63) - 1).all()
            assert size % fanout == 0 and size - len(real) < fanout
            at += size
        assert at == s1


def _count_builds(monkeypatch):
    """Make CPU levels build their samples, as levels on the card do, and
    keep each run whose sample ``run_sample`` builds."""
    built = []
    inner = read_ops.run_sample
    monkeypatch.setattr(tstore, "builds_samples", lambda device: True)
    monkeypatch.setattr(read_ops, "run_sample",
                        lambda run, *a: built.append(run) or inner(run, *a))
    return built


def test_sample_is_rebuilt_when_the_level_changes(monkeypatch):
    rng = np.random.default_rng(4)
    keys = _u64_keys(rng, 12_000)
    _count_builds(monkeypatch)
    lv = tstore.LevelStore("cpu")

    def runs(*slices):
        return [tstore.RunData.build(
            u64.to_device_keys(k, "cpu"), torch.arange(len(k)), 5.0,
            flushes=1) for k in slices]

    lv._set_runs(runs(keys[::2]))
    first = lv.pack
    assert first is lv.pack                       # built once per layout
    assert first.top_level == [1]
    assert torch.equal(first.top, lv.keys[::read_ops.SAMPLE_STRIDE])
    lv._set_runs(runs(keys[1::3], keys[::2]))
    second = lv.pack
    assert second is not first
    want = read_ops.sample_runs(lv.keys, lv.starts.tolist())
    assert torch.equal(second.sample, want["sample"])
    assert second.sample_off == want["sample_off"]
    assert torch.equal(second.top, want["top"])
    assert second.top_level == want["top_level"]
    assert second.table().shape == (10, 3)


def test_cpu_store_builds_no_sample(monkeypatch):
    """A level on the CPU builds no sample (the plain read never reads
    one): its layout's sample fields are well formed and empty, and its
    reads are the plain version's."""
    rng = np.random.default_rng(9)
    keys = _u64_keys(rng, 20_000)
    built = []
    monkeypatch.setattr(read_ops, "run_sample",
                        lambda *a: built.append(a) or 1 / 0)
    lv = tstore.LevelStore("cpu")
    lv._set_runs([tstore.RunData.build(
        u64.to_device_keys(k, "cpu"), torch.arange(len(k)), 5.0, flushes=1)
        for k in (keys[::2], keys[1::4], keys[3::40])])
    p = lv.pack
    assert built == [] and lv.samples_list == [None] * 3
    assert p.sample.numel() == p.top.numel() == 0
    assert p.sample.dtype == p.top.dtype == torch.int64
    assert p.sample_off == p.top_off == [0] * 4
    assert p.top_level == [0] * 3
    assert p.table().shape == (10, 4)
    q = u64.to_device_keys(rng.choice(keys, 300), "cpu")
    got = read_ops.point_read_level(q, lv.keys, lv.vals, p)
    monkeypatch.undo()
    want = point_read_sampled_ref(q, lv.keys, lv.vals, _sampled_layout(
        lv, read_ops.SAMPLE_STRIDE, read_ops.SAMPLE_FANOUT,
        read_ops.SAMPLE_MIN_RUN, read_ops.TOP_CAP))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_packed_sample_after_flushes_and_compactions(monkeypatch):
    """A tree whose levels build their samples on the CPU's tensors (as on
    the card), through flushes, compactions and read batches: each level's
    packed sample is bit for bit ``sample_runs`` from scratch over the
    same arena."""
    import repro_torch.lsm as P
    built = _count_builds(monkeypatch)
    cfg = P.EngineConfig(T=3, K=(3, 2, 1, 1), buf_entries=4500,
                         expected_entries=60_000, mfilt_bits_per_entry=6.0)
    tree = P.LSMTree(cfg, device="cpu")
    keys = P.populate(tree, 60_000, seed=2)
    for s in range(3):
        P.run_session(tree, keys, np.array([0.2, 0.2, 0.1, 0.5]),
                      n_queries=20_000, seed=s)
    checked = 0
    for lv in tree.store.levels:
        if not lv.num_runs:
            continue
        p = lv.pack
        want = read_ops.sample_runs(lv.keys, lv.starts.tolist())
        for name in ("sample", "top"):
            assert torch.equal(getattr(p, name), want[name]), name
        for name in ("sample_off", "top_off", "top_level"):
            assert getattr(p, name) == want[name], name
        checked += any(p.top_level)
    assert checked >= 2 and len(built) >= 4


def test_unchanged_run_builds_its_sample_once(monkeypatch):
    """A run that stays in its level through later changes (a newer run
    placed in front, an older one dropped) keeps its sample: one build a
    run, and each layout is ``sample_runs`` from scratch."""
    rng = np.random.default_rng(10)
    keys = _u64_keys(rng, 40_000)
    built = _count_builds(monkeypatch)
    lv = tstore.LevelStore("cpu")

    def run(k):
        return tstore.RunData.build(u64.to_device_keys(k, "cpu"),
                                    torch.arange(len(k)), 5.0, flushes=1)

    a, b, c = keys[::3], keys[1::5], keys[2::7]
    lv._set_runs([run(a)])
    lv.pack
    lv._set_runs([run(b)] + lv.runs())
    lv.pack
    lv._set_runs([run(c)] + lv.runs()[:1] + [run(keys[:100])])
    p = lv.pack
    assert [len(r) for r in built] == [len(a), len(b), len(c)]
    want = read_ops.sample_runs(lv.keys, lv.starts.tolist())
    assert torch.equal(p.sample, want["sample"])
    assert torch.equal(p.top, want["top"])
    assert (p.sample_off, p.top_off, p.top_level) == (
        want["sample_off"], want["top_off"], want["top_level"])
    assert p.top_level[2] == 0 and p.top_level[0] > 0


def test_kernel_constants_match_the_wrapper():
    """The sample's stride and the level's top capacity are the kernel's
    ``kStride`` and ``kTopCap``; the layout table's rows are in the
    kernel's order."""
    src = (_build.CSRC_DIR / "point_read.cu").read_text()
    assert int(re.search(r"kStride = (\d+);", src).group(1)) \
        == read_ops.SAMPLE_STRIDE
    assert int(re.search(r"kFanout = (\d+);", src).group(1)) \
        == read_ops.SAMPLE_FANOUT
    assert int(re.search(r"kTopCap = (\d+);", src).group(1)) \
        == read_ops.TOP_CAP
    rows = re.search(r"enum \{\s*([^}]*)\}", src).group(1)
    assert [r.strip() for r in rows.split(",") if r.strip()] == [
        "kStarts = 0", "kNBits", "kKs", "kFenceLo", "kFenceHi", "kWordOff",
        "kMagic", "kSampleOff", "kTopOff", "kTopLevel", "kRows"]
    for k in (4, 8, 16, read_ops.KMAX_BOUND):
        assert f"launch_k<{k}>(" in src


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, for routing checks."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_recorders(monkeypatch, log, rc=0):
    @contextlib.contextmanager
    def device(dev):
        yield

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 0xC0FFEE

    def kernel_fn(name, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            log.append(("entry", name, symbol, args))
            return rc
        return fn

    def empty(*a, device=None, **kw):
        return torch.empty(*a, **kw).as_subclass(_OnCuda)

    shim = types.SimpleNamespace(**{n: getattr(torch, n) for n in dir(torch)
                                    if not n.startswith("__")})
    shim.empty = empty
    shim.empty_like = lambda t: torch.empty_like(t).as_subclass(_OnCuda)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(_build, "kernel_fn", kernel_fn)
    monkeypatch.setattr(read_ops, "torch", shim)
    monkeypatch.setattr(read_ops, "point_read_level_ref",
                        lambda *a: log.append(("plain",)) or ())


def _cuda_level(lv):
    """``lv``'s arenas and layout as tensors that report a CUDA device."""
    p = _sampled_layout(lv, read_ops.SAMPLE_STRIDE, read_ops.SAMPLE_FANOUT,
                        read_ops.SAMPLE_MIN_RUN, read_ops.TOP_CAP)
    cuda = {n: getattr(p, n).as_subclass(_OnCuda)
            for n in ("words", "sample", "top")}
    table = p.table().as_subclass(_OnCuda)
    layout = read_ops.LevelLayout(
        starts=p.starts, n_bits=p.n_bits, ks=p.ks, fence_lo=p.fence_lo,
        fence_hi=p.fence_hi, word_off=p.word_off, sample_off=p.sample_off,
        top_off=p.top_off, top_level=p.top_level, _table=table, **cuda)
    return (lv.keys.as_subclass(_OnCuda), lv.vals.as_subclass(_OnCuda),
            layout)


def test_wrapper_routes_by_device(monkeypatch):
    """CUDA tensors go to the C entry ``point_read_launch`` with the
    layout table, the sample, the top and its size, the level's largest k
    and the stream, one launch counted per call, and never to the plain
    version; an empty batch launches nothing.  CPU tensors go to the
    plain version and never to the entry.  The device guard, the stream
    and the entry are recorders."""
    rng = np.random.default_rng(7)
    keys = _u64_keys(rng, 9000)
    lv = tstore.LevelStore("cpu")
    lv._set_runs([tstore.RunData.build(
        u64.to_device_keys(k, "cpu"), torch.arange(len(k)), 9.5,
        flushes=1) for k in (keys[::3], keys[1::2])])
    q = u64.to_device_keys(rng.choice(keys, 101), "cpu")
    ak, av, layout = _cuda_level(lv)
    log = []
    saved = dict(_build.LAUNCHES)
    try:
        _cuda_recorders(monkeypatch, log)
        before = _build.LAUNCHES["point_read"]
        outs = read_ops.point_read_level(q.as_subclass(_OnCuda), ak, av,
                                         layout)
        assert _build.LAUNCHES["point_read"] == before + 1
        ((kind, name, symbol, args),) = log
        assert (kind, name, symbol) == ("entry", "point_read",
                                        "point_read_launch")
        (qp, B, akp, avp, tab, R, words, sample, top, top_total, kmax,
         *out_ptrs, stream) = args
        assert (B, R, kmax, stream) == (101, 2, max(lv.ks), 0xC0FFEE)
        assert (akp, avp, tab) == (ak.data_ptr(), av.data_ptr(),
                                   layout.table().data_ptr())
        assert (words, sample, top) == (layout.words.data_ptr(),
                                        layout.sample.data_ptr(),
                                        layout.top.data_ptr())
        assert top_total == layout.top_off[-1] > 0
        assert out_ptrs == [t.data_ptr() for t in outs]
        log.clear()
        read_ops.point_read_level(q[:0].as_subclass(_OnCuda), ak, av, layout)
        assert log == [] and _build.LAUNCHES["point_read"] == before + 1
        read_ops.point_read_level(q, lv.keys, lv.vals, lv.pack)
        assert log == [("plain",)]
        assert _build.LAUNCHES["point_read"] == before + 1
    finally:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved)


def test_wrapper_refuses_what_the_kernel_cannot_take(monkeypatch):
    """A level whose filters take more than ``KMAX_BOUND`` hashes, a
    sample of another stride, and tensors on two devices raise before any
    launch."""
    rng = np.random.default_rng(8)
    keys = _u64_keys(rng, 5000)
    lv = tstore.LevelStore("cpu")
    lv._set_runs([tstore.RunData.build(
        u64.to_device_keys(keys, "cpu"), torch.arange(5000), 60.0,
        flushes=1)])
    assert lv.ks[0] > read_ops.KMAX_BOUND
    q = u64.to_device_keys(keys[:10], "cpu").as_subclass(_OnCuda)
    log = []
    _cuda_recorders(monkeypatch, log)
    ak, av, layout = _cuda_level(lv)
    with pytest.raises(ValueError, match="hashes"):
        read_ops.point_read_level(q, ak, av, layout)
    layout.stride = 4
    layout.ks = [3]
    with pytest.raises(ValueError, match="every"):
        read_ops.point_read_level(q, ak, av, layout)
    with pytest.raises(ValueError, match="devices"):
        read_ops.point_read_level(q, lv.keys, av, layout)
    assert log == []


def test_probe_stamps_every_phase_of_the_search():
    """``tools/point_read_probe.py`` instruments a copy of
    ``csrc/point_read.cu``: the filter's stamp and the value's in the
    kernel, the fence's, the top's, the sample's and the window's in the
    search (which then takes the counters), in the order the phases run,
    and the block's load of the tops; an anchor the source lost is an
    error."""
    from repro_torch.tools.point_read_probe import design_of, instrument
    src = (_build.CSRC_DIR / "point_read.cu").read_text()
    assert design_of(src) == "sampled"
    probed = instrument(src)
    at = [probed.index(f"PR_STAMP({i})\n") for i in range(6)]
    kernel = probed.index("__global__")
    assert at[1] < at[2] < at[3] < at[4] < kernel < at[0] < at[5]
    assert probed.count("search_run(key, lv, r, ak, sample, keep, once, "
                        "lo, t_, c_)") == 1
    assert "g_probe_buf[(long long)(PR_NPH + 1) * B + blockIdx.x]" in probed
    with pytest.raises(ValueError):
        instrument(src.replace("      reads += 1;\n", "      reads += 1; \n"))
