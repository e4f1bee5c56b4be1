"""The compaction merge's tiled algorithm (``csrc/merge.cu``) on the CPU.

The kernels cannot run here, so their algorithm is held through its twin,
``repro_torch.kernels.merge.ref.merge_tiled_ref``: the partition, each
tile's per-thread merge with keep flags (across threads and across tiles),
the tiles' counts, offsets and compaction, at small tiles.  The twin must
be bit-identical to

* the JAX package's ``two_way_merge_kernel`` in interpret mode followed by
  its ``_dedup`` (``repro/kernels/merge/ops.py``), one fold step; without
  the drop, to the kernel alone;
* ``merge_runs_numpy`` for k-way newest-first folds.

The Pallas kernel takes no empty run; there the reference is the other
run (then ``_dedup``).  Keys cross between the packages as numpy uint64
and enter the port in its ordered int64 form.  Also here: the wrapper
sends CUDA tensors to the kernel's C entry and CPU tensors to the plain
version (with recorders for the device guard, the stream and the entry).
"""

import contextlib
import ctypes
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.merge.kernel import two_way_merge_kernel
from repro.kernels.merge.ops import _dedup
from repro.lsm.merge_path import merge_runs_numpy
from repro_torch.kernels import _build
from repro_torch.kernels.merge import ops as merge_ops
from repro_torch.kernels.merge.ref import _split, merge_tiled_ref, split_kary
from repro_torch.utils import u64

# (tile, outputs per thread, the partition's probes a round: the
# kernel's 32, or 8 from 1,024 tiles)
TILES = [(4, 2, 8), (8, 4, 32), (16, 4, 32), (12, 3, 8)]


def _keys(rng, n):
    """n sorted unique keys over the whole uint64 range."""
    keys = np.unique(rng.integers(0, 2 ** 64 - 1, 2 * n + 16,
                                  dtype=np.uint64, endpoint=True))
    return np.sort(rng.choice(keys, n, replace=False))


def _case(name):
    """(A, B) uint64 runs, A newer."""
    rng = np.random.default_rng(len(name))
    u = functools.partial(np.array, dtype=np.uint64)
    if name == "straddle":         # A's copy ends a tile, B's starts one
        evens = np.arange(2, 2 * 53, 2, dtype=np.uint64)
        return evens, np.concatenate([u([1]), evens])
    if name == "one_run_tiles":    # whole tiles drawn from A, then from B
        return (np.concatenate([np.arange(0, 40), np.arange(80, 97)]).astype(
            np.uint64), np.arange(40, 80, dtype=np.uint64))
    if name == "empty_a":
        return u([]), u([3, 9, 9 + 2 ** 63])
    if name == "empty_b":
        return u([0, 5, 5, 2 ** 64 - 1]), u([])
    if name == "single":
        return u([7]), u([7])
    if name == "single_high":
        return u([2 ** 64 - 1]), u([0])
    if name == "high_keys":        # most keys >= 2**63, overlapping runs
        pool = _keys(rng, 120)
        pool = np.concatenate([pool[pool >= np.uint64(2 ** 63)], pool[:10]])
        return (np.sort(rng.choice(pool, 45, replace=False)),
                np.sort(rng.choice(pool, 60, replace=False)))
    if name == "all_duplicates":
        keys = _keys(rng, 37)
        return keys, keys.copy()
    if name == "repeated_key":     # duplicates inside each run too
        return (np.full(9, 2 ** 63 + 4, np.uint64),
                np.full(14, 2 ** 63 + 4, np.uint64))
    raise KeyError(name)


CASES = ["straddle", "one_run_tiles", "empty_a", "empty_b", "single",
         "single_high", "high_keys", "all_duplicates", "repeated_key"]


def _vals(a, b):
    return (np.arange(len(a), dtype=np.int64) * 3 + 1,
            np.arange(len(b), dtype=np.int64) * 3 + 2)


@functools.lru_cache(maxsize=None)
def _jax_step(name, drop):
    """The JAX package's fold step on case ``name``: the Pallas merge in
    interpret mode, then ``_dedup`` when ``drop``."""
    a, b = _case(name)
    av, bv = _vals(a, b)
    if len(a) and len(b):
        with jax.enable_x64(True):
            k, v = two_way_merge_kernel(
                jnp.asarray(a, jnp.uint64), jnp.asarray(av),
                jnp.asarray(b, jnp.uint64), jnp.asarray(bv), interpret=True)
            k, v = np.asarray(k), np.asarray(v)
    else:
        k, v = np.concatenate([a, b]), np.concatenate([av, bv])
    return _dedup(k, v) if drop else (k, v)


def _twin(a, av, b, bv, tile, k, drop=True, ways=32):
    keys, vals = merge_tiled_ref(
        u64.to_device_keys(a, "cpu"), torch.from_numpy(av),
        u64.to_device_keys(b, "cpu"), torch.from_numpy(bv), tile, k, drop,
        ways)
    return u64.unorder_keys(keys), vals.numpy()


@pytest.mark.parametrize("tile,k,ways", TILES)
@pytest.mark.parametrize("name", CASES)
def test_tiled_step_bit_equal_to_pallas_interpret_and_dedup(name, tile, k,
                                                            ways):
    a, b = _case(name)
    av, bv = _vals(a, b)
    for drop in (True, False):
        got_k, got_v = _twin(a, av, b, bv, tile, k, drop, ways)
        want_k, want_v = _jax_step(name, drop)
        np.testing.assert_array_equal(got_k, want_k)
        np.testing.assert_array_equal(got_v, want_v)


def test_straddling_pair_keeps_a_copy_across_the_tile_boundary():
    """In ``straddle`` at tile 4, A's copy of a key is an output that ends
    a tile and B's copy the one that starts the next: only A's stays."""
    a, b = _case("straddle")
    av, bv = _vals(a, b)
    k, v = _twin(a, av, b, bv, 4, 2, drop=False)
    assert k[3] == k[4] and v[3] == av[1] and v[4] == bv[2]
    k, v = _twin(a, av, b, bv, 4, 2)
    assert list(k) == sorted(set(k.tolist())) and v[2] == av[1]
    assert set(v.tolist()) == set(av.tolist()) | {bv[0]}


@pytest.mark.parametrize("hi", [4, 2 ** 20])
@pytest.mark.parametrize("ways", [8, 32])
def test_partition_search_finds_the_binary_split(ways, hi):
    """The partition's k-ary search (``split_kary``, a group's probes a
    round, at the kernel's two widths) returns the binary search's split
    on every diagonal, with keys below ``hi`` (repeated inside and across
    runs when it is small) and runs of every length to 300."""
    rng = np.random.default_rng(ways + hi)
    for trial in range(60):
        na, nb = rng.integers(0, 300, 2)
        a = sorted(rng.integers(0, hi, na).tolist())
        b = sorted(rng.integers(0, hi, nb).tolist())
        for d in range(na + nb + 1):
            assert split_kary(a, b, d, ways) == _split(a, b, d)


def _fold_cases():
    rng = np.random.default_rng(7)
    big = _keys(rng, 300)
    return {
        "overlapping": [np.arange(0, 90, 3), np.arange(0, 90, 2),
                        np.arange(30, 130, 5)],
        "empty_runs": [np.array([], np.uint64), np.arange(10, 20),
                       np.array([], np.uint64), np.arange(15, 40)],
        "high_keys": [big[::3], big[1::3], big[big >= np.uint64(2 ** 63)],
                      big[:50]],
        "single": [np.array([7]), np.array([7]), np.array([2 ** 64 - 1])],
        "all_duplicates": [big[:40]] * 3,
    }


@pytest.mark.parametrize("tile,k,ways", TILES[:3])
@pytest.mark.parametrize("case", sorted(_fold_cases()))
def test_tiled_fold_bit_equal_to_merge_runs_numpy(case, tile, k, ways):
    runs = [np.asarray(r, np.uint64) for r in _fold_cases()[case]]
    vals = [np.arange(len(r), dtype=np.int64) * 2 + 1 + 10_000 * i
            for i, r in enumerate(runs)]
    acc_k, acc_v = runs[0], vals[0]
    for rk, rv in zip(runs[1:], vals[1:]):       # the fold of merge_runs
        if not len(rk):
            continue
        if not len(acc_k):
            acc_k, acc_v = rk, rv
            continue
        acc_k, acc_v = _twin(acc_k, acc_v, rk, rv, tile, k, ways=ways)
    want_k, want_v = merge_runs_numpy(runs, vals)
    np.testing.assert_array_equal(acc_k, want_k)
    np.testing.assert_array_equal(acc_v, want_v)


@pytest.mark.parametrize("name", CASES)
def test_wrapper_fold_step_on_cpu_bit_equal_to_pallas_and_dedup(name):
    """``merge_newest_wins`` on CPU tensors (its plain version)."""
    a, b = _case(name)
    av, bv = _vals(a, b)
    k, v = merge_ops.merge_newest_wins(
        u64.to_device_keys(a, "cpu"), torch.from_numpy(av),
        u64.to_device_keys(b, "cpu"), torch.from_numpy(bv))
    want_k, want_v = _jax_step(name, True)
    np.testing.assert_array_equal(u64.unorder_keys(k), want_k)
    np.testing.assert_array_equal(v.numpy(), want_v)


def test_fold_step_wrapper_checks_inputs():
    x = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        merge_ops.merge_newest_wins(x.int(), x, x, x)
    with pytest.raises(ValueError):
        merge_ops.merge_newest_wins(x, x[:3], x, x)
    meta = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        merge_ops.merge_newest_wins(meta, meta, meta, meta)


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that the wrapper takes
    its kernel route on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_wrapper_routes_by_device(monkeypatch):
    """CUDA tensors go to the C entry ``merge_launch`` (the drop flag 1 for
    ``merge_newest_wins``, 0 for ``two_way_merge``; the stream passed, and
    a scratch of 2 * ntiles + 3 words for the tile size the library
    exports), one launch counted per call and the plain versions never
    called; the output is the entry's first ``n_out`` entries, the total
    it leaves in the scratch's last slot.  CPU tensors go to the plain
    versions and never to the entry.  The device guard, the stream, the
    library's tile size and the entry are recorders."""
    log = []
    tile = 8

    @contextlib.contextmanager
    def device(dev):
        yield

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 0xC0FFEE

    def kernel_fn(name, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            ak, av, na, bk, bv, nb, ok, ov, scratch, drop, stream = args
            log.append(("entry", name, symbol, na, nb, drop, stream))
            ntiles = -(-(na + nb) // tile)
            ctypes.c_longlong.from_address(
                scratch + 8 * (2 * ntiles + 2)).value = 2
            return 0
        return fn

    def empty(*a, device=None, **kw):
        log.append(("empty", *a))
        return torch.empty(*a, **kw).as_subclass(_OnCuda)

    def plain(name, fn):
        def rec(*args):
            log.append(("plain", name))
            return fn(*args)
        return rec

    shim = types.SimpleNamespace(**{n: getattr(torch, n) for n in dir(torch)
                                    if not n.startswith("__")})
    shim.empty = empty
    monkeypatch.setattr(merge_ops, "_tile", lambda: tile)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(_build, "kernel_fn", kernel_fn)
    monkeypatch.setattr(merge_ops, "torch", shim)
    for name in ("two_way_merge_ref", "drop_adjacent_duplicates"):
        monkeypatch.setattr(merge_ops, name,
                            plain(name, getattr(merge_ops, name)))
    saved = dict(_build.LAUNCHES)
    try:
        a, b = _case("high_keys")
        av, bv = _vals(a, b)
        cpu = (u64.to_device_keys(a, "cpu"), torch.from_numpy(av),
               u64.to_device_keys(b, "cpu"), torch.from_numpy(bv))
        cuda = tuple(t.as_subclass(_OnCuda) for t in cpu)
        na, nb = len(a), len(b)
        for fn, drop, n_out in ((merge_ops.merge_newest_wins, 1, 2),
                                (merge_ops.two_way_merge, 0, na + nb)):
            before = _build.LAUNCHES["merge"]
            log.clear()
            k, v = fn(*cuda)
            assert k.shape == v.shape == (n_out,)
            assert _build.LAUNCHES["merge"] == before + 1
            n, scratch = na + nb, 2 * -(-(na + nb) // tile) + 3
            assert log == [("empty", n), ("empty", n), ("empty", scratch),
                           ("entry", "merge", "merge_launch", na, nb, drop,
                            0xC0FFEE)]
        log.clear()
        merge_ops.merge_runs([cuda[0], cuda[2], cuda[0][:0], cuda[2]],
                             [cuda[1], cuda[3], cuda[1][:0], cuda[3]])
        assert [e[0] for e in log if e[0] != "empty"] == ["entry", "entry"]
        log.clear()
        before = _build.LAUNCHES["merge"]
        k, v = merge_ops.merge_newest_wins(*cpu)
        assert log == [("plain", "two_way_merge_ref"),
                       ("plain", "drop_adjacent_duplicates")]
        want_k, want_v = _jax_step("high_keys", True)
        np.testing.assert_array_equal(u64.unorder_keys(k), want_k)
        np.testing.assert_array_equal(v.numpy(), want_v)
        log.clear()
        merge_ops.two_way_merge(*cpu)
        assert log == [("plain", "two_way_merge_ref")]
        assert _build.LAUNCHES["merge"] == before
    finally:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved)


def test_probe_stamps_every_phase_of_the_tile_kernel():
    """``tools/merge_probe.py`` instruments a copy of ``csrc/merge.cu``:
    five clock stamps in the tile kernel, in the order its phases run (the
    block's start before it takes its tile, windows loaded, merge and scan
    done, offset known, stores issued), the start's timer and SM, and an
    entry that reads the stamps; an anchor the source lost is an error."""
    from repro_torch.tools.merge_probe import instrument
    src = (_build.CSRC_DIR / "merge.cu").read_text()
    probed = instrument(src)
    at = [probed.index(f"g_stamps[blockIdx.x][{k}] = clock64();")
          for k in range(5)]
    assert at[0] < probed.index("atomicAdd(ticket") < at[1] \
        < probed.index("tile_body<DROP>(sk, sv, w,")
    body = probed[probed.index("__device__ __forceinline__ void tile_body("):
                  probed.index("__global__ void __launch_bounds__")]
    assert at[2] < at[3] < at[4] and all(body.count(
        f"g_stamps[blockIdx.x][{k}]") == 1 for k in (2, 3, 4))
    assert probed.count("clock64()") == src.count("clock64()") + 5
    assert "%%globaltimer" in probed and "%%smid" in probed
    assert 'extern "C" int merge_probe_read' in probed
    with pytest.raises(ValueError):
        instrument(src.replace("  tile_body<DROP>(sk, sv, w,",
                               "  tile_body<DROP>(sk, sv,  w,"))
