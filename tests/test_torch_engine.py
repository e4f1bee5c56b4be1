"""The port's engine (``repro_torch.lsm``) against the JAX package's numpy
engine (``repro.lsm``), at small sizes on the CPU.

Same configs, same seeds: every populate and session must give the same
``IOStats`` counter for counter, the same answers, and the same arenas
(keys, values, run offsets, Bloom parameters, flush lineage) — from fresh
trees, and after carrying a reference tree across with
``repro_torch.convert.tree_from_numpy``.  The port's quickstart runs end
to end against the same pipeline on the JAX package, with shared starts.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.lsm as J
import repro_torch.core as T
import repro_torch.lsm as P
from repro.core.designs import random_inits as jax_random_inits
from repro_torch import quickstart
from repro_torch.convert import phi_from_numpy, tree_from_numpy
from repro_torch.utils.u64 import unorder_keys

KEY_SPACE = 2 ** 48
N_KEYS = 5000
MIXES = {"read_heavy": [0.33, 0.33, 0.33, 0.01],
         "burst": [0.05, 0.10, 0.05, 0.80],
         "balanced": [0.25, 0.25, 0.25, 0.25]}
TUNINGS = {"leveling": (6.0, 1.0), "tiering": (5.0, 4.0)}   # (T, K)


def _trees(tuning, device="cpu"):
    """(reference tree, port tree) deployed from the same Phi."""
    t, k = TUNINGS[tuning]
    sys_j = R.LSMSystem()
    phi_j = R.make_phi(t, 5.0 * sys_j.N, k, sys_j)
    phi_t = phi_from_numpy(phi_j.T, phi_j.mfilt_bits, phi_j.K)
    ref = J.LSMTree.from_phi(phi_j, sys_j, expected_entries=N_KEYS)
    port = P.LSMTree.from_phi(phi_t, T.LSMSystem(), expected_entries=N_KEYS,
                              device=device)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    return ref, port


def _assert_same_state(ref, port):
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.shape() == ref.shape()
    assert port.flush_seq == ref.flush_seq
    assert port.buffer == ref.buffer
    for a, b in zip(ref.store.levels, port.store.levels):
        np.testing.assert_array_equal(unorder_keys(b.keys), a.keys)
        np.testing.assert_array_equal(b.vals.cpu().numpy(), a.vals)
        np.testing.assert_array_equal(b.starts, a.starts)
        assert (b.n_bits, b.ks, b.flushes, b.tomb_seqs) \
            == (a.n_bits, a.ks, a.flushes, a.tomb_seqs)
        np.testing.assert_array_equal(b.min_keys, a.min_keys)
        np.testing.assert_array_equal(b.max_keys, a.max_keys)


def _assert_same_answers(ref, port, keys, seed):
    rng = np.random.default_rng(seed)
    q = np.concatenate([rng.choice(keys, 300),
                        rng.integers(0, KEY_SPACE, 100).astype(np.uint64)])
    assert port.point_query_batch(q) == ref.point_query_batch(q)
    los = np.sort(rng.choice(keys, 20))
    his = los + np.uint64(2 ** 36)
    assert port.range_query_batch(los, his, return_results=True) \
        == ref.range_query_batch(los, his, return_results=True)
    assert port.stats.as_dict() == ref.stats.as_dict()


@pytest.mark.parametrize("tuning", sorted(TUNINGS))
def test_sessions_bit_identical_to_reference_engine(tuning):
    ref, port = _trees(tuning)
    keys = J.populate(ref, N_KEYS, seed=3, key_space=KEY_SPACE)
    np.testing.assert_array_equal(
        P.populate(port, N_KEYS, seed=3, key_space=KEY_SPACE), keys)
    _assert_same_state(ref, port)
    for s, mix in enumerate(MIXES.values()):
        a = J.run_session(ref, keys, np.array(mix), n_queries=2000, seed=s)
        b = P.run_session(port, keys, np.array(mix), n_queries=2000, seed=s)
        assert b.io.as_dict() == a.io.as_dict()
        assert b.avg_io_per_query == a.avg_io_per_query
        np.testing.assert_array_equal(b.window_ops, a.window_ops)
        _assert_same_state(ref, port)
    _assert_same_answers(ref, port, keys, seed=11)


def _state_of(tree):
    """The reference tree's state as plain numpy arrays and Python values."""
    levels = [dict(keys=lv.keys, vals=lv.vals, starts=lv.starts,
                   n_bits=lv.n_bits, ks=lv.ks, flushes=lv.flushes,
                   tomb_seqs=lv.tomb_seqs, min_keys=lv.min_keys,
                   max_keys=lv.max_keys, words=lv.words_list)
              for lv in tree.store.levels]
    return dict(config_fields=dataclasses.asdict(tree.cfg), levels=levels,
                codec_objects=tree.store.codec.objects, buffer=tree.buffer,
                stats=tree.stats.as_dict(), flush_seq=tree.flush_seq)


@pytest.mark.parametrize("tuning", sorted(TUNINGS))
def test_tree_from_numpy_then_same_session(tuning):
    ref, _ = _trees(tuning)
    keys = J.populate(ref, N_KEYS, seed=5, key_space=KEY_SPACE)
    J.run_session(ref, keys, np.array(MIXES["balanced"]), n_queries=500,
                  seed=9)                  # a live buffer and read filters
    port = tree_from_numpy(**_state_of(ref), device="cpu")
    _assert_same_state(ref, port)
    for s, mix in enumerate(MIXES.values()):
        zipf = 1.3 if s == 0 else None       # one skewed session
        a = J.run_session(ref, keys, np.array(mix), n_queries=2000,
                          seed=20 + s, zipf_a=zipf)
        b = P.run_session(port, keys, np.array(mix), n_queries=2000,
                          seed=20 + s, zipf_a=zipf)
        assert b.io.as_dict() == a.io.as_dict()
    _assert_same_state(ref, port)
    _assert_same_answers(ref, port, keys, seed=12)


def test_high_keys_deletes_and_objects_match_reference():
    """Keys >= 2**63 (the ordered int64 form flips their sign), deletes
    and interned object values, through flushes, merges and reads."""
    cfg = dict(T=3, K=(1, 2), buf_entries=40, expected_entries=600,
               mfilt_bits_per_entry=6.0)
    ref, port = J.LSMTree(J.EngineConfig(**cfg)), \
        P.LSMTree(P.EngineConfig(**cfg), device="cpu")
    rng = np.random.default_rng(4)
    keys = np.unique(rng.integers(2 ** 63 - 300, 2 ** 64 - 1, 600,
                                  dtype=np.uint64, endpoint=True))
    for tree in (ref, port):
        tree.put_batch(keys, (keys % np.uint64(1000)).astype(np.int64))
        for k in keys[::7]:
            tree.delete(int(k))
        for k in keys[::11]:
            tree.put(int(k), ("obj", int(k) % 5))
        tree.put(2 ** 64 - 1, "top")
    _assert_same_state(ref, port)
    for k in (keys[0], keys[7], keys[11], keys[-1], 2 ** 64 - 1, 5):
        assert port.get(int(k)) == ref.get(int(k))
    assert port.range_query(int(keys[100]), 2 ** 64 - 1) \
        == ref.range_query(int(keys[100]), 2 ** 64 - 1)
    ref.flush()
    port.flush()
    _assert_same_state(ref, port)
    _assert_same_answers(ref, port, keys, seed=13)


@pytest.mark.parametrize("policy,params", [
    ("klsm", ()),
    ("lazy_leveling", (("read_trigger", 8),)),
    ("partial", (("parts", 3),)),
    ("tombstone_ttl", (("ttl_flushes", 3),)),
])
def test_every_policy_and_retune_match_reference(policy, params):
    """Interleaved puts, deletes, point and range queries under each
    compaction policy (maintenance merges run mid-stream), a session with
    tombstone churn, then a re-tune: answers, IOStats and arenas agree."""
    cfg = dict(T=3, K=(2,) * 6, buf_entries=16, expected_entries=1000,
               policy=policy, policy_params=params)
    ref, port = J.LSMTree(J.EngineConfig(**cfg)), \
        P.LSMTree(P.EngineConfig(**cfg), device="cpu")
    rng = np.random.default_rng(len(policy))
    universe = rng.choice(50_000, size=250, replace=False)
    for _ in range(700):
        op = rng.integers(0, 10)
        k = int(universe[rng.integers(0, len(universe))])
        if op < 5:
            v = int(rng.integers(0, 10_000))
            ref.put(k, v)
            port.put(k, v)
        elif op < 7:
            ref.delete(k)
            port.delete(k)
        elif op < 9:
            assert port.point_query(k) == ref.point_query(k)
        else:
            lo = int(rng.integers(0, 45_000))
            hi = lo + int(rng.integers(1, 10_000))
            assert port.range_query(lo, hi) == ref.range_query(lo, hi)
    _assert_same_state(ref, port)
    keys = np.sort(universe).astype(np.uint64)
    plan_j = J.materialize_session(keys, MIXES["balanced"], n_queries=600,
                                   seed=1, key_space=50_000,
                                   delete_fraction=0.3)
    plan_t = P.materialize_session(keys, MIXES["balanced"], n_queries=600,
                                   seed=1, key_space=50_000,
                                   delete_fraction=0.3)
    a, b = J.execute_session(ref, plan_j), P.execute_session(port, plan_t)
    assert b.io.as_dict() == a.io.as_dict()
    sys_j = R.LSMSystem()
    phi_j = R.make_phi(4.0, 3.0 * sys_j.N, 1.0, sys_j)
    ref.retune(phi_j, sys_j)
    port.retune(phi_from_numpy(phi_j.T, phi_j.mfilt_bits, phi_j.K),
                T.LSMSystem())
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    _assert_same_state(ref, port)
    _assert_same_answers(ref, port, keys, seed=14)


def test_quickstart_end_to_end_matches_reference_pipeline():
    """The port's quickstart (shared starts) against the same five steps
    on the JAX package: tunings, model costs and engine sessions."""
    sys_j = R.LSMSystem()
    starts = np.asarray(jax_random_inits(jax.random.PRNGKey(0), 8,
                                         R.DesignSpace.CLASSIC, sys_j))
    out = quickstart.main(device="cpu", n_starts=8, steps=30, n=3000,
                          n_queries=1500, starts=starts, verbose=False)
    rho = R.rho_from_history(quickstart.HISTORY)
    assert out["rho"] == pytest.approx(rho, rel=1e-6)
    refs = {"nominal": R.tune_nominal(quickstart.EXPECTED, sys_j,
                                      n_starts=8, steps=30),
            "robust": R.tune_robust(quickstart.EXPECTED, rho, sys_j,
                                    n_starts=8, steps=30)}
    for name, ref in refs.items():
        got = out["tunings"][name]
        assert got["result"].cost == pytest.approx(ref.cost, rel=1e-4)
        assert float(got["result"].phi.T) == float(ref.phi.T)
        tree = J.LSMTree.from_phi(ref.phi, sys_j, expected_entries=3000,
                                  entry_bytes=64)
        keys = J.populate(tree, 3000, seed=1)
        res = J.run_session(tree, keys, quickstart.BURST, n_queries=1500,
                            seed=2)
        assert got["session"].io.as_dict() == res.io.as_dict()
        assert got["model_burst_cost"] == pytest.approx(
            float(quickstart.BURST @ np.asarray(R.cost_vector(ref.phi,
                                                              sys_j))),
            rel=1e-5)


def test_entry_points_raise_without_cuda_unless_cpu(monkeypatch):
    """Every entry point defaults to the card and raises when there is none;
    ``device="cpu"`` runs the plain path.  ``populate``/``run_session`` act
    on a tree, whose constructor chose its device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys_t = T.LSMSystem()
    w = quickstart.EXPECTED
    phi = T.leveling_phi(10.0, 5e10, sys_t)
    calls = {
        "tune_nominal": lambda **d: T.tune_nominal(w, sys_t, n_starts=2,
                                                   steps=1, **d),
        "tune_robust": lambda **d: T.tune_robust(w, 0.5, sys_t, n_starts=2,
                                                 steps=1, **d),
        "tune_nominal_many": lambda **d: T.tune_nominal_many(
            [w], sys_t, n_starts=2, steps=1, **d),
        "tune_robust_many": lambda **d: T.tune_robust_many(
            [w], [0.5], sys_t, n_starts=2, steps=1, **d),
        "LSMTree": lambda **d: P.LSMTree(P.EngineConfig(), **d),
        "LSMTree.from_phi": lambda **d: P.LSMTree.from_phi(
            phi, sys_t, expected_entries=1000, **d),
        "quickstart": lambda **d: quickstart.main(
            n_starts=2, steps=1, n=200, n_queries=50, verbose=False, **d),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call(device="cuda")
        assert call(device="cpu") is not None, name
    tree = P.LSMTree(P.EngineConfig(buf_entries=64), device="cpu")
    keys = P.populate(tree, 300, seed=1)
    assert P.run_session(tree, keys, w, n_queries=100).queries == 100
