"""The port's fleets and Bloom classes (``repro_torch.lsm``) against the JAX
package's numpy engine (``repro.lsm``), at small sizes on the CPU.

Same tunings, same seeds: every session of ``run_fleet``,
``run_policy_fleet`` and ``measured_cost_vector`` must give the same
``IOStats`` counter for counter; ``SessionPlan.insert_keys`` the same keys;
``BloomFilter`` the same words and answers and ``BloomPack`` the same probe
matrix, bit for bit.
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro.lsm as J
import repro_torch.core as T
import repro_torch.lsm as P
from repro.lsm import bloom as jbloom
from repro_torch.convert import phi_from_numpy
from repro_torch.lsm import bloom as tbloom

N_KEYS, N_QUERIES = 20_000, 300
MIXES = np.array([[0.33, 0.33, 0.33, 0.01], [0.05, 0.10, 0.05, 0.80]])
TUNINGS = [(6.0, 5.0, 1.0), (5.0, 3.0, 4.0)]      # (T, filter bits/entry, K)


def _phis():
    sys_j = R.LSMSystem()
    phis = [R.make_phi(t, h * sys_j.N, k, sys_j) for t, h, k in TUNINGS]
    return phis, [phi_from_numpy(p.T, p.mfilt_bits, p.K) for p in phis]


def _assert_same_results(ref, got):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert b.io.as_dict() == a.io.as_dict()
        assert b.avg_io_per_query == a.avg_io_per_query
        np.testing.assert_array_equal(b.window_ops, a.window_ops)


def test_run_fleet_matches_reference():
    """Two trees sharing a key array and a seed row (one plan each session
    for both), a third with its own keys and seeds."""
    cfgs = [dict(T=5, K=(4,) * 8, buf_entries=300, expected_entries=N_KEYS,
                 mfilt_bits_per_entry=6.0),
            dict(T=4, K=(1,) * 8, buf_entries=250, expected_entries=N_KEYS,
                 mfilt_bits_per_entry=8.0)]
    ref_trees = [J.LSMTree(J.EngineConfig(**c)) for c in cfgs + cfgs[:1]]
    got_trees = [P.LSMTree(P.EngineConfig(**c), device="cpu")
                 for c in cfgs + cfgs[:1]]
    keys = J.populate(ref_trees[0], N_KEYS, seed=3)
    J.populate(ref_trees[1], N_KEYS, keys=keys)
    own = J.populate(ref_trees[2], N_KEYS, seed=5)
    for t in got_trees[:2]:
        P.populate(t, N_KEYS, keys=keys)
    P.populate(got_trees[2], N_KEYS, seed=5)
    seeds = np.array([[0, 1], [0, 1], [7, 8]])
    ref = J.run_fleet(ref_trees, MIXES, [keys, keys, own],
                      n_queries=N_QUERIES, seeds=seeds)
    got = P.run_fleet(got_trees, MIXES, [keys, keys, own],
                      n_queries=N_QUERIES, seeds=seeds)
    for a, b in zip(ref, got):
        _assert_same_results(a, b)
    with pytest.raises(ValueError):
        P.run_fleet(got_trees, MIXES, [keys], n_queries=10)


@pytest.mark.parametrize("params", [{},
                                    {"lazy_leveling": {"read_trigger": 32}}])
def test_run_policy_fleet_matches_reference(params):
    phis_j, phis_t = _phis()
    policies = ("klsm", "lazy_leveling")
    kw = dict(n_keys=N_KEYS, n_queries=N_QUERIES, seed=11)
    ref_trees, ref = J.run_policy_fleet(phis_j, R.LSMSystem(), policies,
                                        MIXES, policy_params=params, **kw)
    got_trees, got = P.run_policy_fleet(phis_t, T.LSMSystem(), policies,
                                        MIXES, policy_params=params,
                                        device="cpu", **kw)
    for p in range(len(phis_j)):
        for j in range(len(policies)):
            assert got_trees[p][j].cfg.policy == policies[j]
            assert got_trees[p][j].shape() == ref_trees[p][j].shape()
            _assert_same_results(ref[p][j], got[p][j])


def test_measured_cost_vector_matches_reference():
    cfg = dict(T=4, K=(2,) * 8, buf_entries=200, expected_entries=N_KEYS,
               mfilt_bits_per_entry=5.0)
    ref = J.measured_cost_vector(lambda: J.LSMTree(J.EngineConfig(**cfg)),
                                 N_KEYS, n_queries=N_QUERIES, seed=2)
    got = P.measured_cost_vector(
        lambda: P.LSMTree(P.EngineConfig(**cfg), device="cpu"), N_KEYS,
        n_queries=N_QUERIES, seed=2)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("delete_fraction", [0.0, 0.3])
def test_insert_keys_matches_reference(delete_fraction):
    keys = J.draw_keys(5000, seed=4)
    mix = np.array([0.1, 0.2, 0.1, 0.6])
    ref = J.materialize_session(keys, mix, n_queries=2000, seed=3,
                                delete_fraction=delete_fraction)
    got = P.materialize_session(keys, mix, n_queries=2000, seed=3,
                                delete_fraction=delete_fraction)
    assert (got.write_tombs is None) == (delete_fraction == 0.0)
    np.testing.assert_array_equal(got.insert_keys, ref.insert_keys)
    assert len(got.insert_keys) == len(got.write_keys) \
        - (0 if got.write_tombs is None else int(got.write_tombs.sum()))


def _u64_keys(rng, n):
    return rng.integers(0, 2 ** 64 - 1, n, dtype=np.uint64, endpoint=True)


@pytest.mark.parametrize("n,bpk", [(1, 8.0), (777, 5.5), (3000, 12.0),
                                   (0, 10.0)])
def test_bloom_filter_bit_identical(n, bpk):
    rng = np.random.default_rng(n + 1)
    keys = _u64_keys(rng, n)
    ref = jbloom.BloomFilter(keys, bpk)
    got = P.BloomFilter(keys, bpk, device="cpu")
    assert (got.n_bits, got.k, got.n_keys, got.bits_used) \
        == (ref.n_bits, ref.k, ref.n_keys, ref.bits_used)
    np.testing.assert_array_equal(got.words.numpy().view(np.uint64),
                                  ref.words)
    q = np.concatenate([keys, _u64_keys(rng, 2000)])
    np.testing.assert_array_equal(got.might_contain_batch(q),
                                  ref.might_contain_batch(q))
    for key in q[:: max(1, len(q) // 200)]:
        assert got.might_contain(int(key)) == ref.might_contain(int(key))


def test_bloom_pack_bit_identical():
    rng = np.random.default_rng(9)
    keys = _u64_keys(rng, 4000)
    runs = [jbloom.BloomFilter(keys[i * 700:i * 700 + 300 + 90 * i], bpk)
            for i, bpk in enumerate((2.0, 5.0, 9.0, 13.0, 0.5))]
    args = ([f.words for f in runs], [f.n_bits for f in runs],
            [f.k for f in runs])
    q = np.concatenate([keys[:1500], _u64_keys(rng, 1500)])
    ref = jbloom.BloomPack(*args).probe(q)
    got = P.BloomPack(*args, device="cpu")
    np.testing.assert_array_equal(got.probe(q), ref)
    np.testing.assert_array_equal(got.words.numpy().view(np.uint64),
                                  jbloom.BloomPack(*args).words)
    # per-run words as int64 tensors, the port's own representation
    words_t = [torch.from_numpy(w.view(np.int64)) for w in args[0]]
    np.testing.assert_array_equal(
        P.BloomPack(words_t, *args[1:], device="cpu").probe(q), ref)
    assert got.probe(q[:0]).shape == (5, 0)
    assert P.BloomPack([], [], [], device="cpu").probe(q).shape == (0, 3000)


def test_splitmix64_helpers_bit_identical():
    rng = np.random.default_rng(2)
    x = _u64_keys(rng, 500)
    bits = torch.from_numpy(x.view(np.int64))
    np.testing.assert_array_equal(
        tbloom.splitmix64(bits, 3).numpy().view(np.uint64),
        jbloom.splitmix64(x, np.uint64(3)))
    np.testing.assert_array_equal(
        tbloom.splitmix64_seeds(bits, 7).numpy().view(np.uint64),
        jbloom.splitmix64_seeds(x, 7))
    for v in x[:50]:
        assert tbloom.splitmix64_scalar(int(v), 5) \
            == jbloom.splitmix64_scalar(int(v), 5)


def test_lsm_exports_what_the_reference_exports():
    assert P.__all__ == J.__all__
    assert all(hasattr(P, name) for name in P.__all__)
