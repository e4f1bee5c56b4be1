"""The port's blocked-Bloom probe (``repro_torch.kernels.bloom_probe``)
against the JAX package's, at small sizes on the CPU.

The same numpy keys go through both: uint32 to the JAX package, int64
holding the same values to the port.  The JAX side runs as its own tests
run it here (``tests/test_kernels.py``): the numpy ``ref.py``, the jitted
``kernel._mix32``, and the Pallas kernel in interpret mode.  Every
comparison is exact.  The CUDA kernel itself runs only on the card:
``test_torch_cuda.py`` holds it against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bloom_probe import kernel as jkernel
from repro.kernels.bloom_probe import ops as jops
from repro.kernels.bloom_probe import ref as jref
from repro_torch.kernels.bloom_probe.ops import (bloom_probe,
                                                 bloom_probe_kernel,
                                                 bloom_probe_loads)
from repro_torch.kernels.bloom_probe.ref import (build_plane, mix32,
                                                 probe_loads_ref, probe_ref)

EDGES = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
# (num_blocks, block_bits, num_hashes): test_kernels.py's three shapes and
# a block count that is not a power of two
SHAPES = [(128, 256, 3), (256, 512, 4), (64, 1024, 6), (195, 512, 7)]


def _t(keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64))


def _keys(seed: int, n: int) -> np.ndarray:
    """n distinct uint32 keys."""
    rng = np.random.default_rng(seed)
    return rng.choice(2 ** 32, n, replace=False).astype(np.uint32)


_jit_mix32 = jax.jit(jkernel._mix32, static_argnums=1)


@pytest.mark.parametrize("seed", range(1, 9))
def test_mix32_matches_jax(seed):
    keys = np.concatenate([EDGES, np.random.default_rng(seed).integers(
        0, 2 ** 32, 10_000, dtype=np.uint64).astype(np.uint32)])
    got = mix32(_t(keys), seed).numpy()
    assert got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(got, jref.mix32(keys, seed))
    np.testing.assert_array_equal(
        got, np.asarray(_jit_mix32(jnp.asarray(keys), seed)))


def test_keys_count_as_their_low_32_bits():
    keys = _keys(0, 512)
    plane = build_plane(_t(keys[:256]), 64, 512, 4, device="cpu")
    high = _t(keys) + (torch.arange(512) % 5) * 2 ** 32
    assert torch.equal(probe_ref(high, plane, 4), probe_ref(_t(keys), plane,
                                                            4))


@pytest.mark.parametrize("num_blocks,block_bits,num_hashes", SHAPES)
def test_build_plane_matches_jax(num_blocks, block_bits, num_hashes):
    keys = _keys(num_blocks, 2048)[:1024]
    got = build_plane(_t(keys), num_blocks, block_bits, num_hashes,
                      device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), jref.build_plane(keys, num_blocks, block_bits,
                                      num_hashes))


@pytest.mark.parametrize("num_blocks,block_bits,num_hashes", SHAPES)
def test_probe_matches_pallas_interpret(num_blocks, block_bits, num_hashes):
    """2,048 keys, the first half inserted, against the Pallas kernel in
    interpret mode and the numpy oracle."""
    keys = _keys(num_blocks, 2048)
    plane = jref.build_plane(keys[:1024], num_blocks, block_bits, num_hashes)
    want = np.asarray(jkernel.bloom_probe_kernel(
        jnp.asarray(keys), jnp.asarray(plane), num_hashes=num_hashes,
        interpret=True))
    np.testing.assert_array_equal(want, jref.probe_ref(keys, plane,
                                                       num_hashes))
    tp = torch.from_numpy(plane)
    for got in (probe_ref(_t(keys), tp, num_hashes),
                bloom_probe_kernel(_t(keys), tp, num_hashes=num_hashes)):
        assert got.dtype == torch.float32 and got.shape == (2048,)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:1024] == 1.0).all()


@pytest.mark.parametrize("n", [1, 1000])
def test_bool_probe_matches_jax_ops(n):
    """N not a multiple of 128: the JAX wrapper pads, the port does not."""
    keys = _keys(n, 2 * n)
    plane = jref.build_plane(keys[:n], 64, 512, 4)
    want = np.asarray(jops.bloom_probe(jnp.asarray(keys[n // 2:][:n]),
                                       jnp.asarray(plane), num_hashes=4))
    got = bloom_probe(_t(keys[n // 2:][:n]), torch.from_numpy(plane),
                      num_hashes=4)
    assert got.dtype == torch.bool and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(6))
def test_no_false_negatives(seed):
    keys = _keys(100 + seed, 512)
    plane = build_plane(_t(keys), 128, 512, 4, device="cpu")
    assert bloom_probe(_t(keys), plane, num_hashes=4).all()


def test_empty_batch():
    plane = torch.zeros((8, 64))
    out = bloom_probe_kernel(torch.zeros(0, dtype=torch.int64), plane)
    assert out.shape == (0,) and out.dtype == torch.float32


def test_wrappers_refuse_bad_inputs(monkeypatch):
    keys = torch.zeros(4, dtype=torch.int64)
    plane = torch.zeros((8, 64))
    meta_keys, meta_plane = keys.to("meta"), plane.to("meta")
    with pytest.raises(ValueError):
        bloom_probe_kernel(meta_keys, meta_plane)
    with pytest.raises(ValueError):
        bloom_probe(keys, meta_plane)
    for bad_keys, bad_plane in ((keys.int(), plane), (keys[None], plane),
                                (keys, plane.double()), (keys, plane[0])):
        with pytest.raises(TypeError):
            bloom_probe_kernel(bad_keys, bad_plane)
    with pytest.raises(ValueError):
        bloom_probe_kernel(keys, torch.zeros((0, 64)))
    with pytest.raises(ValueError):
        bloom_probe_kernel(keys, plane, num_hashes=-1)
    with pytest.raises(TypeError):
        build_plane(keys.int(), 8, 64, 4, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_plane(keys, 8, 64, 4)


@pytest.mark.parametrize("num_hashes", [0, 1, 7, 16])
def test_loads_stop_at_the_first_zero_bit(num_hashes):
    """``probe_loads_ref`` (the count the kernel writes): a key whose k
    floats are all 1 reads k; any other reads up to and including its
    first 0, read one float at a time from the plane here; and the
    product of the floats read is the full product, bit for bit, on the
    contract's 0/1 plane."""
    keys = _keys(101 + num_hashes, 3000)
    plane = build_plane(_t(keys[:600]), 64, 512, max(num_hashes, 1),
                        device="cpu")
    q = _t(keys[300:2300])
    got = probe_loads_ref(q, plane, num_hashes)
    assert got.dtype == torch.int32
    block = (mix32(q, 1) % 64).tolist()
    full = probe_ref(q, plane, num_hashes)
    for i, key in enumerate(q[:400].tolist()):
        floats = [float(plane[block[i], int(mix32(torch.tensor([key]),
                                                  j + 2)) % 512])
                  for j in range(num_hashes)]
        want = floats.index(0.0) + 1 if 0.0 in floats else num_hashes
        assert int(got[i]) == want, (i, floats)
        prod = 1.0
        for f in floats[:want]:
            prod *= f
        assert prod == float(full[i])
    if num_hashes == 7:
        assert {int(x) for x in got} >= {1, 7}
        assert float(got[full == 0].float().mean()) < 7


def test_loads_wrapper_on_cpu():
    """On the CPU ``bloom_probe_loads`` is the plain membership with the
    plain count."""
    keys = _keys(11, 1000)
    plane = build_plane(_t(keys[:500]), 32, 512, 7, device="cpu")
    member, loads = bloom_probe_loads(_t(keys), plane, 7)
    assert torch.equal(member, probe_ref(_t(keys), plane, 7))
    assert torch.equal(loads, probe_loads_ref(_t(keys), plane, 7))
    assert bool((loads[:500] == 7).all())
