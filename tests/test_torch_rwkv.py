"""The port's RWKV-6 serving path (``repro_torch.models.rwkv``, the
``rwkv``/``rwkv_ffn`` blocks of ``lm.py``, ``kernels/rwkv6``,
``launch/serve.py``) against the JAX package's, at reduced size on the CPU.

Inputs come from numpy seeds; JAX parameters (``init_time_mix``,
``init_channel_mix``, ``init_lm``) cross over as numpy arrays through
``repro_torch.convert.lm_params_from_numpy``, so both packages compute
from the same numbers.  On the CPU the port's ``rwkv6`` wrapper runs its
plain version (the per-step recurrence, ``ref.rwkv6_ref``); the JAX side
runs ``wkv_ref``, its ``"xla"`` path (``wkv_chunked``) or its Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` does.

Tolerances (``atol`` = ``rtol``), and why:

* the port's ``wkv_ref`` against the JAX ``wkv_ref``: 2e-5 — the same
  per-step recurrence in float32; only the order of the n-term sums of
  ``einsum`` differs, on outputs of magnitude up to ~100.
* the plain version against the Pallas kernel: 5e-4 in float32 and 5e-2
  in bfloat16, the JAX kernel test's own tolerances
  (``tests/test_kernels.py:117``): the kernel's chunked form reaches the
  same numbers through pairwise log-space decays, another rounding path
  (bfloat16 inputs are rounded once, identically, on both sides).
* the wrapper against ``rwkv6_chunked`` (the JAX wrapper around the
  Pallas kernel): 2e-4 on y and the final state, at unit-scale inputs.
* the two-level twin (``ref.wkv_two_level_ref``, the bf16 tensor-core
  kernel's arithmetic in float32) against the JAX ``wkv_ref``: 2e-4 —
  the chunked form's decays are sums of logw over spans and products of
  exp(logw), where the recurrence multiplies step by step (the largest
  difference seen is 8.5e-5 of 1 + |y|); against the Pallas kernel: 5e-4,
  the JAX kernel test's float32 tolerance (at the fast decay the Pallas
  kernel's chunk-wide cumulative sums of logw ~ -7 lose digits, up to
  2.9e-4 of 1 + |y|).
* the twin with the kernel's operand rounding against the recurrence, on
  bfloat16-rounded inputs: within a quarter of the card's 5e-2 contract.
* the port's ``wkv_chunked`` against the recurrence: 2e-4 — chunked and
  per-step forms, both float32, differ by the exp/log round trip of the
  decays (relative error ~1e-6 per step, summed over a chunk).
* blocks and whole-model logits: 1e-4 — sums over the model width and the
  heads run in another order in XLA than in PyTorch's CPU kernels.
* ``lm_params_from_numpy``: exact — it copies.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels.rwkv6.kernel import rwkv6_kernel
from repro.kernels.rwkv6.ops import rwkv6_chunked
from repro.kernels.rwkv6.ref import wkv_ref as jwkv_ref
from repro.launch.serve import pad_cache_to
from repro.launch.serve import serve_batch as jserve
from repro.models import build_model as jbuild
from repro.models import rwkv as JR
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.kernels.rwkv6.ops import rwkv6
from repro_torch.kernels.rwkv6.ref import (rwkv6_ref, wkv_ref,
                                           wkv_two_level_ref)
from repro_torch.launch.serve import serve_batch, write_prefill_cache
from repro_torch.models import build_model
from repro_torch.models import rwkv as TR

ARCH = "rwkv6-3b"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _cfgs(**kw):
    """The JAX and the port's reduced rwkv6-3b config, same overrides."""
    return jget(ARCH).reduced(**kw), get_config(ARCH).reduced(**kw)


def _wkv_inputs(rng, shape, decay=(-0.6, 0.5)):
    """r/k/v ~ N(0, 1), logw = -exp(N(mean, sd)) as the model's decay
    (``test_kernels.py``'s draw), u ~ 0.1 N(0, 1); float32 arrays of
    ``shape`` (u of ``shape[-2:]``)."""
    r, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    mean, sd = decay
    logw = -np.exp(rng.normal(size=shape) * sd + mean).astype(np.float32)
    u = (rng.normal(size=shape[-2:]) * 0.1).astype(np.float32)
    return r, k, v, logw, u


def _bshn(a, B, H):
    """(BH, S, n) -> (B, S, H, n)."""
    BH, S, n = a.shape
    return a.reshape(B, H, S, n).transpose(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# the kernel's plain version and the wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,n,chunk,dtype", [
    (64, 64, 16, "float32"),
    (128, 64, 32, "float32"),
    (96, 32, 32, "float32"),     # chunk == S/3
    (128, 64, 32, "bfloat16"),
])
def test_wkv_ref_and_wrapper_match_jax(S, n, chunk, dtype):
    """At ``test_kernels.py``'s four shapes: the port's ``wkv_ref``
    against the JAX ``wkv_ref``, and it and the wrapper's CPU path (model
    layout, B 2 x H 2) against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(S + n)
    B, H = 2, 2
    r, k, v, logw, _ = _wkv_inputs(rng, (B * H, S, n))
    u_h = (rng.normal(size=(H, n)) * 0.1).astype(np.float32)
    u = np.tile(u_h, (B, 1))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jr, jk, jv = (jnp.asarray(a, jdt) for a in (r, k, v))
    jlw = jnp.asarray(logw, jdt)             # test_kernels rounds logw too
    want_y, want_s = rwkv6_kernel(jr, jk, jv, jlw, jnp.asarray(u),
                                  chunk=chunk, interpret=True)
    ref_y, ref_s = jwkv_ref(jr, jk, jv, jlw, jnp.asarray(u))
    tr, tk, tv = (_t(a).to(tdt) for a in (r, k, v))
    tlw = _t(np.asarray(jlw, np.float32))
    got_y, got_s = wkv_ref(tr, tk, tv, tlw, _t(u))
    assert got_y.dtype == got_s.dtype == torch.float32
    _close(got_y, ref_y, 2e-5)
    _close(got_s, ref_s, 2e-5)
    tol = 5e-4 if dtype == "float32" else 5e-2
    _close(got_y, want_y, tol)
    _close(got_s, want_s, tol)
    to4 = lambda t: t.reshape(B, H, S, n).transpose(1, 2)  # noqa: E731
    wy, ws = rwkv6(to4(tr), to4(tk), to4(tv), to4(tlw), _t(u_h),
                   chunk=chunk)
    assert wy.shape == (B, S, H, n) and ws.shape == (B, H, n, n)
    _close(wy, _bshn(np.asarray(want_y), B, H), tol)
    _close(ws, np.asarray(want_s).reshape(B, H, n, n), tol)


@pytest.mark.parametrize("decay", [(-0.6, 0.5), (-5.0, 0.1)])
def test_wrapper_matches_rwkv6_chunked(decay):
    """The wrapper in the model's layout against the JAX wrapper around
    the Pallas kernel, y and state, at the model's decay and at a slow
    one (exp(logw) ~ 0.993, the state carries across all 96 steps)."""
    rng = np.random.default_rng(11)
    r, k, v, logw, u = _wkv_inputs(rng, (2, 96, 3, 32), decay)
    want_y, want_s = rwkv6_chunked(*(jnp.asarray(a)
                                     for a in (r, k, v, logw, u)))
    got_y, got_s = rwkv6(*(_t(a) for a in (r, k, v, logw, u)))
    _close(got_y, want_y, 2e-4)
    _close(got_s, want_s, 2e-4)


@pytest.mark.parametrize("chunk", [1, 8, 16, 32, 64])
@pytest.mark.parametrize("decay", [(-0.6, 0.5), (-5.0, 0.1)])
def test_wkv_chunked_at_chunk_sizes(chunk, decay):
    """The port's ``wkv_chunked`` (``attention_impl="plain"``) is exact for
    any chunk: against the recurrence (``ref.rwkv6_ref``) and against the
    JAX ``wkv_chunked`` at the same chunk."""
    rng = np.random.default_rng(chunk)
    args = _wkv_inputs(rng, (2, 64, 2, 32), decay)
    got_y, got_s = TR.wkv_chunked(*(_t(a) for a in args), chunk=chunk)
    ref_y, ref_s = rwkv6_ref(*(_t(a) for a in args))
    _close(got_y, ref_y, 2e-4)
    _close(got_s, ref_s, 2e-4)
    want_y, want_s = JR.wkv_chunked(*(jnp.asarray(a) for a in args),
                                    chunk=chunk)
    _close(got_y, want_y, 2e-4)
    _close(got_s, want_s, 2e-4)


@pytest.mark.parametrize("S", [40, 33, 100])
def test_ragged_length_raises(S):
    """A sequence longer than the chunk must be a multiple of it, as the
    JAX kernel and ``wkv_chunked`` assert; shorter ones take chunk = S."""
    rng = np.random.default_rng(S)
    args = [_t(a) for a in _wkv_inputs(rng, (1, S, 2, 16))]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        rwkv6(*args)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TR.wkv_chunked(*args)
    tc = get_config(ARCH).reduced()
    p = TR.init_time_mix(torch.Generator().manual_seed(0), tc)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TR.time_mix_full(p, _t(rng.normal(size=(1, S, 64))), tc)
    short = [a[:, :20] for a in args[:4]] + [args[4]]
    y, _ = rwkv6(*short)
    _close(y, rwkv6_ref(*short)[0], 0)


def test_wrapper_checks_its_arguments():
    """Wrong dtypes and shapes raise; a device with no kernel raises
    rather than falling back to the plain version."""
    rng = np.random.default_rng(0)
    r, k, v, logw, u = (_t(a) for a in _wkv_inputs(rng, (1, 32, 2, 16)))
    with pytest.raises(TypeError, match="float32 logw"):
        rwkv6(r, k, v, logw.bfloat16(), u)
    with pytest.raises(TypeError, match="one dtype"):
        rwkv6(r.bfloat16(), k, v, logw, u)
    with pytest.raises(ValueError, match="u"):
        rwkv6(r, k, v, logw, u[:1])
    meta = [t.to("meta") for t in (r, k, v, logw, u)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rwkv6(*meta)


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernel's algorithm (ref.wkv_two_level_ref) and the
# wrapper's choice of kernel
# ---------------------------------------------------------------------------

# (mean, sd) of ww, logw = -exp(ww): the model's init, a slow decay
# (exp(logw) ~ 0.993) and a fast one (logw ~ -7.4)
DECAYS = {"model": (-0.6, 0.5), "slow": (-5.0, 0.1), "fast": (2.0, 0.1)}


@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("S", [16, 32, 96, 256])
@pytest.mark.parametrize("n", [16, 32, 64])
def test_two_level_twin_matches_jax(n, S, decay):
    """The twin of the bf16 kernel's arithmetic (chunks of 32, sub-chunks
    of 16 and halves of 8 decayed from / to their ends, the triangles
    along the diagonal pairwise, the state carried once a chunk), in
    float32, against the JAX recurrence (``wkv_ref``) to 2e-4 and the
    Pallas kernel in interpret mode to 5e-4, y and the final state."""
    rng = np.random.default_rng(S + n)
    args = _wkv_inputs(rng, (2, S, n), DECAYS[decay])
    args = args[:4] + ((rng.normal(size=(2, n)) * 0.1).astype(np.float32),)
    got_y, got_s = wkv_two_level_ref(*(_t(a) for a in args))
    assert bool(torch.isfinite(got_y).all() and torch.isfinite(got_s).all())
    jargs = [jnp.asarray(a) for a in args]
    ref_y, ref_s = jwkv_ref(*jargs)
    _close(got_y, ref_y, 2e-4)
    _close(got_s, ref_s, 2e-4)
    pk_y, pk_s = rwkv6_kernel(*jargs, chunk=32, interpret=True)
    _close(got_y, pk_y, 5e-4)
    _close(got_s, pk_s, 5e-4)


def test_one_level_split_overflows_where_the_twin_does_not():
    """At the fast decay (logw ~ -7.4) the one-level split of the
    intra-chunk matrix, (r e^{Lc_prev}) (k e^{-Lc})^T over a chunk of 32,
    takes e^{-Lc} past float32's range within 13 tokens and gives
    non-finite values; the twin, whose exponents are all <= 0, stays
    finite and matches the recurrence."""
    rng = np.random.default_rng(3)
    r, k, v, logw, _ = (_t(a) for a in _wkv_inputs(rng, (2, 32, 64),
                                                    DECAYS["fast"]))
    u = _t((rng.normal(size=(2, 64)) * 0.1).astype(np.float32))
    Lc = torch.cumsum(logw, 1)
    # e^{-Lc} passes float32's largest value at the 13th token
    assert bool(torch.isinf(torch.exp(-Lc[:, 12])).any())
    naive = (r * torch.exp(Lc - logw)) @ (k * torch.exp(-Lc)).transpose(1, 2)
    assert not bool(torch.isfinite(naive).all())
    got_y, got_s = wkv_two_level_ref(r, k, v, logw, u)
    assert bool(torch.isfinite(got_y).all() and torch.isfinite(got_s).all())
    want_y, want_s = wkv_ref(r, k, v, logw, u)
    _close(got_y, want_y, 2e-4)
    _close(got_s, want_s, 2e-4)


@pytest.mark.parametrize("rounding,decay,limit", [
    ("bf16_split", "model", 0.25), ("bf16_split", "slow", 0.25),
    ("bf16_split", "fast", 0.25), ("tf32", "slow", None)])
def test_kernel_operand_rounding_against_the_bf16_contract(rounding, decay,
                                                           limit):
    """The twin with the tensor-core operands rounded as the kernel takes
    them (``bf16_split``: each float32 operand as two bf16 halves) keeps
    y and the state within a quarter of the card's bf16 contract, |err|
    <= 5e-2 (1 + |want|), over 2048 tokens on bfloat16-rounded inputs.
    One-pass TF32 operands, the design the kernel does not use, miss it
    at the slow decay, where the state sums ~150 tokens."""
    rng = np.random.default_rng(0)
    r, k, v = (_t(a).bfloat16().float()
               for a in _wkv_inputs(rng, (4, 2048, 64))[:3])
    mean, sd = DECAYS[decay]
    logw = -_t(np.exp(rng.normal(size=(4, 2048, 64)) * sd + mean))
    u = _t((rng.normal(size=(4, 64)) * 0.1).astype(np.float32))
    got = wkv_two_level_ref(r, k, v, logw, u, rounding=rounding)
    want = wkv_ref(r, k, v, logw, u)
    share = max(((g - w).abs() / (5e-2 * (1 + w.abs()))).max().item()
                for g, w in zip(got, want))
    if limit is None:
        assert share > 1.0
    else:
        assert share <= limit


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that the wrapper takes
    its kernel route on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, "rwkv6:bf16_tc"), (torch.float32, "rwkv6:f32_cuda_core")])
def test_wrapper_routes_by_dtype(monkeypatch, dtype, kernel):
    """CUDA r/k/v in bfloat16 launch the tensor-core kernel
    (``rwkv6_mma.cu``) and count ``rwkv6:bf16_tc``; float32 ones launch
    the per-step kernel (``rwkv6.cu``) and count ``rwkv6:f32_cuda_core``.
    Each call counts one launch of the wrapper and of that kernel, and
    nothing else.  The device guard, the stream and the C entry are
    recorders, as in ``test_torch_device_guard.py``."""
    log = []

    @contextlib.contextmanager
    def device(dev):
        log.append(("enter", str(dev)))
        yield

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 0xC0FFEE

    def kernel_fn(name, symbol, argtypes):
        def fn(*args):
            log.append(("entry", name, symbol, len(args), args[-1]))
            return 0
        return fn

    shim = types.SimpleNamespace(**{n: getattr(torch, n) for n in dir(torch)
                                    if not n.startswith("__")})
    shim.empty = lambda *a, device=None, **kw: torch.empty(*a, **kw)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(_build, "kernel_fn", kernel_fn)
    monkeypatch.setattr(rwkv_ops, "torch", shim)
    saved = dict(_build.LAUNCHES)
    try:
        rng = np.random.default_rng(1)
        r, k, v, logw, u = (_t(a) for a in _wkv_inputs(rng, (1, 64, 2, 32)))
        r, k, v = (t.to(dtype).as_subclass(_OnCuda) for t in (r, k, v))
        logw, u = (t.as_subclass(_OnCuda) for t in (logw, u))
        for call in (1, 2):
            before = dict(_build.LAUNCHES)
            y, state = rwkv_ops.rwkv6(r, k, v, logw, u)
            assert y.shape == (1, 64, 2, 32) and state.shape == (1, 2, 32, 32)
            moved = {name: _build.LAUNCHES[name] - before[name]
                     for name in before
                     if _build.LAUNCHES[name] != before[name]}
            assert moved == {"rwkv6": 1, kernel: 1}
        source = "rwkv6_mma" if dtype == torch.bfloat16 else "rwkv6"
        entries = [e for e in log if e[0] == "entry"]
        assert entries == [("entry", source, f"{source}_launch", 24,
                            0xC0FFEE)] * 2
        assert ("enter", "cuda:0") in log
    finally:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved)


def test_probe_times_every_stretch_of_the_chunk_loop():
    """``tools/rwkv6_probe.py`` instruments a copy of the bf16 kernel's
    source: one counter for each stretch of the chunk loop between its
    barriers (two barriers, three stretches), saved after the loop and
    read through an entry of its own."""
    from repro_torch.tools.rwkv6_probe import instrument
    src = (_build.CSRC_DIR / "rwkv6_mma.cu").read_text()
    probed, n = instrument(src)
    loop = probed[probed.index("  for (int c = 0; c < nchunks; ++c) {"):
                  probed.index("g_probe[probe][threadIdx.x / 32][q]")]
    assert n == 3 == loop.count("__syncthreads();") + 1
    assert [f"prof[{q}] +=" in loop for q in range(n)] == [True] * n
    assert probed.count("clock64()") == src.count("clock64()") + n + 1
    assert 'extern "C" int rwkv6_probe_read' in probed


# ---------------------------------------------------------------------------
# time mix and channel mix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_time_mix_full_and_step(jax_impl):
    """``time_mix_full`` through both of the port's paths ("flash": the
    wrapper's plain version on the CPU, and "plain": ``wkv_chunked``)
    against the JAX package's "xla" and "pallas", with the cache; then
    two ``time_mix_step``s from that cache, written in place."""
    jc, tc = _cfgs()
    jp = JR.init_time_mix(jax.random.PRNGKey(3), jc)
    tp = {k: _t(v) for k, v in _np_tree(jp).items()}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, 64)).astype(np.float32)
    steps = rng.normal(size=(2, 2, 1, 64)).astype(np.float32)
    want, wcache = JR.time_mix_full(jp, jnp.asarray(x),
                                    jc.replace(attention_impl=jax_impl))
    for impl in ("flash", "plain"):
        got, cache = TR.time_mix_full(tp, _t(x),
                                      tc.replace(attention_impl=impl))
        _close(got, want, 1e-4)
        _close(cache["state"], wcache["state"], 1e-4)
        _close(cache["x_prev"], wcache["x_prev"], 0)
        assert cache["state"].shape == (2, 4, 16, 16)
        jcache = wcache
        cache = {n: t.clone() for n, t in cache.items()}
        for xs in steps:
            want_s, jcache = JR.time_mix_step(jp, jnp.asarray(xs), jcache, jc)
            got_s, new = TR.time_mix_step(tp, _t(xs), cache, tc)
            assert new is cache and new["state"] is cache["state"]
            _close(got_s, want_s, 1e-4)
            _close(cache["state"], jcache["state"], 1e-4)
            _close(cache["x_prev"], jcache["x_prev"], 0)


def test_channel_mix_full_and_step():
    jc, tc = _cfgs()
    jp = JR.init_channel_mix(jax.random.PRNGKey(5), jc)
    tp = {k: _t(v) for k, v in _np_tree(jp).items()}
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    want, jcache = JR.channel_mix_full(jp, jnp.asarray(x), jc)
    got, cache = TR.channel_mix_full(tp, _t(x), tc)
    _close(got, want, 1e-4)
    _close(cache["x_prev"], jcache["x_prev"], 0)
    cache = {"x_prev": cache["x_prev"].clone()}
    for xs in rng.normal(size=(2, 2, 1, 64)).astype(np.float32):
        want, jcache = JR.channel_mix_step(jp, jnp.asarray(xs), jcache, jc)
        got, new = TR.channel_mix_step(tp, _t(xs), cache, tc)
        assert new is cache
        _close(got, want, 1e-4)
        _close(cache["x_prev"], jcache["x_prev"], 0)


def test_group_norm_uses_the_population_variance():
    rng = np.random.default_rng(7)
    y = rng.normal(size=(2, 3, 64)).astype(np.float32) * 3 + 1
    s = rng.normal(size=64).astype(np.float32)
    _close(TR._group_norm(_t(y), _t(s), 1e-5, 16),
           JR._group_norm(jnp.asarray(y), jnp.asarray(s), 1e-5, 16), 2e-6)


# ---------------------------------------------------------------------------
# parameters across, the whole model, the server
# ---------------------------------------------------------------------------

def test_lm_params_from_numpy_keeps_float32_leaves():
    """In a bfloat16 model, ``w_base`` and ``u`` stay float32 across
    ``lm_params_from_numpy``, the channel mix's ``mlp`` sub-dict comes
    along, and every leaf is copied exactly."""
    jc, tc = _cfgs(dtype="bfloat16", param_dtype="bfloat16")
    jp = _np_tree(jbuild(jc).init(jax.random.PRNGKey(1)))
    tp = lm_params_from_numpy(tc, jp, "cpu")
    assert len(tp["layers"]) == tc.num_layers
    for i, layer in enumerate(tp["layers"]):
        assert set(layer) == {"norm1", "norm2", "mixer", "mlp"}
        assert set(layer["mlp"]) == {"mu_k", "mu_r", "wk", "wv", "wr"}
        for name, t in layer["mixer"].items():
            want = jp["layers"]["sub0"]["mixer"][name][i]
            assert t.dtype == (torch.float32 if name in ("w_base", "u")
                               else torch.bfloat16), name
            np.testing.assert_array_equal(t.float().numpy(),
                                          want.astype(np.float32))
    model = build_model(tc, "cpu", params=tp)
    native = build_model(tc, "cpu").params["layers"][0]["mixer"]
    assert native["w_base"].dtype == native["u"].dtype == torch.float32
    assert native["wr"].dtype == torch.bfloat16
    logits, _ = model.prefill(torch.zeros((1, 8), dtype=torch.int64))
    assert torch.isfinite(logits).all()


def _models(seed=0, **kw):
    jc, tc = _cfgs(**kw)
    api = jbuild(jc)
    jp = api.init(jax.random.PRNGKey(seed))
    tp = lm_params_from_numpy(tc, _np_tree(jp), "cpu")
    return api, jp, build_model(tc, "cpu", params=tp), tp


@pytest.mark.parametrize("impl", ["flash", "plain"])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_prefill_and_decode_match_jax(jax_impl, impl):
    """``lm_prefill`` logits and every cache tensor (state, both
    ``x_prev``), then three ``lm_decode_step``s, in float32: the port's
    "flash" and "plain" against the JAX package's "xla" and "pallas"."""
    api, jp, model, _ = _models(attention_impl=jax_impl)
    model.cfg = model.cfg.replace(attention_impl=impl)
    rng = np.random.default_rng(8)
    B, P, G = 2, 32, 3
    toks = rng.integers(0, model.cfg.vocab_size, (B, P + G))
    want, jcache = jax.jit(api.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :P], jnp.int32)})
    got, pcache = model.prefill(torch.from_numpy(toks[:, :P]))
    _close(got, want, 1e-4)
    jl = jcache["layers"]["sub0"]
    for i, c in enumerate(pcache):
        assert set(c) == {"mixer", "mlp"}
        _close(c["mixer"]["state"], jl["mixer"]["state"][i], 1e-4)
        _close(c["mixer"]["x_prev"], jl["mixer"]["x_prev"][i], 1e-5)
        _close(c["mlp"]["x_prev"], jl["mlp"]["x_prev"][i], 1e-5)
    jcache = pad_cache_to(jcache, api, B, P + G)
    cache = model.init_cache(B, P + G)
    write_prefill_cache(cache, pcache)
    decode = jax.jit(api.decode_step)
    for i in range(G):
        want, jcache = decode(jp, jcache,
                              jnp.asarray(toks[:, P + i:P + i + 1],
                                          jnp.int32), jnp.int32(P + i))
        got, cache = model.decode_step(
            cache, torch.from_numpy(toks[:, P + i:P + i + 1]), P + i)
        _close(got, want, 1e-4)
    _close(cache[1]["mixer"]["state"],
           jcache["layers"]["sub0"]["mixer"]["state"][1], 1e-4)


def test_serve_batch_matches_jax():
    """The JAX ``serve_batch`` and the port's, from the same seed and the
    same weights: equal greedy tokens, and a decode cache of the RWKV
    state and the two ``x_prev`` rows per layer, every byte counted."""
    B, P, G = 2, 32, 8
    want = jserve(ARCH, True, B, P, G, seed=0)
    _, _, model, tp = _models(seed=0)
    got = serve_batch(ARCH, True, B, P, G, seed=0, device="cpu", params=tp)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["logits_finite"]
    cfg = model.cfg
    n, d = cfg.rwkv_head_dim, cfg.d_model
    per_layer = (B * (d // n) * n * n + 2 * B * d) * 4
    assert got["kv_cache_bytes"] == cfg.num_layers * per_layer


def test_write_prefill_cache_copies_the_recurrent_state():
    """Every tensor of an RWKV layer's prefill cache lands in the decode
    cache, whole; the decode cache keeps its own storage."""
    tc = get_config(ARCH).reduced()
    model = build_model(tc, "cpu")
    cache = model.init_cache(2, 40)
    gen = torch.Generator().manual_seed(0)
    pre = [{part: {name: torch.randn(t.shape, generator=gen)
                   for name, t in tensors.items()}
            for part, tensors in c.items()} for c in cache]
    before = [c["mixer"]["state"].data_ptr() for c in cache]
    write_prefill_cache(cache, pre)
    for c, p, ptr in zip(cache, pre, before):
        assert c["mixer"]["state"].data_ptr() == ptr
        for part in ("mixer", "mlp"):
            for name, t in p[part].items():
                assert torch.equal(c[part][name], t), (part, name)


def test_mixed_block_pairings_match_jax():
    """Any (mixer, mlp) pairing is a block, as in the JAX package: a
    stack of (attn, rwkv_ffn) and (rwkv, dense) blocks, prefill and two
    decode steps against JAX, with both caches in one layer list."""
    pattern = (("attn", "rwkv_ffn"), ("rwkv", "dense"))
    jc = jget("qwen3-14b").reduced(pattern=pattern)
    tc = get_config("qwen3-14b").reduced(pattern=pattern)
    api = jbuild(jc)
    jp = api.init(jax.random.PRNGKey(2))
    model = build_model(tc, "cpu",
                        params=lm_params_from_numpy(tc, _np_tree(jp), "cpu"))
    rng = np.random.default_rng(9)
    B, P, G = 2, 32, 2
    toks = rng.integers(0, tc.vocab_size, (B, P + G))
    want, jcache = jax.jit(api.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :P], jnp.int32)})
    got, pcache = model.prefill(torch.from_numpy(toks[:, :P]))
    _close(got, want, 1e-4)
    assert set(pcache[0]) == {"mixer", "mlp"} and set(pcache[1]) == {"mixer"}
    assert set(pcache[0]["mixer"]) == {"k", "v"}
    assert set(pcache[1]["mixer"]) == {"state", "x_prev"}
    jcache = pad_cache_to(jcache, api, B, P + G)
    cache = model.init_cache(B, P + G)
    write_prefill_cache(cache, pcache)
    decode = jax.jit(api.decode_step)
    for i in range(G):
        want, jcache = decode(jp, jcache,
                              jnp.asarray(toks[:, P + i:P + i + 1],
                                          jnp.int32), jnp.int32(P + i))
        got, cache = model.decode_step(
            cache, torch.from_numpy(toks[:, P + i:P + i + 1]), P + i)
        _close(got, want, 1e-4)
