"""The port's dense LM serving path (``repro_torch.models``,
``repro_torch.launch.serve``, ``kernels/flash_attention``) against the JAX
package's, at reduced size on the CPU.

Inputs come from numpy seeds; JAX parameters (``init_attention``,
``init_lm``) cross over as numpy arrays through
``repro_torch.convert.lm_params_from_numpy``, so both packages compute
from the same numbers.  On the CPU the port's flash-attention wrapper runs
its plain version (``ref.py``); the JAX side runs its ``"xla"`` attention or
its Pallas kernel in interpret mode, as ``tests/test_kernels.py`` does.

Tolerances, and why:

* float32 elementwise layers (norms): 2e-6 — the same formula, one or two
  rounding steps apart (rsqrt, mean order).
* RoPE: 1e-5 — the inverse frequencies come from two ``pow``
  implementations that may differ by an ulp, and the angle multiplies that
  by the position (up to 64 here).
* float32 attention and whole-model logits: 1e-4 — sums over heads, keys
  and the model width run in another order in XLA than in PyTorch's CPU
  kernels; observed differences are ~2e-6 on logits of magnitude ~3.
* the flash-attention plain version against the Pallas kernel: 2e-5 in
  float32 and 2e-2 in bfloat16, the JAX kernel test's own tolerances
  (``tests/test_kernels.py:58``), since both compute in float32 and round
  the output to the input dtype.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.launch.serve import pad_cache_to
from repro.launch.serve import serve_batch as jserve
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                    tma_strides)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch.serve import serve_batch, write_prefill_cache
from repro_torch.models import build_model
from repro_torch.models import layers as TL

ARCHS = ("qwen3-14b", "glm4-9b", "phi3-mini-3.8b", "qwen1.5-110b")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _cfgs(arch, **kw):
    """The JAX and the port's reduced config of ``arch``, same overrides."""
    return jget(arch).reduced(**kw), get_config(arch).reduced(**kw)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ("rwkv6-3b", "deepseek-moe-16b",
                                  "mixtral-8x7b", "jamba-1.5-large-398b",
                                  "whisper-base", "qwen2-vl-72b"))
def test_configs_match_the_jax_package(arch):
    j, t = jget(arch), get_config(arch)
    shared = ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "pattern", "rope_theta",
              "rotary_pct", "qkv_bias", "qk_norm", "window", "norm", "act",
              "norm_eps", "dtype", "tie_embeddings", "rwkv_head_dim",
              "rwkv_decay_lora", "moe", "prelude", "mamba_d_state",
              "mamba_d_conv", "mamba_expand", "mamba_chunk", "encoder",
              "mrope_sections", "embed_inputs", "family")

    def fields(c):      # MoEConfig, EncoderConfig: each package's own
        return {f: (dataclasses.asdict(getattr(c, f))
                    if f in ("moe", "encoder") and getattr(c, f) is not None
                    else getattr(c, f))
                for f in shared}

    for cj, ct in ((j, t), (j.reduced(), t.reduced())):
        assert fields(cj) == fields(ct)
    assert t.param_count() == j.param_count()


def test_unported_archs_name_the_roadmap():
    """Every architecture of the JAX package is ported; an unknown name
    still raises ``KeyError``."""
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS as TARCHS
    assert list(TARCHS) == list(JARCHS) and len(TARCHS) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-large")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_apply_norm_and_rms_head_norm(norm):
    rng = np.random.default_rng(1)
    jc, tc = _cfgs("qwen3-14b", norm=norm)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    want = JL.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jc)
    got = TL.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), tc)
    _close(got, want, 2e-6)
    h = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    s = rng.normal(size=16).astype(np.float32)
    _close(TL.rms_head_norm(_t(s), _t(h), 1e-5),
           JL.rms_head_norm(jnp.asarray(s), jnp.asarray(h), 1e-5), 2e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_rope(arch):
    """Full rotary (qwen3, phi3) and glm4's partial rotary (half the head
    dim rotates, the rest passes through)."""
    rng = np.random.default_rng(2)
    jc, tc = _cfgs(arch)
    x = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(64), (2, 1))
    got = TL.apply_rope(_t(x), torch.from_numpy(pos), tc)
    _close(got, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jc), 1e-5)
    if tc.rotary_pct < 1:
        np.testing.assert_array_equal(got[..., 8:].numpy(), x[..., 8:])


def _attn_params(jc, seed):
    jp = JL.init_attention(jax.random.PRNGKey(seed), jc)
    if "bq" in jp:      # the init's zero biases would not test the bias
        rng = np.random.default_rng(seed)
        jp = {k: (jnp.asarray(rng.normal(size=v.shape), jnp.float32)
                  if k.startswith("b") else v) for k, v in jp.items()}
    return jp, {k: _t(v) for k, v in _np_tree(jp).items()}


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch,window", [("qwen3-14b", None),
                                         ("glm4-9b", None),
                                         ("phi3-mini-3.8b", None),
                                         ("qwen3-14b", 8)])
def test_attention_full(arch, window, jax_impl):
    """The port's two attentions ("flash" through the plain version on the
    CPU, and "plain") against the JAX package's "xla" and "pallas"."""
    jc, tc = _cfgs(arch, window=window)
    jp, tp = _attn_params(jc, 3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, 64)).astype(np.float32)
    pos = np.tile(np.arange(32), (2, 1))
    want, wkv = JL.attention_full(jp, jnp.asarray(x), jnp.asarray(pos),
                                  jc.replace(attention_impl=jax_impl))
    for impl in ("flash", "plain"):
        got, gkv = TL.attention_full(tp, _t(x), torch.from_numpy(pos),
                                     tc.replace(attention_impl=impl))
        _close(got, want, 1e-4)
        _close(gkv["k"], wkv["k"], 1e-4)
        _close(gkv["v"], wkv["v"], 1e-4)


@pytest.mark.parametrize("window,smax,pos", [(None, 24, 0), (None, 24, 17),
                                             (8, 8, 5), (8, 8, 13)])
def test_attention_decode(window, smax, pos):
    """One decode step against a cache holding random past k/v: a plain
    cache, a cold ring (pos < window) and a warm ring of window slots
    (pos >= window, the new token overwrites slot pos % window)."""
    jc, tc = _cfgs("qwen3-14b", window=window)
    jp, tp = _attn_params(jc, 5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    cache = {n: rng.normal(size=(2, smax, 2, 16)).astype(np.float32)
             for n in ("k", "v")}
    want, wc = JL.attention_decode(jp, jnp.asarray(x), jnp.int32(pos),
                                   jax.tree.map(jnp.asarray, cache), jc)
    tcache = {n: _t(v) for n, v in cache.items()}
    got, gc = TL.attention_decode(tp, _t(x), pos, tcache, tc)
    _close(got, want, 1e-4)
    for n in ("k", "v"):
        assert gc[n] is tcache[n]               # written in place
        _close(gc[n], wc[n], 1e-4)


# ---------------------------------------------------------------------------
# the flash-attention kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,d,causal,window,dtype", [
    (128, 64, True, None, "float32"),
    (256, 64, False, None, "float32"),
    (256, 128, True, None, "float32"),
    (256, 96, True, None, "float32"),          # phi3 head_dim
    (512, 64, True, 128, "float32"),           # SWA
    (256, 64, True, None, "bfloat16"),
])
def test_flash_plain_version_matches_pallas_kernel(S, d, causal, window,
                                                   dtype):
    """``ref.attention_ref`` against ``flash_attention_kernel`` in interpret
    mode, at the JAX kernel test's shapes."""
    rng = np.random.default_rng(S + d + int(causal))
    q, k, v = (rng.normal(size=(3, S, d)).astype(np.float32)
               for _ in range(3))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = flash_attention_kernel(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                  causal=causal, window=window, block_q=64,
                                  block_kv=64, interpret=True)
    got = attention_ref(*(_t(a).to(tdt) for a in (q, k, v)), causal=causal,
                        window=window)
    assert got.dtype == tdt
    tol = 2e-5 if dtype == "float32" else 2e-2
    _close(got.float(), want, tol)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 24)])
def test_flash_wrapper_gqa_matches_jax_wrapper(causal, window):
    """GQA (H 8 over KV 2) in the model's layout: the port's wrapper against
    the JAX wrapper, which repeats kv heads around the Pallas kernel."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 64, 8, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, 64, 2, 64)).astype(np.float32)
            for _ in range(2))
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, block_q=32, block_kv=32)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("S,causal,window", [(77, True, None),
                                             (77, False, None),
                                             (130, True, 20), (1, True, None)])
def test_flash_wrapper_ragged_lengths(S, causal, window):
    """Ragged S, which the Pallas kernel does not take: the wrapper's plain
    version against the layers' grouped ``_sdpa`` under the additive mask,
    an independent plain attention."""
    rng = np.random.default_rng(S)
    q = _t(rng.normal(size=(2, S, 4, 32)))
    k, v = (_t(rng.normal(size=(2, S, 2, 32))) for _ in range(2))
    got = flash_attention(q, k, v, causal=causal, window=window)
    cfg = get_config("qwen3-14b").reduced(window=window)
    mask = TL.causal_mask(S, S, window) if causal else None
    _close(got, TL._sdpa(q, k, v, mask, cfg), 2e-5)


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
def test_tma_strides_take_packed_and_head_offset_views(d):
    """What the bf16 kernel's TMA maps read in place: a packed tensor, and
    a view one head into a wider one (a 2d-byte offset, 16-byte aligned
    at every head dim), with their (batch, seq, head) strides."""
    assert tma_strides(_bf16((2, 9, 4, d))) == [9 * 4 * d, 4 * d, d]
    view = _bf16((2, 9, 8, d))[:, :, 1:5]
    assert view.data_ptr() % 16 == 0
    assert tma_strides(view) == [9 * 8 * d, 8 * d, d]


def test_tma_strides_refuse_what_tma_cannot_read():
    """A base off the 16-byte grid, a stride that is no multiple of 16
    bytes, a non-contiguous last dimension: None (the wrapper then copies
    to a packed tensor).  A size-1 dimension's stride is never stepped
    over, so the packed one stands in for it."""
    flat = _bf16(2 * 9 * 4 * 64 + 8)
    assert tma_strides(flat[1:1 + 2 * 9 * 4 * 64].view(2, 9, 4, 64)) is None
    assert tma_strides(_bf16((2, 9, 4, 68))[..., :64]) is None   # 136 B rows
    assert tma_strides(_bf16((2, 9, 64, 4)).transpose(2, 3)) is None
    one = torch.as_strided(_bf16(4 * 64 * 3), (1, 3, 4, 64),
                           (5, 4 * 64, 64, 1))
    assert tma_strides(one) == [3 * 4 * 64, 4 * 64, 64]


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _models(arch, seed=0):
    jc, tc = _cfgs(arch)
    api = jbuild(jc)
    jp = api.init(jax.random.PRNGKey(seed))
    tp = lm_params_from_numpy(tc, _np_tree(jp), "cpu")
    return api, jp, build_model(tc, "cpu", params=tp), tp


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """``lm_prefill`` logits and k/v, then three ``lm_decode_step``s against
    the JAX cache padded to capacity, in float32."""
    api, jp, model, _ = _models(arch)
    rng = np.random.default_rng(8)
    B, P, G = 2, 12, 3
    toks = rng.integers(0, model.cfg.vocab_size, (B, P + G))
    want, jcache = jax.jit(api.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :P], jnp.int32)})
    got, pcache = model.prefill(torch.from_numpy(toks[:, :P]))
    _close(got, want, 1e-4)
    for i, c in enumerate(pcache):
        _close(c["mixer"]["k"], jcache["layers"]["sub0"]["mixer"]["k"][i],
               1e-4)
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


def test_serve_batch_matches_jax():
    """The JAX ``serve_batch`` and the port's, from the same seed and the
    same weights: equal greedy tokens; and, teacher-forced on the JAX
    tokens, every step's logits within 1e-4."""
    arch, B, P, G = "qwen3-14b", 2, 16, 8
    want = jserve(arch, True, B, P, G, seed=0)
    api, jp, model, tp = _models(arch, seed=0)
    got = serve_batch(arch, True, B, P, G, seed=0, device="cpu", params=tp)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["logits_finite"]
    assert got["kv_cache_bytes"] == 2 * 2 * B * (P + G) * 2 * 16 * 4

    prompts = np.random.default_rng(0).integers(0, model.cfg.vocab_size,
                                                (B, P))
    jl, jcache = jax.jit(api.prefill)(
        jp, {"tokens": jnp.asarray(prompts, jnp.int32)})
    tl, pcache = model.prefill(torch.from_numpy(prompts))
    _close(tl, jl, 1e-4)
    jcache = pad_cache_to(jcache, api, B, P + G)
    cache = model.init_cache(B, P + G)
    write_prefill_cache(cache, pcache)
    decode = jax.jit(api.decode_step)
    toks = want["tokens"]
    for i in range(G):
        jl, jcache = decode(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                            jnp.int32(P + i))
        tl, cache = model.decode_step(
            cache, torch.from_numpy(toks[:, i:i + 1].astype(np.int64)), P + i)
        _close(tl, jl, 1e-4)


def test_ring_cache_keeps_the_last_window_positions():
    """A prompt longer than a sliding window: the ring cache gets the last
    ``window`` positions, each at slot pos % window."""
    tc = get_config("qwen3-14b").reduced(window=8)
    model = build_model(tc, "cpu")
    cache = model.init_cache(1, 30)
    assert cache[0]["mixer"]["k"].shape[1] == 8
    src = torch.arange(20, dtype=torch.float32).view(1, 20, 1, 1).expand(
        1, 20, 2, 16)
    write_prefill_cache(cache, [{"mixer": {"k": src, "v": src}}])
    slots = cache[0]["mixer"]["k"][0, :, 0, 0]
    assert [int(p) % 8 for p in slots] == list(range(8))
    assert sorted(int(p) for p in slots) == list(range(12, 20))


def test_entry_points_raise_without_cuda_unless_cpu(monkeypatch):
    """``build_model`` and ``serve_batch`` default to the card and raise
    when there is none; ``device="cpu"`` runs the plain path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-14b").reduced()
    calls = {
        "build_model": lambda **d: build_model(cfg, **d),
        "serve_batch": lambda **d: serve_batch("qwen3-14b", True, 1, 4, 2,
                                               **d),
        "lm_params_from_numpy": lambda **d: lm_params_from_numpy(
            cfg, {"embed": np.zeros((4, 2), np.float32),
                  "layers": {"sub0": {}}}, **d),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call(device="cuda")
        assert call(device="cpu") is not None, name
