"""The port's encoder-decoder (``repro_torch.models.encdec``, ``EncDec``,
``whisper-base``, ``convert.py``'s encoder-decoder tree, the encoder
branches of ``launch/serve.py`` and ``launch/train.py``) against the JAX
package's, at reduced size on the CPU.

Inputs come from numpy seeds; the reference's ``init_encdec`` parameters
cross over as numpy arrays through ``convert.lm_params_from_numpy``, and
the port's gradients come back through ``lm_params_to_numpy``, so both
packages compute from the same numbers.  The reduced ``whisper-base`` has
2 encoder and 2 decoder layers of width 64, 4 heads of 16, layer norms,
GELU MLPs, tied embeddings and no positional embeddings
(``rotary_pct=0``).  The JAX side runs its ``"xla"`` attention, the port
its ``"flash"`` attention (the kernel's plain version on the CPU) and its
``"plain"`` one.

The reference's server pads the cross K/V out to the decode capacity with
zero keys (``pad_cache_to`` with ``init_cache``'s ``enc_seq=max_seq``),
which every decode step attends to unmasked; the port keeps them at the
encoder's length.  So the port's decode is held to the reference's
``encdec_decode_step`` on an unpadded cross cache, and the fault is
pinned by :func:`test_reference_serve_pads_whisper_cross_keys_with_zeros`.

Tolerances, as ``tests/test_torch_lm.py`` and ``tests/test_torch_train.py``
use them: encoder outputs, logits and caches 1e-4 (sums in another
order); the loss rel 1e-5; gradients 1e-4 of each leaf's largest entry;
three train steps: losses rel 1e-5, gradient norms rel 1e-4, parameters
1e-5 absolute and the first moments 1e-4 of each leaf's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import pipeline as JP
from repro.launch import train as JT
from repro.launch.serve import pad_cache_to
from repro.models import build_model as jbuild
from repro.models import encdec as JED
from repro.optim import adamw as JA
from repro_torch.configs import get_config
from repro_torch.convert import (adamw_state_from_numpy,
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.launch import train as TT
from repro_torch.launch.serve import (serve_batch, serve_inputs,
                                      write_prefill_cache)
from repro_torch.models import EncDec, build_model
from repro_torch.models import encdec as TED
from repro_torch.optim import adamw as TA
from repro_torch.utils.tree import (leaves, leaves_with_path, tree_map,
                                    unflatten_like)

ARCH = "whisper-base"
B, P, G = 2, 16, 8          # batch, prompt (= encoder frames), generated


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _by_name(tree) -> dict:
    return {name: np.asarray(leaf) for name, leaf in leaves_with_path(tree)}


_MODELS = {}


def _models():
    """The JAX reduced whisper (seed 0) and its parameters, and the port's
    model holding the same numbers."""
    if not _MODELS:
        jc, tc = jget(ARCH).reduced(), get_config(ARCH).reduced()
        api = jbuild(jc)
        jp = jax.jit(api.init)(jax.random.PRNGKey(0))
        tp = lm_params_from_numpy(tc, _np(jp), "cpu")
        _MODELS["m"] = (api, jp, build_model(tc, "cpu", params=tp))
    return _MODELS["m"]


def _inputs(seed=0):
    """The reference server's draws: prompts, then (B, P, d_input)
    frames."""
    rng = np.random.default_rng(seed)
    cfg = get_config(ARCH).reduced()
    toks = rng.integers(0, cfg.vocab_size, (B, P))
    embeds = rng.normal(size=(B, P, cfg.encoder.d_input)).astype(np.float32)
    return toks, embeds


def _jax_decode_cache(jcache, max_seq):
    """The reference's prefill cache with the self k/v padded to
    ``max_seq`` and the cross K/V left at the encoder's length."""
    pad = lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, max_seq - a.shape[2]),
                                (0, 0), (0, 0)])  # noqa: E731
    return {"self": jax.tree.map(pad, jcache["self"]),
            "cross_k": jcache["cross_k"], "cross_v": jcache["cross_v"]}


def _port_cache(model, toks, embeds):
    """The port's prefill logits and its decode cache at capacity P + G."""
    logits, pcache = model.prefill({"tokens": torch.from_numpy(toks),
                                    "embeds": torch.from_numpy(embeds)})
    cache = model.init_cache(B, P + G, enc_seq=P)
    write_prefill_cache(cache, pcache)
    return logits, pcache, cache


# ---------------------------------------------------------------------------
# config, parameters, conversion
# ---------------------------------------------------------------------------

def test_config_and_counts_match_the_jax_package():
    for j, t in ((jget(ARCH), get_config(ARCH)),
                 (jget(ARCH).reduced(), get_config(ARCH).reduced())):
        assert (t.encoder.num_layers, t.encoder.d_input) \
            == (j.encoder.num_layers, j.encoder.d_input)
        assert (t.rotary_pct, t.norm, t.act, t.tie_embeddings) \
            == (j.rotary_pct, j.norm, j.act, j.tie_embeddings)
        assert t.param_count() == j.param_count()
    assert get_config(ARCH).param_count() == 70_613_504


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_every_leaf_both_ways(dtype):
    """The reference's tree -> the port's -> the reference's, bit for bit,
    with the reference's leaf names in its order: ``frontend`` and
    ``enc_final_norm`` come along, the stacked ``enc_layers`` and
    ``dec_layers`` become lists of 2, and the port's own init draws the
    same tree."""
    jc = jget(ARCH).reduced(param_dtype=dtype, dtype=dtype)
    tc = get_config(ARCH).reduced(param_dtype=dtype, dtype=dtype)
    jp = _np(jbuild(jc).init(jax.random.PRNGKey(1)))
    tp = lm_params_from_numpy(tc, jp, "cpu")
    assert set(tp) == set(jp) == {"frontend", "embed", "enc_final_norm",
                                  "final_norm", "enc_layers", "dec_layers"}
    assert len(tp["enc_layers"]) == len(tp["dec_layers"]) == 2
    back = lm_params_to_numpy(tc, tp)
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in want] == [n for n, _ in got]
    for (_, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(b, np.asarray(a, np.float32))
    own, carried = (leaves_with_path(t) for t in (
        build_model(tc, "cpu", seed=3).params, tp))
    assert [n for n, _ in own] == [n for n, _ in carried]
    for (n, a), (_, b) in zip(own, carried):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), n
    assert "bq" not in tp["dec_layers"][0]["cross_attn"]


# ---------------------------------------------------------------------------
# encoder, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_encode_matches_jax(jax_impl):
    """The non-causal encoder: the port's two attentions against the
    reference's ``"xla"`` and its Pallas kernel (interpret mode)."""
    api, jp, model = _models()
    _, embeds = _inputs(1)
    want = JED.encode(jp, jnp.asarray(embeds),
                      api.cfg.replace(attention_impl=jax_impl))
    for impl in ("flash", "plain"):
        got = TED.encode(model.params, torch.from_numpy(embeds),
                         model.cfg.replace(attention_impl=impl))
        _close(got, want, 1e-4)


def test_prefill_logits_and_caches_match_jax():
    api, jp, model = _models()
    toks, embeds = _inputs(2)
    want, jcache = jax.jit(api.prefill)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32),
             "embeds": jnp.asarray(embeds)})
    got, pcache = model.prefill({"tokens": torch.from_numpy(toks),
                                 "embeds": torch.from_numpy(embeds)})
    _close(got, want, 1e-4)
    assert len(pcache) == model.cfg.num_layers
    for i, c in enumerate(pcache):
        for n in ("k", "v"):
            _close(c["self"][n], jcache["self"][n][i], 1e-4)
            _close(c["cross"][n], jcache[f"cross_{n}"][i], 1e-4)


def test_four_decode_steps_match_the_unpadded_reference():
    """The port's decode steps against the reference's
    ``encdec_decode_step`` on a cache whose self k/v are padded to the
    capacity and whose cross K/V keep the encoder's length; the port's
    self-attention cache is written in place, its cross K/V untouched."""
    api, jp, model = _models()
    toks, embeds = _inputs(3)
    _, jcache = jax.jit(api.prefill)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32),
             "embeds": jnp.asarray(embeds)})
    jcache = _jax_decode_cache(jcache, P + G)
    _, _, cache = _port_cache(model, toks, embeds)
    cross = [c["cross"]["k"].clone() for c in cache]
    step = jax.jit(api.decode_step)
    nxt = np.random.default_rng(4).integers(0, model.cfg.vocab_size, (B, 4))
    for i in range(4):
        want, jcache = step(jp, jcache, jnp.asarray(nxt[:, i:i + 1]),
                            jnp.int32(P + i))
        got, cache = model.decode_step(
            cache, torch.from_numpy(nxt[:, i:i + 1]), P + i)
        _close(got, want, 1e-4)
    for i, c in enumerate(cache):
        _close(c["self"]["k"], jcache["self"]["k"][i], 1e-4)
        assert c["cross"]["k"].shape[1] == P
        assert torch.equal(c["cross"]["k"], cross[i])


def test_serve_batch_matches_a_reference_loop_on_the_unpadded_cache():
    """The port's ``serve_batch`` against a loop of the reference's own
    prefill and decode steps, from the same seed, weights and draws, with
    the cross K/V at the encoder's length: equal greedy tokens."""
    api, jp, model = _models()
    got = serve_batch(ARCH, True, B, P, G, seed=0, device="cpu",
                      params=model.params)
    toks, embeds = _inputs(0)
    logits, jcache = jax.jit(api.prefill)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32),
             "embeds": jnp.asarray(embeds)})
    jcache = _jax_decode_cache(jcache, P + G)
    step = jax.jit(api.decode_step)
    want = np.zeros((B, G), np.int32)
    nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    for i in range(G):
        want[:, i] = np.asarray(nxt)
        logits, jcache = step(jp, jcache, nxt[:, None], jnp.int32(P + i))
        nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["logits_finite"]
    cfg = model.cfg
    kv = cfg.num_kv_heads * cfg.head_dim * 4
    assert got["kv_cache_bytes"] == 2 * cfg.num_layers * B * kv * (
        (P + G) + P)                    # self k/v at P + G, cross at P
    drawn = serve_inputs(cfg, B, P, 0, "cpu")
    np.testing.assert_array_equal(drawn["tokens"].numpy(), toks)
    np.testing.assert_array_equal(drawn["embeds"].numpy(), embeds)


def test_reference_serve_pads_whisper_cross_keys_with_zeros():
    """A fault of the reference, pinned: its ``pad_cache_to`` pads the
    cross K/V to ``max_seq`` rows (``init_cache`` builds them with
    ``enc_seq=max_seq``), the extra rows zero; its decode attends to them
    unmasked, so its first decode step's logits part from the same step
    on the unpadded cache by more than 1e-2.  The port's step equals the
    unpadded one within 1e-4."""
    api, jp, model = _models()
    toks, embeds = _inputs(0)
    logits, jcache = jax.jit(api.prefill)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32),
             "embeds": jnp.asarray(embeds)})
    padded = pad_cache_to(jcache, api, B, P + G)
    assert padded["cross_k"].shape[2] == P + G
    assert not np.asarray(padded["cross_k"][:, :, P:]).any()
    assert not np.asarray(padded["cross_v"][:, :, P:]).any()
    nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    step = jax.jit(api.decode_step)
    bad, _ = step(jp, padded, nxt, jnp.int32(P))
    good, _ = step(jp, _jax_decode_cache(jcache, P + G), nxt, jnp.int32(P))
    gap = float(np.abs(np.asarray(bad) - np.asarray(good)).max())
    print(f"padded vs unpadded first step: max |diff| {gap}, largest "
          f"logit {float(np.abs(np.asarray(good)).max())}")
    assert gap > 1e-2
    _, _, cache = _port_cache(model, toks, embeds)
    got, _ = model.decode_step(cache, torch.from_numpy(
        np.asarray(nxt, np.int64)), P)
    _close(got, good, 1e-4)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_batch(seed=5, S=16):
    rng = np.random.default_rng(seed)
    cfg = get_config(ARCH).reduced()
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    embeds = rng.normal(size=(B, S, cfg.encoder.d_input)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "embeds": jnp.asarray(embeds)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long(),
             "embeds": torch.from_numpy(embeds)})


@pytest.mark.parametrize("remat", ["none", "full"])
def test_encdec_loss_and_gradient_match_jax(remat):
    api, jp, model = _models()
    jbatch, tbatch = _train_batch()
    jc = api.cfg.replace(remat=remat)
    (jl, jm), jg = jax.value_and_grad(
        lambda p, b: JED.encdec_loss(p, b, jc), has_aux=True)(jp, jbatch)
    cfg = model.cfg.replace(remat=remat, attention_impl="plain")
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      model.params)
    loss, metrics = TED.encdec_loss(params, tbatch, cfg)
    np.testing.assert_allclose(loss.detach().item(), float(jl), rtol=1e-5)
    assert float(metrics["aux"]) == 0.0 == float(jm["aux"])
    grads = torch.autograd.grad(loss, leaves(params))
    g = _by_name(lm_params_to_numpy(cfg, unflatten_like(params, grads)))
    w = _by_name(_np(jg))
    assert g.keys() == w.keys()
    for name in w:
        assert np.abs(w[name]).max() > 0, name
        np.testing.assert_allclose(g[name], w[name],
                                   atol=1e-4 * np.abs(w[name]).max(),
                                   err_msg=name)


def test_three_train_steps_match_the_reference():
    """``make_train_step`` against the reference's (less its mesh), from
    the same parameters, optimizer state and batches; each batch through
    both packages' ``_prep_batch`` (the frames bit for bit)."""
    api, jp, model = _models()
    cfg = model.cfg.replace(attention_impl="plain")
    sched = dict(warmup=10, total=30)
    jcfg = JA.AdamWConfig(lr=3e-4, schedule=JA.cosine_schedule(**sched))
    tcfg = TA.AdamWConfig(lr=3e-4, schedule=TA.cosine_schedule(**sched))
    jstep = jax.jit(JT.make_train_step(api, jcfg, api.cfg))
    tmodel = EncDec(cfg, tree_map(lambda t: t.detach().clone(),
                                  model.params), torch.device("cpu"))
    tmodel.requires_grad_(True)
    tstep = TT.make_train_step(tmodel, tcfg, cfg)
    js = JA.init(jp)
    ts = adamw_state_from_numpy(cfg, _np(js), "cpu")
    tparams = tmodel.params
    dcfg = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    cpu = {k: jax.devices("cpu")[0] for k in ("embeds", "tokens", "labels")}
    for s in range(3):
        b = JP.shard_batch_at(JP.DataConfig(**dcfg), s, 0, 1)
        jb, tb = JT._prep_batch(b, api, cpu), TT._prep_batch(b, tmodel,
                                                             "cpu")
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        jp, js, jm = jstep(jp, js, jb)
        tparams, ts, tm = tstep(tparams, ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        g, w = _by_name(lm_params_to_numpy(cfg, tparams)), _by_name(_np(jp))
        for name in w:
            np.testing.assert_allclose(g[name], w[name], atol=1e-5,
                                       err_msg=name)
        g, w = _by_name(lm_params_to_numpy(cfg, ts.mu)), _by_name(_np(js.mu))
        for name in w:
            np.testing.assert_allclose(g[name], w[name],
                                       atol=1e-4 * np.abs(w[name]).max(),
                                       err_msg=name)


def test_train_loop_runs_whisper_and_reduces_the_loss():
    out = TT.train_loop(ARCH, True, 12, device="cpu", seq_len=32,
                        tc=TT.TrainConfig(log_interval=100))
    losses = np.asarray(out["losses"])
    assert isinstance(out["api"], EncDec) and np.isfinite(losses).all()
    assert losses[-4:].mean() < losses[:4].mean()
