"""The port's stub-embedding LM with M-RoPE (``qwen2-vl-72b``: the
``adapter``/``embed_out`` frontend of ``models/lm.py``, M-RoPE in
``models/layers.py::apply_rope``, the stub branches of ``launch/serve.py``
and ``launch/train.py``, ``convert.py``'s new leaves) against the JAX
package's, at reduced size on the CPU.

Inputs come from numpy seeds; the reference's ``init_lm`` parameters cross
over as numpy arrays through ``convert.lm_params_from_numpy``, and the
port's gradients come back through ``lm_params_to_numpy``.  The reduced
``qwen2-vl-72b`` has 2 layers of width 64, 4 query and 2 kv heads of 16,
QKV bias, and M-RoPE sections (2, 3, 3) over the 8 rotary frequencies.
Position triples are **distinct**: a text prefix with t = h = w, then an
image whose t stays at the prefix's end while h and w walk a patch grid;
with equal triples M-RoPE would be plain RoPE and the sections would go
untested.  The JAX side runs its ``"xla"`` attention, the port its
``"flash"`` attention (the kernel's plain version on the CPU).

Tolerances, as ``tests/test_torch_lm.py`` and ``tests/test_torch_train.py``
use them: RoPE 1e-5; logits and caches 1e-4; the loss rel 1e-5;
gradients 1e-4 of each leaf's largest entry; three train steps: losses
rel 1e-5, gradient norms rel 1e-4, parameters 1e-5 absolute and the first
moments 1e-4 of each leaf's largest.  No fault touches this path, so the
served tokens equal the reference's ``serve_batch``'s.
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
from repro.launch.serve import serve_batch as jserve
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.optim import adamw as JA
from repro_torch.configs import get_config
from repro_torch.convert import (adamw_state_from_numpy,
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.launch import train as TT
from repro_torch.launch.serve import serve_batch, write_prefill_cache
from repro_torch.models import LM, build_model
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw as TA
from repro_torch.utils.tree import (leaves, leaves_with_path, tree_map,
                                    unflatten_like)

ARCH = "qwen2-vl-72b"
B, P, G = 2, 16, 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _by_name(tree) -> dict:
    return {name: np.asarray(leaf) for name, leaf in leaves_with_path(tree)}


def _cfgs(**kw):
    return jget(ARCH).reduced(**kw), get_config(ARCH).reduced(**kw)


def triples(B: int, S: int, text: int = 4, grid: int = 4) -> np.ndarray:
    """(3, B, S) M-RoPE positions: ``text`` tokens with t = h = w = index,
    then image patches: t fixed at ``text``, h and w walking a ``grid``-wide
    patch grid from ``text``; each batch row offset by its index."""
    pos = np.zeros((3, B, S), np.int64)
    for b in range(B):
        for i in range(S):
            if i < text:
                pos[:, b, i] = i + b
            else:
                j = i - text
                pos[:, b, i] = (text + b, text + b + j // grid,
                                text + b + j % grid)
    return pos


_MODELS = {}


def _models():
    """The JAX reduced qwen2-vl (seed 0) and its parameters (the QKV
    biases drawn nonzero, so that they are tested), and the port's model
    holding the same numbers."""
    if not _MODELS:
        jc, tc = _cfgs()
        api = jbuild(jc)
        jp = jax.jit(api.init)(jax.random.PRNGKey(0))
        rng = np.random.default_rng(9)
        sub = dict(jp["layers"]["sub0"])
        sub["mixer"] = {k: (jnp.asarray(rng.normal(size=v.shape) * 0.1,
                                        jnp.float32)
                            if k.startswith("b") else v)
                        for k, v in sub["mixer"].items()}
        jp = dict(jp, layers={"sub0": sub})
        tp = lm_params_from_numpy(tc, _np(jp), "cpu")
        _MODELS["m"] = (api, jp, build_model(tc, "cpu", params=tp))
    return _MODELS["m"]


def _embeds(seed, S=P):
    return np.random.default_rng(seed).normal(size=(B, S, 64)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# config, conversion, M-RoPE
# ---------------------------------------------------------------------------

def test_config_and_counts_match_the_jax_package():
    for j, t in ((jget(ARCH), get_config(ARCH)), _cfgs()):
        assert (t.mrope_sections, t.embed_inputs, t.qkv_bias, t.rope_theta) \
            == (j.mrope_sections, j.embed_inputs, j.qkv_bias, j.rope_theta)
        assert t.param_count() == j.param_count()
    assert get_config(ARCH).param_count() == 72_705_376_256


def test_convert_carries_adapter_and_embed_out_both_ways():
    """The carried tree's keys are the reference's (``adapter`` and
    ``embed_out`` in place of ``embed``), every leaf comes back bit for
    bit under the reference's names, and the port's own init draws the
    same tree."""
    api, jp, model = _models()
    tp = model.params
    assert set(tp) == set(jp) - {"prelude"} \
        == {"adapter", "embed_out", "final_norm", "lm_head", "layers"}
    back = lm_params_to_numpy(model.cfg, tp)
    want = jax.tree_util.tree_flatten_with_path(_np(jp))[0]
    got = leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in want] == [n for n, _ in got]
    for (_, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(b, a)
    own = leaves_with_path(build_model(model.cfg, "cpu", seed=1).params)
    assert [(n, tuple(a.shape)) for n, a in own] \
        == [(n, tuple(a.shape)) for n, a in leaves_with_path(tp)]


def test_apply_rope_with_distinct_triples():
    """M-RoPE on distinct (t, h, w) triples against the reference; equal
    triples give plain RoPE of the index; the sections rotate by their own
    streams (moving only w moves only the last 3 frequency pairs)."""
    jc, tc = _cfgs()
    rng = np.random.default_rng(2)
    S = 24
    x = rng.normal(size=(B, S, 4, 16)).astype(np.float32)
    pos = triples(B, S)
    assert len({tuple(pos[:, 0, i]) for i in range(S)}) == S
    assert (pos[0] != pos[1]).any() and (pos[1] != pos[2]).any()
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tc)
    _close(got, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jc), 1e-5)
    idx = np.broadcast_to(np.arange(S), (B, S))
    equal = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(
        np.broadcast_to(idx, (3, B, S)).copy()), tc)
    plain = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(idx.copy()),
                          tc.replace(mrope_sections=None))
    _close(equal, plain, 1e-6)
    moved = pos.copy()
    moved[2] += 5
    other = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(moved), tc)
    pairs = (other - got).abs().amax(dim=(0, 1, 2)).view(8, 2).amax(-1)
    assert (pairs[:5] == 0).all() and (pairs[5:] > 0).all()


# ---------------------------------------------------------------------------
# prefill, decode, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_positions", [True, False])
def test_prefill_matches_jax(with_positions):
    """Prefill logits and k/v from stub embeddings, with distinct position
    triples and without any (the default triples)."""
    api, jp, model = _models()
    e = _embeds(3)
    jb = {"embeds": jnp.asarray(e)}
    tb = {"embeds": torch.from_numpy(e)}
    if with_positions:
        pos = triples(B, P)
        jb["positions"] = jnp.asarray(pos, jnp.int32)
        tb["positions"] = torch.from_numpy(pos)
    want, jcache = jax.jit(api.prefill)(jp, jb)
    got, pcache = model.prefill(tb)
    _close(got, want, 1e-4)
    for i, c in enumerate(pcache):
        for n in ("k", "v"):
            _close(c["mixer"][n], jcache["layers"]["sub0"]["mixer"][n][i],
                   1e-4)


def test_decode_from_embed_out_matches_jax():
    """Three decode steps, each feeding the last token's output embedding
    ``embed_out[token]`` (B, 1, d), against the reference's on its padded
    cache (no fault: an LM's cache pads only the self-attention k/v)."""
    api, jp, model = _models()
    e = _embeds(4)
    want, jcache = jax.jit(api.prefill)(jp, {"embeds": jnp.asarray(e)})
    got, pcache = model.prefill({"embeds": torch.from_numpy(e)})
    jcache = pad_cache_to(jcache, api, B, P + G)
    cache = model.init_cache(B, P + G)
    write_prefill_cache(cache, pcache)
    step = jax.jit(api.decode_step)
    embed_out = model.params["embed_out"]
    for i in range(3):
        tok = np.array(jnp.argmax(want[:, -1], -1))
        want, jcache = step(jp, jcache, jp["embed_out"][tok][:, None],
                            jnp.int32(P + i))
        got, cache = model.decode_step(
            cache, embed_out[torch.from_numpy(tok).long()][:, None], P + i)
        _close(got, want, 1e-4)


def test_serve_batch_matches_the_reference():
    """The reference's ``serve_batch`` and the port's, from the same seed
    and weights: equal greedy tokens."""
    api, jp, model = _models()
    want = jserve(ARCH, True, B, P, G, seed=0)
    got = serve_batch(ARCH, True, B, P, G, seed=0, device="cpu",
                      params=lm_params_from_numpy(
                          model.cfg, _np(api.init(jax.random.PRNGKey(0))),
                          "cpu"))
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["logits_finite"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradient_match_jax(remat):
    """``lm_loss`` from stub embeddings and distinct triples, and its
    gradient; ``embed_out``, which the loss does not use, takes a zero
    gradient in both packages."""
    api, jp, model = _models()
    rng = np.random.default_rng(5)
    e = _embeds(6)
    labels = rng.integers(0, 512, (B, P)).astype(np.int32)
    pos = triples(B, P)
    jb = {"embeds": jnp.asarray(e), "positions": jnp.asarray(pos, jnp.int32),
          "labels": jnp.asarray(labels)}
    tb = {"embeds": torch.from_numpy(e), "positions": torch.from_numpy(pos),
          "labels": torch.from_numpy(labels).long()}
    jc = api.cfg.replace(remat=remat)
    (jl, _), jg = jax.value_and_grad(
        lambda p, b: JLM.lm_loss(p, b, jc), has_aux=True)(jp, jb)
    cfg = model.cfg.replace(remat=remat, attention_impl="plain")
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      model.params)
    loss, _ = TLM.lm_loss(params, tb, cfg)
    np.testing.assert_allclose(loss.detach().item(), float(jl), rtol=1e-5)
    ps = leaves(params)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    g = _by_name(lm_params_to_numpy(cfg, unflatten_like(params, grads)))
    w = _by_name(_np(jg))
    assert g.keys() == w.keys()
    assert not w["['embed_out']"].any() and not g["['embed_out']"].any()
    for name in w:
        np.testing.assert_allclose(g[name], w[name],
                                   atol=1e-4 * np.abs(w[name]).max(),
                                   err_msg=name)


def test_three_train_steps_match_the_reference():
    """``make_train_step`` against the reference's (less its mesh), from
    the same parameters, optimizer state and batches; each batch through
    both packages' ``_prep_batch`` (embeddings and triples bit for
    bit)."""
    api, jp, model = _models()
    cfg = model.cfg.replace(attention_impl="plain")
    sched = dict(warmup=10, total=30)
    jcfg = JA.AdamWConfig(lr=3e-4, schedule=JA.cosine_schedule(**sched))
    tcfg = TA.AdamWConfig(lr=3e-4, schedule=TA.cosine_schedule(**sched))
    jstep = jax.jit(JT.make_train_step(api, jcfg, api.cfg))
    tmodel = LM(cfg, tree_map(lambda t: t.detach().clone(), model.params),
                torch.device("cpu"))
    tmodel.requires_grad_(True)
    tstep = TT.make_train_step(tmodel, tcfg, cfg)
    js = JA.init(jp)
    ts = adamw_state_from_numpy(cfg, _np(js), "cpu")
    tparams = tmodel.params
    dcfg = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    cpu = {k: jax.devices("cpu")[0]
           for k in ("embeds", "positions", "labels")}
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
            np.testing.assert_allclose(
                g[name], w[name], atol=1e-4 * max(np.abs(w[name]).max(),
                                                  1e-30), err_msg=name)
