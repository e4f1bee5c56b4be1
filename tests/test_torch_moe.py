"""The port's mixture-of-experts family (``repro_torch.models.moe``, the
prelude layers and the auxiliary loss of ``models/lm.py``, the MoE configs
and ``convert.py``'s MoE leaves) against the JAX package's, at reduced
size on the CPU.

Inputs come from numpy seeds; JAX parameters cross over as numpy arrays
through ``repro_torch.convert.lm_params_from_numpy``, and the port's
gradients come back through ``lm_params_to_numpy``, so both packages
compute from the same numbers.  The JAX side runs its ``"xla"`` attention,
the port its plain version (``"plain"``, or ``"flash"``, whose wrapper runs
its plain version for CPU tensors); the JAX MoE layer calls no Pallas
kernel.

Tolerances, and why (none looser than ``tests/test_torch_lm.py`` and
``tests/test_torch_train.py`` use for the same quantity):

* routing: the experts each token picks (``eidx``), which assignments a
  row keeps under its capacity and their slots are equal exactly (seeded
  float32 inputs with no near-tie among the router's probabilities);
* ``apply_moe``'s output: 1e-5 absolute on outputs of magnitude ~1 (the
  combine sums a token's k expert outputs in top-k order, JAX
  scatter-adds them in expert order; observed ~5e-7);
* the auxiliary loss: rel 1e-5 (JAX counts each expert's share by adding
  ``1/(B*S*k)`` once an assignment, the port multiplies a ``bincount`` by
  it; observed 1.2e-7);
* whole-model logits: 1e-4, as for the dense models;
* ``lm_loss``: rel 1e-5 on the loss, the cross entropy and the auxiliary
  loss; gradients 1e-4 relative to each leaf's largest entry, as for the
  dense models, and their global norm rel 1e-5;
* three train steps: the tolerances of
  ``test_torch_train.py::test_three_train_steps_match_the_reference``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch.serve import pad_cache_to
from repro.launch.train import make_train_step as jmake_train_step
from repro.data import pipeline as JP
from repro.models import build_model as jbuild
from repro.models import moe as JM
from repro.optim import adamw as JA
from repro_torch.configs import get_config
from repro_torch.convert import (adamw_state_from_numpy,
                                 adamw_state_to_reference,
                                 lm_params_from_numpy,
                                 lm_params_from_reference,
                                 lm_params_to_numpy, lm_params_to_reference)
from repro_torch.launch import train as TT
from repro_torch.launch.serve import serve_batch, write_prefill_cache
from repro_torch.models import LM, build_model
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TM
from repro_torch.optim import adamw as TA
from repro_torch.utils.tree import (leaves, leaves_with_path, tree_map,
                                    unflatten_like)

MOE_ARCHS = ("deepseek-moe-16b", "mixtral-8x7b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _by_name(tree) -> dict:
    return {name: np.asarray(leaf) for name, leaf in leaves_with_path(tree)}


def _cfgs(arch, **kw):
    return jget(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _with_capacity(cfg, cf):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


_MODELS = {}


def _models(arch, **kw):
    """The JAX reduced model and parameters (seed 0), and the port's model
    holding the same numbers."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jc, tc = _cfgs(arch, **kw)
        api = jbuild(jc)
        jp = jax.jit(api.init)(jax.random.PRNGKey(0))
        tp = lm_params_from_numpy(tc, _np(jp), "cpu")
        _MODELS[key] = (api, jp, build_model(tc, "cpu", params=tp))
    return _MODELS[key]


# ---------------------------------------------------------------------------
# configs and counts
# ---------------------------------------------------------------------------

def test_moe_config_is_the_reference_s():
    from repro.configs import MoEConfig as JMoE
    from repro_torch.configs import MoEConfig
    assert [(f.name, f.default) for f in dataclasses.fields(MoEConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(JMoE)]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_counts_and_fields_match_the_jax_package(arch):
    """Every field the two ``ModelConfig``s share, ``param_count`` and
    ``active_param_count``, for the full config and its ``reduced()``."""
    j, t = jget(arch), get_config(arch)
    names = {f.name for f in dataclasses.fields(t)} \
        & {f.name for f in dataclasses.fields(j)}
    names -= {"attention_impl", "encoder"}     # the port's own; unported

    def fields(c):
        return {n: (dataclasses.asdict(getattr(c, n)) if n == "moe"
                    else getattr(c, n)) for n in names}

    for cj, ct in ((j, t), (j.reduced(), t.reduced())):
        assert fields(cj) == fields(ct)
        assert ct.param_count() == cj.param_count()
        assert ct.active_param_count() == cj.active_param_count()
        assert ct.moe_param_count() == cj.moe_param_count()


def test_full_counts():
    """The sizes the serve and train phases on the card state."""
    ds, mx = get_config("deepseek-moe-16b"), get_config("mixtral-8x7b")
    assert (ds.param_count(), ds.active_param_count()) \
        == (16_375_726_080, 2_828_648_448)
    assert (mx.param_count(), mx.active_param_count()) \
        == (46_702_788_608, 12_879_921_152)
    assert TM.capacity(ds, 2048) == 240 and TM.capacity(ds, 1) == 1
    # the train phase's cut: the prelude and 3 MoE layers
    assert ds.replace(num_layers=4).param_count() == 2_267_037_696


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

def _jax_route(pj, x, cfg):
    """The JAX layer's routing and per-row dispatch (``moe.py:104-120``):
    eidx (B, S, k) and {(row, token, expert): slot} of the kept
    assignments."""
    m = cfg.moe
    B, S, _ = x.shape
    probs = jax.nn.softmax(x @ pj["router"], axis=-1)
    gate, eidx = jax.lax.top_k(probs, m.top_k)
    cap = max(1, int(np.ceil(S * m.top_k / m.num_experts
                             * m.capacity_factor)))
    kept = {}
    for b in range(B):
        _, meta = JM._dispatch_group(x[b], eidx[b], gate[b], m.num_experts,
                                     cap)
        e_sort, pos_c, tok_sort, _, keep = (np.asarray(a) for a in meta)
        for e, p, tok, k in zip(e_sort, pos_c, tok_sort, keep):
            if k:
                kept[(b, int(tok), int(e))] = int(p)
    return np.asarray(eidx), kept


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_jax(arch, cf):
    """One MoE layer of the reduced model (deepseek's with its shared
    expert), with the reduced configs' capacity factor (8.0: nothing drops)
    and with 0.5 (capacity 4 slots for 8 assignments an expert on
    average: a row drops its later tokens)."""
    api, jp, model = _models(arch)
    jc, tc = _with_capacity(api.cfg, cf), _with_capacity(model.cfg, cf)
    layer = len(tc.prelude)
    pj = jax.tree.map(lambda a: a[0], jp["layers"]["sub0"]["mlp"])
    pt = model.params["layers"][layer]["mlp"]
    assert ("shared" in pt) == (arch == "deepseek-moe-16b")
    x = np.random.default_rng(5).normal(size=(2, 16, 64)).astype(np.float32)
    want, jaux = JM.apply_moe(pj, jnp.asarray(x), jc)
    with torch.no_grad():
        got, aux = TM.apply_moe(pt, _t(x), tc)
        _, _, eidx = TM.route(pt, _t(x), tc)
        pos, keep = TM.slots(eidx, tc.moe.num_experts, TM.capacity(tc, 16))
    jeidx, jkept = _jax_route(pj, jnp.asarray(x), jc)
    np.testing.assert_array_equal(eidx.numpy(), jeidx)
    kept = {(b, s, int(eidx[b, s, j])): int(pos[b, s, j])
            for b, s, j in zip(*np.nonzero(keep.numpy()))}
    assert kept == jkept
    n = eidx.numel()
    assert (len(kept) < n) == (cf < 1), (len(kept), n)
    _close(got, want, 1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_dropped_assignments_leave_slot_zero_alone():
    """A capacity of 1 slot: each (row, expert) keeps its first token, and
    every later token's output is the shared expert's alone (the dropped
    rows must not overwrite slot 0)."""
    _, _, model = _models("deepseek-moe-16b")
    cfg = model.cfg.replace(moe=dataclasses.replace(
        model.cfg.moe, top_k=1, capacity_factor=1e-6))
    p = model.params["layers"][1]["mlp"]
    x = _t(np.random.default_rng(9).normal(size=(1, 12, 64)))
    with torch.no_grad():
        out, _ = TM.apply_moe(p, x, cfg)
        probs, gate, eidx = TM.route(p, x, cfg)
        shared = torch.nn.functional.silu(x @ p["shared"]["wi_gate"]) \
            * (x @ p["shared"]["wi_up"]) @ p["shared"]["wo"]
    e = eidx[0, :, 0].tolist()
    first = {ex: e.index(ex) for ex in set(e)}
    assert len(first) < len(e)                    # something drops
    for s, ex in enumerate(e):
        if first[ex] != s:
            torch.testing.assert_close(out[0, s], shared[0, s], rtol=0,
                                       atol=0)
        else:
            h = x[0, s]
            y = (torch.nn.functional.silu(h @ p["wi_gate"][ex])
                 * (h @ p["wi_up"][ex])) @ p["wo"][ex]
            torch.testing.assert_close(out[0, s],
                                       shared[0, s] + gate[0, s, 0] * y,
                                       rtol=1e-6, atol=1e-6)


def test_dispatch_is_deterministic_and_every_expert_takes_a_gradient():
    """Two calls give the same bits; an expert that gets no token still
    has a (zero) gradient, as ``make_train_step`` asks every leaf."""
    _, _, model = _models("mixtral-8x7b")
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                 model.params["layers"][0]["mlp"])
    with torch.no_grad():
        p["router"][:, 3] = -1.0          # x > 0: nothing routes to 3
    x = _t(np.abs(np.random.default_rng(3).normal(size=(2, 8, 64))))
    a, aux = TM.apply_moe(p, x, model.cfg)
    b, _ = TM.apply_moe(p, x, model.cfg)
    assert torch.equal(a, b)
    grads = torch.autograd.grad(a.sum() + aux, leaves(p))
    g = dict(zip([n for n, _ in leaves_with_path(p)], grads))
    assert all(t is not None for t in grads)
    assert float(g["['wi_up']"][3].abs().max()) == 0.0
    assert float(g["['wi_up']"][0].abs().max()) > 0.0


# ---------------------------------------------------------------------------
# the whole model: prefill, decode, loss and gradient
# ---------------------------------------------------------------------------

def test_deepseek_prefill_and_decode_match_jax():
    """The reduced deepseek (its dense prelude layer, 2 MoE layers with a
    shared expert): ``lm_prefill`` logits and every layer's k/v, then four
    ``lm_decode_step``s against the JAX cache padded to capacity."""
    api, jp, model = _models("deepseek-moe-16b")
    rng = np.random.default_rng(8)
    B, P, G = 2, 12, 4
    toks = rng.integers(0, model.cfg.vocab_size, (B, P + G))
    want, jcache = jax.jit(api.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :P], jnp.int32)})
    got, pcache = model.prefill(torch.from_numpy(toks[:, :P]))
    _close(got, want, 1e-4)
    assert len(pcache) == 3
    _close(pcache[0]["mixer"]["k"], jcache["prelude"][0]["mixer"]["k"], 1e-4)
    for i, c in enumerate(pcache[1:]):
        _close(c["mixer"]["v"], jcache["layers"]["sub0"]["mixer"]["v"][i],
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


def _ring(kv, slots):
    """A JAX prefill k/v (B, S, KV, hd) as the ring cache of ``slots``
    slots its decode reads: position p at slot p % slots."""
    kv = np.asarray(kv)
    S = kv.shape[1]
    out = np.zeros(kv.shape[:1] + (slots,) + kv.shape[2:], kv.dtype)
    for p in range(S - slots, S):
        out[:, p % slots] = kv[:, p]
    return jnp.asarray(out)


def test_mixtral_sliding_window_decode_past_the_window_matches_jax():
    """The reduced mixtral with ``window=8``: a 24-token prompt (three
    windows), then 5 decode steps on the ring cache of 8 slots."""
    api, jp, model = _models("mixtral-8x7b", window=8)
    rng = np.random.default_rng(11)
    B, P, G = 2, 24, 5
    toks = rng.integers(0, model.cfg.vocab_size, (B, P + G))
    want, jcache = jax.jit(api.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :P], jnp.int32)})
    got, pcache = model.prefill(torch.from_numpy(toks[:, :P]))
    _close(got, want, 1e-4)
    jcache = jax.tree.map(lambda a: a, jcache)
    sub = jcache["layers"]["sub0"]["mixer"]
    jcache["layers"]["sub0"]["mixer"] = {
        n: jnp.stack([_ring(sub[n][i], 8) for i in range(sub[n].shape[0])])
        for n in ("k", "v")}
    cache = model.init_cache(B, P + G)
    assert cache[0]["mixer"]["k"].shape[1] == 8
    write_prefill_cache(cache, pcache)
    decode = jax.jit(api.decode_step)
    for i in range(G):
        want, jcache = decode(jp, jcache,
                              jnp.asarray(toks[:, P + i:P + i + 1],
                                          jnp.int32), jnp.int32(P + i))
        got, cache = model.decode_step(
            cache, torch.from_numpy(toks[:, P + i:P + i + 1]), P + i)
        _close(got, want, 1e-4)


def _batch(vocab, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.as_tensor(toks).long(),
             "labels": torch.as_tensor(labels).long()})


@pytest.mark.parametrize("remat", ["none", "full"])
def test_deepseek_loss_and_gradient_match_jax(remat):
    """``lm_loss`` (the cross entropy and the summed auxiliary loss each)
    and its gradient: the global norm and every leaf, the prelude's and
    the routers' included.  ``"full"`` runs each layer under
    ``torch.utils.checkpoint``, which must carry the aux too."""
    api, jp, model = _models("deepseek-moe-16b")
    cfg = model.cfg.replace(attention_impl="plain", remat=remat)
    jbatch, tbatch = _batch(cfg.vocab_size)
    (jl, jm), jg = jax.value_and_grad(api.loss_fn, has_aux=True)(jp, jbatch)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      model.params)
    loss, metrics = TLM.lm_loss(params, tbatch, cfg)
    grads = torch.autograd.grad(loss, leaves(params))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(metrics["xent"].item(), float(jm["xent"]),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["aux"].item(), float(jm["aux"]),
                               rtol=1e-5)
    assert float(jm["aux"]) > 1.0           # two MoE layers, each ~1
    g = _by_name(lm_params_to_numpy(cfg, unflatten_like(params, grads)))
    w = _by_name(_np(jg))
    assert g.keys() == w.keys()
    assert "['prelude'][0]['mlp']['wi_gate']" in g
    assert "['layers']['sub0']['mlp']['router']" in g
    for name in w:
        np.testing.assert_allclose(g[name], w[name],
                                   atol=1e-4 * np.abs(w[name]).max(),
                                   err_msg=name)
    norm = lambda d: np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                                 for a in d.values()))
    np.testing.assert_allclose(norm(g), norm(w), rtol=1e-5)


def test_deepseek_three_train_steps_match_the_reference():
    """``make_train_step`` against the reference's (less its mesh), from
    the same parameters, optimizer state and pipeline batches: the loss,
    the aux, the gradient norm, the parameters and the first moments."""
    api, jp, model = _models("deepseek-moe-16b")
    cfg = model.cfg.replace(attention_impl="plain")
    sched = dict(warmup=10, total=30)
    jcfg = JA.AdamWConfig(lr=3e-4, schedule=JA.cosine_schedule(**sched))
    tcfg = TA.AdamWConfig(lr=3e-4, schedule=TA.cosine_schedule(**sched))
    jstep = jax.jit(jmake_train_step(api, jcfg, api.cfg))
    tmodel = LM(cfg, tree_map(lambda t: t.detach().clone(), model.params),
                torch.device("cpu"))
    tmodel.requires_grad_(True)
    tstep = TT.make_train_step(tmodel, tcfg, cfg)
    js = JA.init(jp)
    ts = adamw_state_from_numpy(cfg, _np(js), "cpu")
    tparams = tmodel.params
    dcfg = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    for s in range(3):
        b = JP.shard_batch_at(JP.DataConfig(**dcfg), s, 0, 1)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        tparams, ts, tm = tstep(tparams, ts, TT._prep_batch(b, tmodel,
                                                            "cpu"))
        for k in ("loss", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        g, w = _by_name(lm_params_to_numpy(cfg, tparams)), _by_name(_np(jp))
        for name in w:
            np.testing.assert_allclose(g[name], w[name], atol=1e-5,
                                       err_msg=name)
        g = _by_name(lm_params_to_numpy(cfg, ts.mu))
        w = _by_name(_np(js.mu))
        for name in w:
            np.testing.assert_allclose(g[name], w[name],
                                       atol=1e-4 * np.abs(w[name]).max(),
                                       err_msg=name)


# ---------------------------------------------------------------------------
# conversion and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_convert_round_trip_is_bit_identical(arch, dtype):
    """port -> reference -> port, bit for bit and leaf for leaf (the
    router stays float32 in a bfloat16 model), and the reference's layout
    carries the JAX package's ``keystr`` names in its order; an AdamW
    state carries across the same way."""
    cfg = get_config(arch).reduced(param_dtype=dtype, dtype=dtype)
    params = build_model(cfg, "cpu", seed=4).params
    ref = lm_params_to_reference(cfg, params)
    back = lm_params_from_reference(cfg, ref, "cpu")
    a, b = leaves_with_path(params), leaves_with_path(back)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (n, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), n
    layer = params["layers"][len(cfg.prelude)]["mlp"]
    assert layer["router"].dtype == torch.float32
    assert layer["wi_gate"].shape == (4, 64, 32)
    jc = jget(arch).reduced(param_dtype=dtype, dtype=dtype)
    jp = jax.jit(jbuild(jc).init)(jax.random.PRNGKey(0))
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [n for n, _ in leaves_with_path(ref)] == want
    for (p, x), (_, y) in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                              leaves_with_path(lm_params_to_reference(
                                  cfg, lm_params_from_numpy(cfg, _np(jp),
                                                            "cpu")))):
        assert x.shape == tuple(y.shape), jax.tree_util.keystr(p)
    opt = TA.init(params)
    opt_back = adamw_state_from_numpy(
        cfg, _np(adamw_state_to_reference(cfg, opt)), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(leaves(opt.mu),
                                                 leaves(opt_back.mu)))


def test_serve_batch_takes_the_moe_archs():
    """``serve_batch`` by name: the reduced deepseek and mixtral give
    tokens in the vocabulary and finite logits, and the decode cache
    holds every attention layer's k/v, the prelude's included."""
    for arch, layers in (("deepseek-moe-16b", 3), ("mixtral-8x7b", 2)):
        kv = get_config(arch).reduced().num_kv_heads
        out = serve_batch(arch, True, 2, 8, 4, seed=0, device="cpu")
        assert out["tokens"].shape == (2, 4) and out["logits_finite"]
        assert (out["tokens"] < 512).all() and (out["tokens"] >= 0).all()
        assert out["kv_cache_bytes"] == layers * 2 * 2 * 12 * kv * 16 * 4
