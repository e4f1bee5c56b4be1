"""The port's Mamba mixer and hybrid stack (``repro_torch.models.mamba``,
the ``mamba`` kind of ``models/lm.py``, ``jamba-1.5-large-398b`` and
``convert.py``'s Mamba leaves) against the JAX package's, at reduced size
on the CPU.

Inputs come from numpy seeds; JAX parameters cross over as numpy arrays
through ``repro_torch.convert.lm_params_from_numpy``, and the port's
gradients come back through ``lm_params_to_numpy``, so both packages
compute from the same numbers.  The reduced jamba is one 8-layer period
(6 Mamba layers, 1 attention layer, 4 MoE MLPs) with ``mamba_chunk=8``,
so that a 16- or 32-token sequence carries the state across chunks in
both packages.  The JAX side runs its ``"xla"`` attention, the port its
plain version; the JAX selective scan is plain JAX (no Pallas kernel).

Tolerances, and why (none looser than ``tests/test_torch_moe.py`` uses
for the same quantity):

* ``mamba_full``/``mamba_step`` outputs and caches: 1e-5 absolute on
  values of magnitude ~1 (the port runs the recurrence in time order, JAX
  an associative tree over each chunk: float32 sums in another order;
  observed ~1e-7);
* whole-model logits: rel 1e-5 of the largest logit (observed ~1e-7);
* ``lm_loss``: rel 1e-5 on the loss, the cross entropy and the auxiliary
  loss; gradients 1e-4 relative to each leaf's largest entry (observed
  ~1e-6), their global norm rel 1e-5;
* three train steps: the tolerances of
  ``test_torch_train.py::test_three_train_steps_match_the_reference``;
* the scan's own backward against autograd through the plain loop, in
  float64: 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import pipeline as JP
from repro.launch.serve import pad_cache_to
from repro.launch.train import make_train_step as jmake_train_step
from repro.models import build_model as jbuild
from repro.models import mamba as JMB
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
from repro_torch.models import mamba as TMB
from repro_torch.optim import adamw as TA
from repro_torch.utils.tree import (leaves, leaves_with_path, tree_map,
                                    unflatten_like)

ARCH = "jamba-1.5-large-398b"
PERIOD = dict(num_layers=8, mamba_chunk=8)      # one period, 8-step chunks


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_to_largest(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=rel * np.abs(want).max(), rtol=0)


def _by_name(tree) -> dict:
    return {name: np.asarray(leaf) for name, leaf in leaves_with_path(tree)}


def _cfgs(**kw):
    return jget(ARCH).reduced(**kw), get_config(ARCH).reduced(**kw)


_MODELS = {}


def _models():
    """The JAX reduced jamba (one period, seed 0) and its parameters, and
    the port's model holding the same numbers."""
    if not _MODELS:
        jc, tc = _cfgs(**PERIOD)
        api = jbuild(jc)
        jp = jax.jit(api.init)(jax.random.PRNGKey(0))
        tp = lm_params_from_numpy(tc, _np(jp), "cpu")
        _MODELS["m"] = (api, jp, build_model(tc, "cpu", params=tp))
    return _MODELS["m"]


def _mamba_params(seed=0, **kw):
    jc, tc = _cfgs(**kw)
    jp = JMB.init_mamba(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, {k: _t(v) for k, v in jp.items()}


# ---------------------------------------------------------------------------
# config and counts
# ---------------------------------------------------------------------------

def test_config_fields_and_counts_match_the_jax_package():
    """Every field the two ``ModelConfig``s share (``asdict``, the MoE
    config included), ``d_inner_mamba``, ``param_count`` and
    ``active_param_count``, for the full config and its ``reduced()``."""
    j, t = jget(ARCH), get_config(ARCH)
    names = {f.name for f in dataclasses.fields(t)} \
        & {f.name for f in dataclasses.fields(j)}
    names -= {"attention_impl", "encoder"}     # the port's own; unported

    def fields(c):
        d = {n: getattr(c, n) for n in names}
        d["moe"] = dataclasses.asdict(c.moe)
        return d

    for cj, ct in ((j, t), (j.reduced(), t.reduced()),
                   (j.reduced(**PERIOD), t.reduced(**PERIOD))):
        assert fields(cj) == fields(ct)
        assert ct.d_inner_mamba == cj.d_inner_mamba
        assert ct.param_count() == cj.param_count()
        assert ct.active_param_count() == cj.active_param_count()
    assert (t.param_count(), t.active_param_count()) \
        == (397_480_591_360, 93_074_784_256)
    assert t.d_inner_mamba == 16384 and t.pattern[4] == ("attn", "dense")


def test_init_mamba_draws_the_reference_s_shapes_and_dtypes():
    """Leaf names, shapes and dtypes as JAX's ``init_mamba`` (bfloat16
    weights, float32 ``dt_bias``/``A_log``/``D``), the constant leaves
    equal, and the drawn ones at the reference's scale."""
    jc = jget(ARCH).reduced(param_dtype="bfloat16")
    tc = get_config(ARCH).reduced(param_dtype="bfloat16")
    jp = JMB.init_mamba(jax.random.PRNGKey(0), jc)
    tp = TMB.init_mamba(torch.Generator().manual_seed(0), tc)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).split(".")[1] == str(jp[k].dtype), k
    assert tp["x_proj"].shape == (128, 64 // 16 + 2 * 8)
    for k in ("conv_b", "dt_bias", "D"):
        np.testing.assert_array_equal(tp[k].float().numpy(),
                                      np.asarray(jp[k], np.float32))
    # log(1..ds): XLA's vectorised log and torch's part by one ulp on some
    # rows (JAX's own rows disagree with each other there)
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1.2e-7, atol=0)
    for k in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj"):
        ratio = float(tp[k].float().std()) / float(
            np.asarray(jp[k], np.float32).std())
        assert 0.8 < ratio < 1.25, (k, ratio)


# ---------------------------------------------------------------------------
# the Mamba block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [6, 32])
def test_mamba_full_matches_jax(S):
    """``mamba_full`` within one chunk (S 6 < 8) and across four (S 32,
    the state carried): the output, the conv window and the state; the
    path under autograd gives the chunked one's values (to 1e-6: its h.C
    products run as one batched product, the chunked path's one a
    chunk)."""
    jc, tc, jp, tp = _mamba_params(mamba_chunk=8)
    x = np.random.default_rng(1).normal(size=(2, S, 64)).astype(np.float32)
    want, wcache = JMB.mamba_full(jp, jnp.asarray(x), jc)
    with torch.no_grad():
        got, cache = TMB.mamba_full(tp, _t(x), tc)
    _close(got, want, 1e-5)
    _close(cache["ssm"], wcache["ssm"], 1e-5)
    np.testing.assert_array_equal(cache["conv"].numpy(),
                                  np.asarray(wcache["conv"]))
    assert cache["ssm"].dtype == torch.float32
    tg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    g_out, g_cache = TMB.mamba_full(tg, _t(x), tc)
    torch.testing.assert_close(g_out.detach(), got, atol=1e-6, rtol=1e-6)
    assert torch.equal(g_cache["ssm"].detach(), cache["ssm"])


def test_ragged_sequence_raises_as_the_reference_asserts():
    """S > mamba_chunk and not a multiple of it: the reference asserts,
    the port raises ``ValueError``, on both of its paths."""
    jc, tc, jp, tp = _mamba_params(mamba_chunk=8)
    x = np.random.default_rng(2).normal(size=(1, 12, 64)).astype(np.float32)
    with pytest.raises(AssertionError):
        JMB.mamba_full(jp, jnp.asarray(x), jc)
    with torch.no_grad(), pytest.raises(ValueError, match="chunk 8"):
        TMB.mamba_full(tp, _t(x), tc)
    tg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    with pytest.raises(ValueError, match="chunk 8"):
        TMB.mamba_full(tg, _t(x), tc)
    a = torch.rand((1, 12, 3, 2))
    with pytest.raises(ValueError, match="chunk 8"):
        TMB._ssm_scan_chunked(a, a, 8)


def test_ssm_scan_chunked_matches_jax():
    """The first-order recurrence alone, in one chunk and across 3."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 1.0, (2, 24, 5, 4)).astype(np.float32)
    b = rng.normal(size=(2, 24, 5, 4)).astype(np.float32)
    for chunk in (24, 8):
        want = JMB._ssm_scan_chunked(jnp.asarray(a), jnp.asarray(b), chunk)
        _close(TMB._ssm_scan_chunked(_t(a), _t(b), chunk), want, 1e-5)


def test_scan_backward_is_autograd_s_through_the_plain_loop():
    """The custom backward (the reverse recurrence, saving a and h only)
    against autograd through the same recurrence written as a loop of
    differentiable ops, in float64."""
    g = torch.Generator().manual_seed(4)
    a = torch.rand((2, 9, 3, 4), generator=g, dtype=torch.float64)
    b = torch.randn((2, 9, 3, 4), generator=g, dtype=torch.float64)
    w = torch.randn((2, 9, 3, 4), generator=g, dtype=torch.float64)
    a1, b1 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    got = torch.autograd.grad((TMB._ssm_scan_chunked(a1, b1, 9) * w).sum(),
                              (a1, b1))
    a2, b2 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    h, hs = torch.zeros_like(b[:, 0]), []
    for t in range(9):
        h = a2[:, t] * h + b2[:, t]
        hs.append(h)
    want = torch.autograd.grad((torch.stack(hs, 1) * w).sum(), (a2, b2))
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=1e-10, rtol=1e-10)


def test_prefill_then_mamba_steps_match_jax():
    """A 16-token ``mamba_full`` (two chunks), then 4 ``mamba_step``s on
    its cache, against JAX's: each step's output and the carried cache
    (the port's written in place)."""
    jc, tc, jp, tp = _mamba_params(seed=1, mamba_chunk=8)
    x = np.random.default_rng(5).normal(size=(2, 20, 64)).astype(np.float32)
    _, wcache = JMB.mamba_full(jp, jnp.asarray(x[:, :16]), jc)
    with torch.no_grad():
        _, cache = TMB.mamba_full(tp, _t(x[:, :16]), tc)
        for i in range(16, 20):
            want, wcache = JMB.mamba_step(jp, jnp.asarray(x[:, i:i + 1]),
                                          wcache, jc)
            ssm = cache["ssm"]
            got, cache = TMB.mamba_step(tp, _t(x[:, i:i + 1]), cache, tc)
            assert cache["ssm"] is ssm
            _close(got, want, 1e-5)
            _close(cache["ssm"], wcache["ssm"], 1e-5)
            _close(cache["conv"], wcache["conv"], 1e-6)


# ---------------------------------------------------------------------------
# the hybrid stack
# ---------------------------------------------------------------------------

def test_jamba_prefill_and_decode_match_jax():
    """The reduced jamba (one period): ``lm_prefill`` logits and each
    layer's cache (the Mamba conv and state, the attention layer's k/v),
    then four ``lm_decode_step``s from ``write_prefill_cache`` into the
    port's decode cache, against the JAX cache padded to capacity."""
    api, jp, model = _models()
    rng = np.random.default_rng(8)
    B, P, G = 2, 16, 4
    toks = rng.integers(0, model.cfg.vocab_size, (B, P + G))
    want, jcache = jax.jit(api.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :P], jnp.int32)})
    got, pcache = model.prefill(torch.from_numpy(toks[:, :P]))
    _close_to_largest(got, want, 1e-5)
    kinds = TLM.layer_kinds(model.cfg)
    assert [m for m, _ in kinds] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    for j, (c, (mixer, _)) in enumerate(zip(pcache, kinds)):
        w = jcache["layers"][f"sub{j}"]["mixer"]
        assert sorted(c["mixer"]) == sorted(w)
        for name in w:
            _close(c["mixer"][name], w[name][0], 1e-5)
    jcache = pad_cache_to(jcache, api, B, P + G)
    cache = model.init_cache(B, P + G)
    assert cache[0]["mixer"]["conv"].shape == (B, 3, 128)
    assert cache[0]["mixer"]["ssm"].shape == (B, 128, 8)
    write_prefill_cache(cache, pcache)
    decode = jax.jit(api.decode_step)
    for i in range(G):
        want, jcache = decode(jp, jcache,
                              jnp.asarray(toks[:, P + i:P + i + 1],
                                          jnp.int32), jnp.int32(P + i))
        got, cache = model.decode_step(
            cache, torch.from_numpy(toks[:, P + i:P + i + 1]), P + i)
        _close_to_largest(got, want, 1e-5)


def _batch(vocab, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.as_tensor(toks).long(),
             "labels": torch.as_tensor(labels).long()})


_JAX_GRAD = {}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_jamba_loss_and_gradient_match_jax(remat):
    """``lm_loss`` (its cross entropy and summed MoE aux each) and its
    gradient per leaf against ``jax.grad``: every Mamba leaf goes through
    the scan's custom backward; ``"full"`` recomputes each layer under
    ``torch.utils.checkpoint``."""
    api, jp, model = _models()
    cfg = model.cfg.replace(attention_impl="plain", remat=remat)
    jbatch, tbatch = _batch(cfg.vocab_size)
    if not _JAX_GRAD:
        _JAX_GRAD["g"] = jax.jit(jax.value_and_grad(
            api.loss_fn, has_aux=True))(jp, jbatch)
    (jl, jm), jg = _JAX_GRAD["g"]
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      model.params)
    loss, metrics = TLM.lm_loss(params, tbatch, cfg)
    grads = torch.autograd.grad(loss, leaves(params))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(metrics[k].item(), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    g = _by_name(lm_params_to_numpy(cfg, unflatten_like(params, grads)))
    w = _by_name(_np(jg))
    assert g.keys() == w.keys()
    assert "['layers']['sub0']['mixer']['A_log']" in g
    for name in w:
        assert np.abs(w[name]).max() > 0, name
        np.testing.assert_allclose(g[name], w[name],
                                   atol=1e-4 * np.abs(w[name]).max(),
                                   err_msg=name)
    norm = lambda d: np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                                 for a in d.values()))
    np.testing.assert_allclose(norm(g), norm(w), rtol=1e-5)


def test_jamba_three_train_steps_match_the_reference():
    """``make_train_step`` against the reference's (less its mesh), from
    the same parameters, optimizer state and pipeline batches: the loss,
    the aux, the gradient norm, the parameters and the first moments."""
    api, jp, model = _models()
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
def test_convert_round_trip_is_bit_identical(dtype):
    """port -> reference -> port, bit for bit and leaf for leaf (Mamba's
    ``dt_bias``, ``A_log`` and ``D`` stay float32 in a bfloat16 model);
    the eight ``sub<j>`` stacks unstack into one list in execution order;
    the reference's layout carries the JAX package's names in its order
    and its shapes; an AdamW state carries across the same way."""
    cfg = get_config(ARCH).reduced(param_dtype=dtype, dtype=dtype)
    params = build_model(cfg, "cpu", seed=4).params
    ref = lm_params_to_reference(cfg, params)
    assert sorted(ref["layers"]) == [f"sub{j}" for j in range(8)]
    assert ref["layers"]["sub4"]["mixer"]["wq"].shape[0] == 2
    back = lm_params_from_reference(cfg, ref, "cpu")
    a, b = leaves_with_path(params), leaves_with_path(back)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (n, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), n
    for i, (mixer, _) in enumerate(TLM.layer_kinds(cfg)):
        if mixer == "mamba":
            m = back["layers"][i]["mixer"]
            assert all(m[k].dtype == torch.float32
                       for k in ("dt_bias", "A_log", "D"))
            assert m["in_proj"].dtype == TLM.torch_dtype(dtype)
            assert torch.equal(m["in_proj"],
                               ref["layers"][f"sub{i % 8}"]["mixer"]
                               ["in_proj"][i // 8])
    jc = jget(ARCH).reduced(param_dtype=dtype, dtype=dtype)
    shapes = jax.eval_shape(jbuild(jc).init, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert [n for n, _ in leaves_with_path(ref)] \
        == [jax.tree_util.keystr(p) for p, _ in flat]
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    carried = lm_params_to_reference(cfg, lm_params_from_numpy(cfg, zeros,
                                                               "cpu"))
    for (p, x), (_, y) in zip(flat, leaves_with_path(carried)):
        assert x.shape == tuple(y.shape), jax.tree_util.keystr(p)
        assert str(x.dtype) == str(y.dtype).split(".")[1], \
            jax.tree_util.keystr(p)
    opt = TA.init(params)
    opt_back = adamw_state_from_numpy(
        cfg, _np(adamw_state_to_reference(cfg, opt)), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(leaves(opt.mu),
                                                 leaves(opt_back.mu)))


def test_serve_batch_takes_jamba_by_name():
    """``serve_batch`` by name on the reduced jamba (two periods): tokens
    in the vocabulary, finite logits, and a decode cache of the
    attention layers' k/v and the Mamba layers' conv windows and states,
    which ``write_prefill_cache`` filled from the prefill."""
    cfg = get_config(ARCH).reduced()
    out = serve_batch(ARCH, True, 2, 8, 4, seed=0, device="cpu")
    assert out["tokens"].shape == (2, 4) and out["logits_finite"]
    assert (out["tokens"] < 512).all() and (out["tokens"] >= 0).all()
    n_attn = sum(m == "attn" for m, _ in TLM.layer_kinds(cfg))
    n_mamba = cfg.num_layers - n_attn
    assert (n_attn, n_mamba) == (2, 14)
    kv = n_attn * 2 * 2 * 12 * cfg.num_kv_heads * cfg.head_dim * 4
    mamba = n_mamba * 2 * 128 * (3 + 8) * 4
    assert out["kv_cache_bytes"] == kv + mamba


def test_write_prefill_cache_copies_the_mamba_cache_whole():
    api, jp, model = _models()
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, model.cfg.vocab_size, (2, 8)))
    _, pcache = model.prefill(toks)
    cache = model.init_cache(2, 12)
    write_prefill_cache(cache, pcache)
    for c, pc in zip(cache, pcache):
        if "ssm" in c["mixer"]:
            for name in ("conv", "ssm"):
                assert c["mixer"][name] is not pc["mixer"][name]
                assert torch.equal(c["mixer"][name], pc["mixer"][name])
