"""The port's trainer (``repro_torch.data``, ``optim``, ``launch.elastic``,
``launch.train``, ``models/lm.py``'s training branch) against the JAX
package's, at reduced size on the CPU.

Inputs come from numpy seeds; JAX parameters and optimizer state cross
over as numpy arrays through ``repro_torch.convert``
(``lm_params_from_numpy``, ``adamw_state_from_numpy``), and the port's
gradients come back through ``lm_params_to_numpy``, so both packages
compute from the same numbers.  The JAX side runs its default
``attention_impl="xla"`` and the port ``"plain"``, its counterpart: no
Pallas kernel has a backward pass.

Tolerances, and why:

* the data pipeline and the compression payloads: bit for bit (numpy in
  both; ``torch.round`` and ``jnp.round`` both round half to even);
* AdamW: 1e-6 absolute on parameters and moments, rel 1e-6 on the
  gradient norm — the same float32 formula leaf by leaf; the norm's sum
  over leaves runs in another order (observed: one ulp, and 2.4e-7 on
  parameters of magnitude ~3 after 5 steps);
* compression's means and residuals: 1e-6 (float32 rounding of the same
  products);
* ``softmax_xent``: 2e-6 on losses of ~6.5 (a sum over the vocabulary in
  another order), chunked against unchunked 2e-6;
* ``lm_loss``: rel 1e-5 on the loss (observed 1.4e-7); gradients 1e-4
  relative to each leaf's largest entry (observed up to 1e-5 for RWKV-6,
  whose chunked WKV sums pairwise decays over a chunk, 2e-6 for the
  dense models); the three remat modes give the same gradients to 1e-6;
* three train steps: losses rel 1e-5, gradient norms rel 1e-4,
  parameters 1e-5 absolute (each AdamW step moves a weight by at most
  ~lr = 3e-5 here) and the first moments 1e-4 of each leaf's largest
  (they are the gradients' running mean, which agree to that).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from repro.configs import get_config as jget
from repro.data import pipeline as JP
from repro.launch import elastic as JE
from repro.launch.train import make_train_step as jmake_train_step
from repro.models import build_model as jbuild
from repro.models import lm as JLM
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro_torch.configs import get_config
from repro_torch.convert import (adamw_state_from_numpy,
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.data import pipeline as TP
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rwkv6.ops import rwkv6
from repro_torch.launch import elastic as TE
from repro_torch.launch import train as TT
from repro_torch.models import build_model
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TC
from repro_torch.utils.tree import leaves, leaves_with_path, tree_map

ARCHS = ("qwen3-14b", "glm4-9b", "phi3-mini-3.8b", "rwkv6-3b",
         "qwen1.5-110b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _by_name(tree) -> dict:
    return {name: np.asarray(leaf) for name, leaf in leaves_with_path(tree)}


def _close_trees(got, want, atol, rtol=0.0, per_leaf_scale=False):
    g, w = _by_name(got), _by_name(_np(want))
    assert g.keys() == w.keys()
    for name in w:
        tol = atol * (np.abs(w[name]).max() if per_leaf_scale else 1.0)
        np.testing.assert_allclose(g[name], w[name], atol=tol, rtol=rtol,
                                   err_msg=name)


def _batch(vocab, B=2, S=64, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.as_tensor(toks).long(),
             "labels": torch.as_tensor(labels).long()})


@pytest.fixture(scope="module")
def carried():
    """Per arch: the JAX reduced model, its parameters, and the port's
    model holding the same numbers (its parameters taking gradients)."""
    out = {}

    def get(arch):
        if arch not in out:
            jc = jget(arch).reduced()
            tc = get_config(arch).reduced(attention_impl="plain")
            api = jbuild(jc)
            jp = api.init(jax.random.PRNGKey(0))
            model = build_model(tc, "cpu",
                                params=lm_params_from_numpy(tc, _np(jp),
                                                            "cpu"))
            model.requires_grad_(True)
            out[arch] = (api, jp, model)
        return out[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_to_numpy_inverts_from_numpy(arch, carried):
    """The reference's stacked layout back from the port's layer list, bit
    for bit, with the reference's leaf names (``jax.tree_util.keystr``)."""
    _, jp, model = carried(arch)
    back = lm_params_to_numpy(model.cfg, model.params)
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in want] == [n for n, _ in got]
    for (_, a), (_, b) in zip(want, got):
        assert b.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b, np.asarray(a))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_pipeline_batches_are_the_reference_s(shards):
    cfgs = [dict(vocab_size=256, seq_len=32, global_batch=8, seed=s)
            for s in (1234, 7)]
    for kw in cfgs:
        for step in (0, 1, 17, 999, 123_456):
            for shard in range(shards):
                want = JP.shard_batch_at(JP.DataConfig(**kw), step, shard,
                                         shards)
                got = TP.shard_batch_at(TP.DataConfig(**kw), step, shard,
                                        shards)
                assert got.keys() == want.keys()
                for k in want:
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])
    it = TP.iterate(TP.DataConfig(), TP.DataState(step=5))
    np.testing.assert_array_equal(
        next(it)["tokens"],
        JP.global_batch_at(JP.DataConfig(), 5)["tokens"])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _seeded_tree(rng):
    return {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": [rng.normal(size=(300,)).astype(np.float32),
                  rng.normal(size=(3, 2, 4)).astype(np.float32)],
            "c": {"d": rng.normal(size=(1,)).astype(np.float32)}}


@pytest.mark.parametrize("slice_entries", [1 << 25, 64])
def test_adamw_five_steps_match_the_reference(monkeypatch, slice_entries):
    """Clipping (every gradient norm is ~55 against a clip of 1), weight
    decay and the cosine schedule; with 64-entry slices the per-leaf
    update runs in pieces and gives the same numbers."""
    monkeypatch.setattr(TA, "SLICE", slice_entries)
    rng = np.random.default_rng(0)
    tree = _seeded_tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, tree), _t(tree)
    kw = dict(lr=0.05, weight_decay=0.1, grad_clip=1.0)
    jcfg = JA.AdamWConfig(schedule=JA.cosine_schedule(2, 5), **kw)
    tcfg = TA.AdamWConfig(schedule=TA.cosine_schedule(2, 5), **kw)
    js, ts = JA.init(jp), TA.init(tp)
    for _ in range(5):
        g = tree_map(lambda a: (rng.normal(size=a.shape) * 3).astype(
            np.float32), tree)
        jp, js, jm = JA.update(jax.tree.map(jnp.asarray, g), js, jp, jcfg)
        tp, ts, tm = TA.update(_t(g), ts, tp, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
        _close_trees(tp, jp, 1e-6)
        _close_trees(ts.mu, js.mu, 1e-6)
        _close_trees(ts.nu, js.nu, 1e-6)
        assert int(ts.step) == int(js.step)
        assert ts.step.dtype == torch.int32
        assert all(m.dtype == torch.float32 for m in leaves(ts.mu))


def test_adamw_keeps_float32_moments_for_bfloat16_params():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st_ = TA.init(p)
    assert st_.mu["w"].dtype == torch.float32
    p, st_, _ = TA.update({"w": torch.full((4,), 0.5, dtype=torch.bfloat16)},
                          st_, p, TA.AdamWConfig(lr=0.1))
    assert p["w"].dtype == torch.bfloat16 and st_.nu["w"].dtype \
        == torch.float32
    assert float(p["w"][0]) < 1.0


def test_adamw_reduces_quadratic():
    """The reference's own case (``tests/test_substrate.py:49``)."""
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    state = TA.init(params)
    cfg = TA.AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = TA.update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip_bounds_update():
    """The reference's own case (``tests/test_substrate.py:59``)."""
    params = {"w": torch.zeros(4)}
    state = TA.init(params)
    cfg = TA.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    _, _, m = TA.update({"w": torch.full((4,), 1e6)}, state, params, cfg)
    assert float(m["grad_norm"]) > 1e5  # measured pre-clip


def test_adamw_state_carries_across():
    rng = np.random.default_rng(3)
    tree = _seeded_tree(rng)
    js = JA.init(jax.tree.map(jnp.asarray, tree))
    js = JA.AdamWState(step=jnp.asarray(7, jnp.int32),
                       mu=jax.tree.map(lambda a: a + 1.5, js.mu),
                       nu=js.nu)
    ts = adamw_state_from_numpy(None, _np(js), "cpu")
    assert int(ts.step) == 7 and ts.step.dtype == torch.int32
    _close_trees(ts.mu, js.mu, 0.0)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def _grad_trees(rng, n):
    g = [{"x": rng.normal(size=(700,)).astype(np.float32),
          "y": [rng.normal(size=(16, 16)).astype(np.float32)],
          "z": np.float32(rng.normal(size=(3,)) * 1e-3)} for _ in range(n)]
    r = [tree_map(lambda a: (rng.normal(size=a.shape) * 0.01).astype(
        np.float32), gi) for gi in g]
    return g, r


def test_compress_grads_payloads_are_the_reference_s():
    rng = np.random.default_rng(5)
    (g,), (r,) = _grad_trees(rng, 1)
    jq, js, jr = JC.compress_grads(jax.tree.map(jnp.asarray, g),
                                   jax.tree.map(jnp.asarray, r))
    tq, ts, tr = TC.compress_grads(_t(g), _t(r))
    for got, want in ((tq, jq), (ts, js)):
        g_, w_ = _by_name(got), _by_name(_np(want))
        for name in w_:
            assert g_[name].dtype == w_[name].dtype
            np.testing.assert_array_equal(g_[name], w_[name], err_msg=name)
    _close_trees(tr, jr, 1e-6)
    like = _t(g)
    _close_trees(TC.decompress_grads(tq, ts, like),
                 JC.decompress_grads(jq, js, jax.tree.map(jnp.asarray, g)),
                 0.0)


@pytest.mark.parametrize("pods", [1, 2, 3, 4])
def test_compressed_cross_pod_mean_matches_the_reference(pods):
    """The collectives emulated over the pods' trees (every pod sees the
    max of the scales and the sum of the payloads); the int8 payloads
    that cross equal the reference's bit for bit."""
    rng = np.random.default_rng(pods)
    g, r = _grad_trees(rng, pods)

    def run(lib, conv, tmap, stack_max, total):
        scales, sent = [], []
        for i in range(pods):        # phase 1: each pod's local scales
            lib.compressed_cross_pod_mean(
                conv(g[i]), conv(r[i]), psum_fn=lambda t: t,
                pmax_fn=lambda t: scales.append(t) or t, n_pods=pods)
        common = tmap(lambda *xs: stack_max(xs), *scales)
        outs = []
        for i in range(pods):        # phase 2: on the common grid
            outs.append(lib.compressed_cross_pod_mean(
                conv(g[i]), conv(r[i]),
                psum_fn=lambda t: sent.append(t) or t,
                pmax_fn=lambda t: common, n_pods=pods))
        qsum = tmap(lambda *xs: total(xs), *sent)
        means = [lib.compressed_cross_pod_mean(
            conv(g[i]), conv(r[i]), psum_fn=lambda t: qsum,
            pmax_fn=lambda t: common, n_pods=pods)[0] for i in range(pods)]
        return sent, means, [o[1] for o in outs]

    jsent, jmeans, jres = run(
        JC, lambda t: jax.tree.map(jnp.asarray, t), jax.tree.map,
        lambda xs: jnp.max(jnp.stack(xs), 0), lambda xs: sum(xs))
    tsent, tmeans, tres = run(
        TC, _t, tree_map, lambda xs: torch.stack(xs).amax(0),
        lambda xs: sum(xs))
    for got, want in zip(tsent, jsent):
        g_, w_ = _by_name(got), _by_name(_np(want))
        for name in w_:
            np.testing.assert_array_equal(g_[name], w_[name])
    for got, want in zip(tmeans + tres, jmeans + jres):
        _close_trees(got, want, 1e-6)
    true_mean = np.mean([gi["x"] for gi in g], axis=0)
    assert np.abs(tmeans[0]["x"].numpy() - true_mean).max() < 0.1


# ---------------------------------------------------------------------------
# elastic policy
# ---------------------------------------------------------------------------

def test_elastic_policy_decisions():
    """The reference's cases (``tests/test_substrate.py:145-174``)."""
    pol = TE.ElasticPolicy(heartbeat_timeout_s=10, straggler_zscore=3.0)
    now = 1000.0
    hb = {0: {"t": 999.0}, 1: {"t": 998.0}, 2: {"t": 900.0}}
    assert TE.dead_workers(hb, now, 4, pol) == [2, 3]
    times = {0: [1.0] * 8, 1: [1.01] * 8, 2: [1.02] * 8, 3: [9.0] * 8}
    assert TE.stragglers(times, pol) == [3]
    assert TE.remesh(24, 8, pol) == (3, 8)
    assert TE.remesh(7, 8, pol) is None
    plan = TE.reshard_plan(old_shards=8, new_shards=6, global_batch=48)
    assert sorted({o for olds in plan.values() for o in olds}) \
        == list(range(8))
    sup = TE.RunSupervisor(num_workers=8, model_parallel=2,
                           policy=TE.ElasticPolicy(heartbeat_timeout_s=5))
    hb = {w: {"t": 100.0} for w in range(7)}
    decision = sup.decide(hb, 102.0)
    assert decision["action"] == "restart_from_checkpoint"
    assert decision["new_mesh"] == (3, 2)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), workers=st.integers(1, 12),
       mp=st.sampled_from([1, 2, 4]), timeout=st.floats(1.0, 50.0),
       z=st.floats(1.0, 6.0))
def test_elastic_decides_as_the_reference(seed, workers, mp, timeout, z):
    """Random heartbeat tables (some workers silent, some late) and step
    times (some slow): both packages decide alike."""
    rng = np.random.default_rng(seed)
    now = 1000.0
    hb = {w: {"t": float(now - rng.uniform(0, 2 * timeout))}
          for w in range(workers) if rng.random() < 0.8}
    times = {w: list(rng.uniform(1.0, 1.1, 6) * (rng.choice([1, 1, 1, 5])))
             for w in range(workers)}
    decisions = []
    for E in (JE, TE):
        pol = E.ElasticPolicy(heartbeat_timeout_s=timeout,
                              straggler_zscore=z)
        sup = E.RunSupervisor(num_workers=workers, model_parallel=mp,
                              policy=pol)
        for w, ts in times.items():
            for t in ts:
                sup.record_step(w, t)
        decisions.append((sup.decide(hb, now),
                          E.dead_workers(hb, now, workers, pol),
                          E.stragglers(times, pol),
                          E.remesh(workers, mp, pol),
                          E.reshard_plan(4, 2, 8)))
    assert decisions[0] == decisions[1]


# ---------------------------------------------------------------------------
# softmax_xent and lm_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [0, 96, 100, 512, 4096])
def test_softmax_xent_matches_the_reference(chunk):
    """Unchunked, a chunk that divides V (96 does not: 512 = 5 x 96 + 32;
    100 neither), one equal to V and one above it; chunked equals
    unchunked."""
    rng = np.random.default_rng(chunk)
    B, S, d, V = 2, 9, 32, 512
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) / np.sqrt(d)).astype(np.float32)
    lab = rng.integers(0, V, (B, S)).astype(np.int32)
    jc = jget("qwen3-14b").reduced(logits_chunk=chunk)
    tc = get_config("qwen3-14b").reduced(logits_chunk=chunk)
    want = JLM.softmax_xent(jnp.asarray(h), jnp.asarray(w),
                            jnp.asarray(lab), jc)
    ht = torch.from_numpy(h).requires_grad_(True)
    got = TLM.softmax_xent(ht, torch.from_numpy(w), torch.from_numpy(lab),
                           tc)
    np.testing.assert_allclose(got.item(), float(want), atol=2e-6)
    plain = TLM.softmax_xent(ht, torch.from_numpy(w), torch.from_numpy(lab),
                             tc.replace(logits_chunk=0))
    np.testing.assert_allclose(got.item(), plain.item(), atol=2e-6)
    (g,) = torch.autograd.grad(got, ht)
    (gp,) = torch.autograd.grad(plain, ht)
    jg = jax.grad(lambda x: JLM.softmax_xent(x, jnp.asarray(w),
                                             jnp.asarray(lab), jc))(
        jnp.asarray(h))
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), gp.numpy(), atol=1e-6)


def _port_grads(model, batch, cfg):
    params = model.params
    loss, metrics = TLM.lm_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves(params))
    from repro_torch.utils.tree import unflatten_like
    return loss.detach(), metrics, lm_params_to_numpy(
        cfg, unflatten_like(params, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax_value_and_grad(arch, carried):
    api, jp, model = carried(arch)
    jbatch, tbatch = _batch(api.cfg.vocab_size)
    (jl, jm), jg = jax.value_and_grad(api.loss_fn, has_aux=True)(jp, jbatch)
    cfg = model.cfg
    out = {}
    for remat in ("none", "dots", "full"):
        loss, metrics, g = _port_grads(model, tbatch,
                                       cfg.replace(remat=remat))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(metrics["xent"].item(), float(jm["xent"]),
                                   rtol=1e-5)
        assert float(metrics["aux"]) == 0.0 == float(jm["aux"])
        _close_trees(g, jg, 1e-4, per_leaf_scale=True)
        out[remat] = g
    for remat in ("dots", "full"):
        for name, a in _by_name(out[remat]).items():
            np.testing.assert_allclose(a, _by_name(out["none"])[name],
                                       atol=1e-6, err_msg=name)


class _MatmulCounter(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_modes_recompute_what_they_say(carried):
    """The backward pass's matrix products: ``"full"`` recomputes every
    layer's forward products, ``"dots"`` none of its plain ones (it keeps
    their outputs), ``"none"`` nothing."""
    _, _, model = carried("qwen3-14b")
    _, tbatch = _batch(model.cfg.vocab_size)
    counts = {}
    for remat in ("none", "dots", "full"):
        params = model.params
        loss, _ = TLM.lm_loss(params, tbatch, model.cfg.replace(remat=remat))
        with _MatmulCounter() as mode:
            torch.autograd.grad(loss, leaves(params))
        counts[remat] = mode.n
    assert counts["none"] < counts["dots"] < counts["full"], counts


def _grad_by_name(api, params, batch):
    (_, _), g = jax.jit(jax.value_and_grad(api.loss_fn, has_aux=True))(
        params, batch)
    return _by_name(_np(g))


def test_rwkv6_full_depth_gradient_is_the_reference_s():
    """Is ``rwkv6-3b``'s gradient growth at full depth the init's or the
    port's?  The JAX package's reduced-width model at the full 32 layers,
    its parameters carried across: one gradient of ``lm_loss`` in each
    package.  The reference's own gradient norm grows with depth (2 layers
    against 32), so the growth is the init's.  At 32 layers float32
    rounding is amplified through the stack: the reference's float32
    gradient parts from its float64 one by up to ~10% of a leaf's largest
    entry, so the two float32 gradients are held to the reference's
    float64 one, not to each other at the 4-layer tolerance: the port's
    no farther from it than twice the reference's float32 gradient is, in
    the norm, over the whole gradient and in each leaf (the run prints
    what it reads)."""
    jc = jget("rwkv6-3b").reduced(num_layers=32)
    tc = get_config("rwkv6-3b").reduced(num_layers=32,
                                        attention_impl="plain")
    api = jbuild(jc)
    jp = jax.jit(api.init)(jax.random.PRNGKey(0))
    jbatch, tbatch = _batch(jc.vocab_size)
    w32 = _grad_by_name(api, jp, jbatch)
    with jax.enable_x64(True):
        api64 = jbuild(jc.replace(dtype="float64", param_dtype="float64"))
        w64 = _grad_by_name(api64, jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), jp), jbatch)
    shallow = jbuild(jget("rwkv6-3b").reduced())
    w2 = _grad_by_name(shallow, jax.jit(shallow.init)(jax.random.PRNGKey(0)),
                       jbatch)
    params = tree_map(lambda t: t.requires_grad_(True),
                      lm_params_from_numpy(tc, _np(jp), "cpu"))
    loss, _ = TLM.lm_loss(params, tbatch, tc)
    grads = torch.autograd.grad(loss, leaves(params))
    from repro_torch.utils.tree import unflatten_like
    g = _by_name(lm_params_to_numpy(tc, unflatten_like(params, grads)))
    assert g.keys() == w32.keys() == w64.keys()

    def norm(d):
        return np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                           for a in d.values()))

    def dist(a, b):
        return norm({n: a[n].astype(np.float64) - b[n] for n in a})

    assert norm(w32) > 10 * norm(w2) and norm(w64) > 10 * norm(w2)
    gap = dist(w32, w64)            # the reference's own float32 error
    print(f"norms: port {norm(g)}, reference {norm(w32)}, float64 "
          f"{norm(w64)}, 2 layers {norm(w2)}; distances to float64: port "
          f"{dist(g, w64)}, reference {gap}; port to reference "
          f"{dist(g, w32)}")
    assert abs(norm(g) - norm(w64)) <= 2 * gap
    assert dist(g, w64) <= 2 * gap
    ratios = {n: np.abs(g[n] - w64[n]).max() / np.abs(w32[n] - w64[n]).max()
              for n in w32}
    print("largest per-leaf ratios:", sorted(ratios.values())[-3:])
    assert max(ratios.values()) <= 2, ratios


# ---------------------------------------------------------------------------
# train steps and the loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-3b"])
def test_three_train_steps_match_the_reference(arch, carried):
    api, jp, model = carried(arch)
    sched = dict(warmup=10, total=30)
    jcfg = JA.AdamWConfig(lr=3e-4, schedule=JA.cosine_schedule(**sched))
    tcfg = TA.AdamWConfig(lr=3e-4, schedule=TA.cosine_schedule(**sched))
    jstep = jax.jit(jmake_train_step(api, jcfg, api.cfg))
    tparams = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       model.params)
    from repro_torch.models import LM
    tmodel = LM(model.cfg, tparams, torch.device("cpu"))
    tmodel.requires_grad_(True)
    tstep = TT.make_train_step(tmodel, tcfg, model.cfg)
    js = JA.init(jp)
    ts = adamw_state_from_numpy(model.cfg, _np(js), "cpu")
    tparams = tmodel.params
    dcfg = dict(vocab_size=api.cfg.vocab_size, seq_len=32, global_batch=4)
    for s in range(3):
        b = JP.shard_batch_at(JP.DataConfig(**dcfg), s, 0, 1)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        tparams, ts, tm = tstep(tparams, ts, TT._prep_batch(b, tmodel,
                                                            "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
        _close_trees(lm_params_to_numpy(model.cfg, tparams), jp, 1e-5)
        _close_trees(lm_params_to_numpy(model.cfg, ts.mu), js.mu, 1e-4,
                     per_leaf_scale=True)


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-3b"])
def test_train_loop_reduces_the_loss(arch, capsys):
    """The reference example's claim: over 30 steps the mean of the last
    10 losses is below that of the first 10."""
    out = TT.train_loop(arch, True, 30, device="cpu",
                        tc=TT.TrainConfig(log_interval=100))
    losses = np.asarray(out["losses"])
    assert len(losses) == 30 and out["start"] == 0
    assert np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()
    assert "attention_impl='plain'" in capsys.readouterr().out
    assert out["api"].cfg.attention_impl == "plain"
    assert len(out["step_s"]) == 30 and set(out["metrics"][0]) \
        == {"loss", "xent", "aux", "grad_norm", "lr"}


# ---------------------------------------------------------------------------
# the repair and the refusals
# ---------------------------------------------------------------------------

def test_forward_only_kernels_refuse_a_gradient():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
    with pytest.raises(RuntimeError, match="no backward kernel.*'plain'"):
        flash_attention(q.clone().requires_grad_(True), q, q)
    r = torch.from_numpy(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
    u = torch.zeros(2, 16)
    with pytest.raises(RuntimeError, match="JAX package.*'xla'"):
        rwkv6(r, r, r, -torch.ones_like(r), u.requires_grad_(True))
    with torch.no_grad():       # the serving path is unchanged
        flash_attention(q.clone().requires_grad_(True), q, q)
        rwkv6(r, r, r, -torch.ones_like(r), u)


def test_lm_loss_with_the_kernels_refuses_a_gradient(carried):
    _, _, model = carried("rwkv6-3b")
    _, tbatch = _batch(model.cfg.vocab_size, S=32)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        TLM.lm_loss(model.params, tbatch,
                    model.cfg.replace(attention_impl="flash"))


def test_trainer_refusals(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.train_loop("qwen3-14b", True, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.main(["--arch", "qwen3-14b", "--reduced", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="queue 1 item 7b"):
        TT.train_loop("qwen3-14b", True, 1, mesh_shape=(2, 1),
                      device="cpu")
    out = TT.train_loop("whisper-base", True, 1, device="cpu", seq_len=16)
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
