"""The port's ``CheckpointStore`` against the JAX package's, on the CPU.

The same trees saved by both packages give the same file names and
``.npy`` bytes, the same ``opt_state.npz`` arrays (a zip archive stamps
its members with the time, so the archive's bytes are not compared), the
same manifest entries, ``IOStats`` and ``shape()``, bit for bit: the
manifests deploy the same tuning (the reference's ``EngineConfig`` carried
across, as ``tests/torch_carry.py`` carries tunings), and the engine is
bit-identical.  The port's own tuning is held to the reference's by the
exact robust cost of the storm's result, rel 1e-4 (ROADMAP.md section 3,
fault 3: the float32 tuners part from the reference by rounding; the
filter bits of this flat cost differ by a few percent).

The reference's own store tests (``tests/test_substrate.py:117-142``) and
crash-safety cases (``tests/test_faults.py:455-515``) run on the port, and
the reference's fault is pinned in both packages: a new store on a
directory that holds a checkpoint sees none, so "resume" starts from step
0.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint import store as JS
from repro.configs import get_config as jget
from repro.core import LSMSystem as JSys
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import shard_batch_at as jshard_batch_at
from repro.launch.train import make_train_step as jmake_train_step
from repro.launch.train import train_loop as jtrain_loop
from repro.models import build_model as jbuild
from repro.optim import adamw as JA
from repro_torch import train_lm
from repro_torch.checkpoint import store as TS
from repro_torch.convert import (adamw_state_to_reference,
                                 lm_params_to_reference)
from repro_torch.core import LSMSystem as TSys
from repro_torch.launch import train as TT
from repro_torch.lsm import EngineConfig, LSMTree
from repro_torch.optim import adamw as TA
from repro_torch.utils.u64 import unorder_keys

SYS = dict(N=50_000.0, entry_bits=256 * 8, page_bits=4096 * 8,
           bits_per_entry=16.0, min_buf_bits=256 * 8 * 64, s_rq=2e-5)


@pytest.fixture(scope="module")
def ref_cfg():
    """The reference's default manifest tuning (one JAX storm)."""
    return dataclasses.asdict(JS.tuned_manifest_tree().cfg)


def _port_store(root, cfg_fields) -> TS.CheckpointStore:
    fields = dict(cfg_fields, K=tuple(cfg_fields["K"]))
    root.mkdir(parents=True, exist_ok=True)
    return TS.CheckpointStore(root=root, manifest=LSMTree(
        EngineConfig(**fields), device="cpu"))


def _ref_store(root, cfg_fields) -> JS.CheckpointStore:
    from repro.lsm import EngineConfig as JEngineConfig
    from repro.lsm import LSMTree as JLSMTree
    root.mkdir(parents=True, exist_ok=True)
    return JS.CheckpointStore(root=root, manifest=JLSMTree(
        JEngineConfig(**cfg_fields)))


def _assert_same_manifest(ref, port):
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.shape() == ref.shape()
    assert port.flush_seq == ref.flush_seq
    assert port.buffer == ref.buffer
    assert port.store.codec.objects == ref.store.codec.objects
    for a, b in zip(ref.store.levels, port.store.levels):
        np.testing.assert_array_equal(unorder_keys(b.keys), a.keys)
        np.testing.assert_array_equal(b.vals.cpu().numpy(), a.vals)
        np.testing.assert_array_equal(b.starts, a.starts)


# ---------------------------------------------------------------------------
# the reference's store tests on the port
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_cursor(tmp_path):
    """``tests/test_substrate.py:117`` on the port, through ``create`` (a
    tuned manifest on the CPU); bfloat16 comes back as bfloat16."""
    store = TS.CheckpointStore.create(str(tmp_path), device="cpu")
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
    store.save(5, params, opt_state=None, data_state={"step": 42})
    like = {"a": torch.empty((2, 3), device="meta"),
            "b": {"c": torch.empty((4,), dtype=torch.bfloat16,
                                   device="meta")}}
    restored, meta = store.restore(like)
    assert torch.equal(restored["a"], params["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], params["b"]["c"])
    assert meta["data_state"]["step"] == 42
    assert store.latest_step() == 5
    assert store.manifest.device.type == "cpu"


def test_checkpoint_store_uses_robust_tuning(tmp_path):
    """``tests/test_substrate.py:133`` on the port, and its tuning held to
    the reference's: the same integral tuning and buffer, the exact robust
    cost rel 1e-4."""
    kw = dict(ckpt_interval=50, restore_prob=0.5, rho=1.0)
    store = TS.CheckpointStore.create(str(tmp_path), device="cpu", **kw)
    cfg = store.manifest.cfg
    assert cfg.T >= 2
    assert 0 <= cfg.mfilt_bits_per_entry <= 16.0
    store.save(1, {"w": torch.ones(3)})
    assert store.latest_step() == 1
    w = TS.framework_storage_workload(50, 0.5)
    np.testing.assert_array_equal(w, JS.framework_storage_workload(50, 0.5))
    (t,) = TS.retune_storm(w[None], [1.0], TSys(**SYS), device="cpu")
    (j,) = JS.retune_storm(w[None], [1.0], JSys(**SYS))
    ref = JS.tuned_manifest_tree(**kw).cfg
    assert (cfg.T, cfg.K, cfg.buf_entries) == (ref.T, ref.K,
                                               ref.buf_entries)
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-4)


def _tiny_params():
    return {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": np.ones(4, np.float32)}


def test_checkpoint_interrupted_save_keeps_latest(tmp_path, monkeypatch,
                                                  ref_cfg):
    """``tests/test_faults.py:461`` on the port."""
    store = _port_store(tmp_path, ref_cfg)
    params = _tiny_params()
    store.save(1, params, data_state={"batch": 10})
    assert store.latest_step() == 1

    real = TS.CheckpointStore._write_array
    calls = {"n": 0}

    def dying(path, arr):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk gone (injected)")
        real(path, arr)

    monkeypatch.setattr(TS.CheckpointStore, "_write_array",
                        staticmethod(dying))
    p2 = {k: v + 1 for k, v in params.items()}
    with pytest.raises(OSError, match="injected"):
        store.save(2, p2, data_state={"batch": 20})
    assert store.latest_step() == 1
    restored, meta = store.restore(params)
    assert meta["data_state"] == {"batch": 10}
    for k in params:
        np.testing.assert_array_equal(np.asarray(restored[k]), params[k])
    monkeypatch.setattr(TS.CheckpointStore, "_write_array",
                        staticmethod(real))
    store.save(2, p2, data_state={"batch": 20})
    assert store.latest_step() == 2
    restored, meta = store.restore(params)
    np.testing.assert_array_equal(np.asarray(restored["w"]), p2["w"])


def test_checkpoint_tensor_files_atomic(tmp_path, ref_cfg):
    """``tests/test_faults.py:498`` on the port."""
    store = _port_store(tmp_path, ref_cfg)
    store.save(3, _tiny_params(), opt_state=[np.zeros(4, np.float32)])
    ckdir = tmp_path / "step_00000003"
    files = sorted(os.listdir(ckdir))
    assert len(files) == 3 and not any(f.endswith(".tmp") for f in files)
    for f in files:
        if f.endswith(".npy"):
            np.load(ckdir / f)
    z = np.load(ckdir / "opt_state.npz")
    np.testing.assert_array_equal(z["s0"], np.zeros(4, np.float32))
    opt = store.restore_opt_state([np.empty(4, np.float32)])
    np.testing.assert_array_equal(np.asarray(opt[0]),
                                  np.zeros(4, np.float32))


# ---------------------------------------------------------------------------
# the same tree, both packages
# ---------------------------------------------------------------------------

def _lm_state(arch, seed):
    """A reduced model's parameters and its AdamW state after one update
    (the port's trees)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced(attention_impl="plain")
    params = build_model(cfg, "cpu", seed=seed).params
    _, opt, _ = TA.update(_like_grads(params, seed), TA.init(params),
                          params, TA.AdamWConfig())
    return cfg, params, opt


def _like_grads(params, seed):
    from repro_torch.utils.tree import tree_map
    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda p: torch.randn(p.shape, generator=gen), params)


def test_same_tree_same_files_and_manifest(tmp_path, ref_cfg):
    """Twelve saves of a reduced RWKV-6 model and its AdamW state, with a
    heartbeat before each, through both packages' stores: the manifest
    flushes at every save and compacts; after each save the files, the
    manifest entries, ``IOStats`` and ``shape()`` are the reference's; a
    restore in each package gives the saved tree back."""
    cfg, params, opt = _lm_state("rwkv6-3b", 0)
    ref_tree = lm_params_to_reference(cfg, params)
    ref_opt = adamw_state_to_reference(cfg, opt)
    np_tree = jax.tree.map(lambda t: t.detach().numpy(), ref_tree)
    np_opt = JA.AdamWState(*jax.tree.map(lambda t: t.detach().numpy(),
                                         tuple(ref_opt)))
    port = _port_store(tmp_path / "port", ref_cfg)
    ref = _ref_store(tmp_path / "ref", ref_cfg)
    for i in range(12):
        step = 2 * i + 1
        for s in (ref, port):
            s.heartbeat(0, step, 1000.0 + step)
        ref.save(step, np_tree, np_opt, data_state={"step": step + 1})
        port.save(step, ref_tree, ref_opt, data_state={"step": step + 1})
        _assert_same_manifest(ref.manifest, port.manifest)
        a, b = (s.root / f"step_{step:08d}" for s in (ref, port))
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for f in os.listdir(a):
            if f.endswith(".npy"):
                assert (a / f).read_bytes() == (b / f).read_bytes(), f
        za, zb = np.load(a / "opt_state.npz"), np.load(b / "opt_state.npz")
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype
            np.testing.assert_array_equal(za[k], zb[k])
    assert len(port.manifest.shape()) >= 1
    assert port.manifest.stats.comp_pages_written > 0
    assert port.latest_step() == ref.latest_step() == 23
    assert port.heartbeats(2) == ref.heartbeats(2)
    like = jax.tree.map(lambda t: jax.ShapeDtypeStruct(t.shape, t.dtype),
                        np_tree)
    (jr, jmeta), (tr, tmeta) = ref.restore(like), port.restore(ref_tree)
    assert tmeta == jmeta
    jl = jax.tree_util.tree_flatten_with_path(jr)[0]
    from repro_torch.utils.tree import leaves_with_path
    tl = leaves_with_path(tr)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [n for n, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    tro = port.restore_opt_state(ref_opt)
    jro = ref.restore_opt_state(jax.tree.map(jnp.asarray, np_opt))
    assert int(tro.step) == int(jro.step) == int(opt.step)
    for a, b in zip(jax.tree.leaves(jro), jax.tree.leaves(tuple(tro))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _assert_same_manifest(ref.manifest, port.manifest)


def test_bfloat16_is_widened_on_save_and_cast_back(tmp_path, ref_cfg):
    store = _port_store(tmp_path, ref_cfg)
    w = torch.randn(3, 5, generator=torch.Generator().manual_seed(1))
    tree = {"w": w.to(torch.bfloat16), "u": w[0]}
    opt = TA.init(tree)
    store.save(0, tree, opt)
    z = np.load(tmp_path / "step_00000000" / "opt_state.npz")
    assert [z[f"s{i}"].dtype for i in range(5)] == [np.int32] + \
        [np.float32] * 4
    info = store._mget("tensor/0/['w']")
    assert info["dtype"] == "float32" and info["shape"] == [3, 5]
    back, _ = store.restore(tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"])
    assert torch.equal(back["u"], tree["u"])


# ---------------------------------------------------------------------------
# the trainer's checkpoints, and the reference's fault
# ---------------------------------------------------------------------------

def _recorded_puts(monkeypatch, cls, names):
    real = cls._mput

    def mput(self, name, value):
        names.append(name)
        real(self, name, value)
    monkeypatch.setattr(cls, "_mput", mput)


def _reference_loop_without_mesh(arch, steps, ckpt_dir, tc, seq_len,
                                 global_batch):
    """The reference's ``train_loop`` (``launch/train.py:69-146``) less
    its mesh and shardings, which JAX 0.9.0 refuses (see
    :func:`test_reference_train_loop_fails_under_its_mesh`): the same
    init, pipeline, step, heartbeats and saves."""
    cfg = jget(arch).reduced()
    api = jbuild(cfg)
    opt_cfg = JA.AdamWConfig(lr=tc.lr,
                             schedule=JA.cosine_schedule(tc.warmup, steps))
    dcfg = JDataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                       global_batch=global_batch, seed=tc.seed)
    step = jax.jit(jmake_train_step(api, opt_cfg, cfg))
    store = JS.CheckpointStore.create(ckpt_dir,
                                      ckpt_interval=tc.ckpt_interval)
    params = api.init(jax.random.PRNGKey(tc.seed))
    opt_state = JA.init(params)
    for s in range(steps):
        b = jax.tree.map(jnp.asarray, jshard_batch_at(dcfg, s, 0, 1))
        params, opt_state, _ = step(params, opt_state, b)
        store.heartbeat(0, s, 1000.0 + s)
        if (s + 1) % tc.ckpt_interval == 0 or s == steps - 1:
            store.save(s, params, opt_state, data_state={"step": s + 1})
    return store


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-moe-16b"])
def test_train_loop_puts_the_reference_s_manifest_keys(tmp_path,
                                                       monkeypatch, arch):
    """The port's ``train_loop`` with checkpoints (5 steps, a save every
    2 and at the end) puts the reference loop's manifest keys, in order,
    and its checkpoints hold the reference's file names (deepseek's:
    its ``prelude`` block's leaves and the stacked experts' too)."""
    tc = TT.TrainConfig(ckpt_interval=2, log_interval=100)
    tnames, jnames = [], []
    _recorded_puts(monkeypatch, TS.CheckpointStore, tnames)
    _recorded_puts(monkeypatch, JS.CheckpointStore, jnames)
    out = TT.train_loop(arch, True, 5, ckpt_dir=str(tmp_path / "port"),
                        tc=tc, seq_len=16, device="cpu")
    ref = _reference_loop_without_mesh(arch, 5, str(tmp_path / "ref"), tc,
                                       16, 8)
    assert tnames == jnames and len(tnames) > 5
    port = out["store"]
    assert port.latest_step() == ref.latest_step() == 4
    for s in (1, 3, 4):
        d = f"step_{s:08d}"
        assert sorted(os.listdir(tmp_path / "port" / d)) \
            == sorted(os.listdir(tmp_path / "ref" / d))
    assert port.manifest.stats.as_dict()["queries"] \
        == ref.manifest.stats.as_dict()["queries"]
    # the resume path through the same store: the next steps follow on
    monkeypatch.setattr(TS.CheckpointStore, "create",
                        classmethod(lambda cls, *a, **k: port))
    out2 = TT.train_loop(arch, True, 7, ckpt_dir="unused", resume=True,
                         tc=tc, seq_len=16, device="cpu")
    assert out2["start"] == 5 and len(out2["losses"]) == 2
    assert int(out2["opt_state"].step) == 7


def test_reference_train_loop_fails_under_its_mesh(tmp_path):
    """The reference's own ``train_loop`` cannot take a step on JAX 0.9.0:
    its sharded embedding gather raises ``ShardingTypeError`` (a fault of
    the reference, ROADMAP.md section 3), so its ``examples/train_lm.py``
    stops in phase 1."""
    with pytest.raises(Exception, match="out_sharding"):
        jtrain_loop("qwen3-14b", True, 1, seq_len=16)


def test_a_new_store_sees_no_checkpoint_in_both_packages(tmp_path,
                                                         ref_cfg):
    """The reference's fault, kept: ``create`` builds a new, empty,
    in-memory manifest, so a second store on a directory that holds a
    checkpoint finds none."""
    ref = JS.CheckpointStore.create(str(tmp_path / "ref"))
    ref.save(3, _tiny_params())
    assert ref.latest_step() == 3
    assert JS.CheckpointStore.create(str(tmp_path / "ref")).latest_step() \
        is None
    port = _port_store(tmp_path / "port", ref_cfg)
    port.save(3, _tiny_params())
    assert (tmp_path / "port" / "step_00000003").is_dir()
    again = TS.CheckpointStore.create(str(tmp_path / "port"), device="cpu")
    assert again.latest_step() is None


def test_train_lm_phase_two_starts_at_step_zero(capsys):
    """The port's ``train_lm``: phase 2 "resumes" through a new store, so
    it starts from step 0, as the reference's would."""
    train_lm.main(["--steps", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "phase 2 started at step 0" in out
    assert "manifest LSM engine:" in out and "loss: first-10 avg" in out
