"""The trainer: train step, checkpoint/restart loop.

The port of ``repro/launch/train.py`` on one device: the card unless the
caller passes ``device="cpu"``.  A step is the loss (``LM.loss_fn``), its
gradients by ``torch.autograd`` and ``optim.adamw.update``; the loop draws
its batches from ``data/pipeline.py``, saves step-granular checkpoints
with the data cursor into the ENDURE-tuned ``CheckpointStore`` and writes
a heartbeat a step into its manifest.

What differs from the JAX module:

* The trainer runs the architecture's config with
  ``attention_impl="plain"`` (torch ops: the materialised softmax, the
  chunked WKV), the counterpart of the reference's ``"xla"`` default: the
  hand-written ``flash_attention`` and ``rwkv6`` kernels compute the
  forward pass only, as the JAX package's Pallas kernels do, and refuse a
  gradient.
* ``jit_train_step``'s shardings (parameters, optimizer state and batch
  laid out over a (data, model) mesh) are ported as the dry run's
  (``launch/sharding.py``, ``launch/dryrun.py``), which traces them over
  a fake process group; a trainer that steps on more than one card is
  not: ``mesh_shape`` other than ``(1, 1)`` raises
  ``NotImplementedError`` (ROADMAP.md queue 1 item 7b).
* ``train_loop`` returns, besides the reference's keys, the step it
  started from (``start``), each step's wall seconds up to the loss's
  readback (``step_s``) and metrics (``metrics``).

Resume takes the reference's path: the store ``train_loop`` creates is
new, so its manifest is empty and a resumed run starts from step 0, as the
reference's does (``checkpoint/store.py``).

CLI:  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
          --reduced --steps 20 --device cpu [--ckpt-dir DIR] [--mesh 1x1]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ModelConfig
from ..convert import (adamw_state_to_reference, lm_params_from_reference,
                       lm_params_to_reference)
from ..data.pipeline import DataConfig, DataState, shard_batch_at
from ..kernels._compat import resolve_device
from ..models import build_model
from ..models.model import init_params
from ..optim import adamw
from ..utils.tree import leaves, unflatten_like

_NOT_PORTED = "ROADMAP.md queue 1 item 7b"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 50
    ckpt_interval: int = 20
    lr: float = 3e-4
    warmup: int = 10
    seed: int = 0
    aux_weight: float = 0.01
    grad_compression: str = "none"  # none|int8 (pod-axis mean)
    log_interval: int = 10


def make_train_step(api, opt_cfg: adamw.AdamWConfig, cfg: ModelConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    parameters and moments are updated in place (``adamw.update``).  A
    leaf the loss does not use (a stub-embedding model's ``embed_out``)
    takes a zero gradient, as ``jax.grad`` gives it."""

    def step(params, opt_state, batch):
        loss, metrics = api.loss_fn(params, batch)
        ps = leaves(params)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(ps, grads)]
        grads = unflatten_like(params, grads)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             opt_cfg)
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, loss=loss.detach(), **om)
        return params, opt_state, metrics

    return step


def train_config(arch: str, reduced: bool) -> ModelConfig:
    """The architecture's config as the trainer runs it: reduced when
    asked, with ``attention_impl="plain"``."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return cfg.replace(attention_impl="plain")


def _restore(store, cfg: ModelConfig, dev):
    """Parameters, optimizer state and metadata of the store's latest
    checkpoint, in the port's layout on ``dev``."""
    meta_params = init_params(None, cfg, "meta")
    ref_params, meta = store.restore(lm_params_to_reference(cfg,
                                                            meta_params),
                                     device=dev)
    ref_opt = store.restore_opt_state(
        adamw_state_to_reference(cfg, adamw.init(meta_params)), device=dev)
    opt_state = adamw.AdamWState(
        step=ref_opt.step, mu=lm_params_from_reference(cfg, ref_opt.mu, dev),
        nu=lm_params_from_reference(cfg, ref_opt.nu, dev))
    return lm_params_from_reference(cfg, ref_params, dev), opt_state, meta


def train_loop(arch: str, reduced: bool, steps: int, mesh_shape=(1, 1),
               ckpt_dir: Optional[str] = None, resume: bool = False,
               seq_len: int = 64, global_batch: int = 8,
               tc: TrainConfig = TrainConfig(), worker: int = 0,
               num_workers: int = 1, device=None) -> Dict[str, Any]:
    if tuple(mesh_shape) != (1, 1):
        raise NotImplementedError(
            f"mesh {tuple(mesh_shape)}: the port trains on one device; a "
            f"multi-card trainer is not ported yet ({_NOT_PORTED})")
    dev = resolve_device(device)
    cfg = train_config(arch, reduced)
    print(f"train {cfg.name} on {dev}: attention_impl='plain' (the JAX "
          "package's 'xla'; the kernels have no backward)")
    opt_cfg = adamw.AdamWConfig(
        lr=tc.lr, schedule=adamw.cosine_schedule(tc.warmup, steps))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=tc.seed)

    store = None
    data_state = DataState()
    if ckpt_dir is not None:
        from ..checkpoint.store import CheckpointStore
        store = CheckpointStore.create(ckpt_dir, device=dev,
                                       ckpt_interval=tc.ckpt_interval)
    if resume and store is not None and store.latest_step() is not None:
        params, opt_state, meta = _restore(store, cfg, dev)
        api = build_model(cfg, dev, params=params)
        data_state = DataState.from_dict(meta["data_state"])
        start = int(meta["step"]) + 1
    else:
        api = build_model(cfg, dev, seed=tc.seed)
        opt_state = None
        start = 0
    api.requires_grad_(True)
    params = api.params
    if opt_state is None:
        opt_state = adamw.init(params)
    jstep = make_train_step(api, opt_cfg, cfg)

    losses, step_s, history = [], [], []
    t_start = time.time()
    for s in range(start, steps):
        batch_np = shard_batch_at(dcfg, data_state.step, 0, 1)
        batch = _prep_batch(batch_np, api, dev)
        t0 = time.time()
        params, opt_state, metrics = jstep(params, opt_state, batch)
        loss = float(metrics["loss"])
        step_s.append(time.time() - t0)
        losses.append(loss)
        history.append({k: float(v) for k, v in metrics.items()})
        data_state.step += 1
        if store is not None:
            store.heartbeat(worker, s, time.time())
            if (s + 1) % tc.ckpt_interval == 0 or s == steps - 1:
                store.save(s, lm_params_to_reference(cfg, params),
                           adamw_state_to_reference(cfg, opt_state),
                           data_state=data_state.to_dict())
        if s % tc.log_interval == 0 or s == steps - 1:
            print(f"step {s:5d} loss {loss:8.4f} "
                  f"gnorm {history[-1]['grad_norm']:7.3f} "
                  f"({time.time()-t0:.2f}s)")
    wall = time.time() - t_start
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "wall": wall, "api": api, "store": store, "start": start,
            "step_s": step_s, "metrics": history}


def _prep_batch(batch_np: Dict[str, np.ndarray], api,
                device) -> Dict[str, torch.Tensor]:
    """The reference's ``_prep_batch`` on ``device``: tokens and labels as
    int64 tensors; for the encoder-decoder, float32 frame embeddings
    (B, S, d_input) beside them, for a stub-embedding model (B, S, d)
    embeddings in place of the tokens and, under M-RoPE, equal (t, h, w)
    position triples (3, B, S).  The embeddings are numpy normals from
    ``default_rng(tokens[0, 0] + 17)``, as the reference draws them."""
    cfg = api.cfg

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    if cfg.encoder is None and cfg.embed_inputs:
        return {k: ints(batch_np[k]) for k in ("tokens", "labels")}
    tokens = np.asarray(batch_np["tokens"])
    B, S = tokens.shape
    d_in = cfg.d_model if cfg.encoder is None \
        else cfg.encoder.d_input or cfg.d_model
    rng = np.random.default_rng(int(tokens[0, 0]) + 17)
    out = {"embeds": torch.as_tensor(
        rng.normal(size=(B, S, d_in)).astype(np.float32), device=device),
        "labels": ints(batch_np["labels"])}
    if cfg.encoder is not None:
        out["tokens"] = ints(tokens)
    elif cfg.mrope_sections is not None:
        out["positions"] = ints(np.arange(S))[None, None].expand(3, B, S)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 1x1")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    d, m = (int(x) for x in args.mesh.split("x"))
    out = train_loop(args.arch, args.reduced, args.steps,
                     mesh_shape=(d, m), ckpt_dir=args.ckpt_dir,
                     resume=args.resume, seq_len=args.seq_len,
                     global_batch=args.global_batch, device=args.device)
    print(f"final loss {out['losses'][-1]:.4f}  wall {out['wall']:.1f}s")


if __name__ == "__main__":
    main()
