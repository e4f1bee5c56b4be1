"""Multi-pod dry run: trace every (arch x shape x mesh) cell at full size
with no device, and write its per-device costs and H100 roofline.

The port of ``repro/launch/dryrun.py``, which lowers and compiles each cell
for 512 CPU placeholder devices.  Here each cell runs in one process over
a ``fake`` process group of the mesh's world size
(``launch/mesh.py::fake_process_group``: 256 ranks for ``single``, 512 for
``multipod``, D x M for ``DxM``), on a ``"cpu"`` ``DeviceMesh``, this
process being rank 0.  Per cell it:

  1. builds the full-size parameters (and, for train, the AdamW moments),
     the inputs and the decode cache as DTensors whose local shards are
     fake tensors (``FakeTensorMode``: shapes and dtypes, no storage),
     sharded by ``launch/sharding.py``'s rules;
  2. runs the step once: ``train_step`` (the loss, ``torch.autograd.grad``,
     ``optim/adamw.py::update``, under the cell's ``remat``), the prefill,
     or one decode step against a cache of S past positions, with the
     models' sharding hints resolved on the mesh
     (``utils/shard_hints.py``);
  3. counts rank 0's local program (``utils/trace_costs.py``: FLOPs,
     bytes, collective bytes per mesh axis, the peak of live local bytes)
     and turns it into H100 roofline terms (``utils/roofline.py``).

The fake tensors live on a ``"cpu"`` mesh (``MESH_DEVICE``): a fake
process group needs no card, and nothing is executed.  Every cell
traces ``attention_impl="plain"`` (the JAX package's dry run runs its
config default ``"xla"``): the CUDA kernels take no fake tensors.  Plain
tensors a model makes (masks, positions) count as replicated (DTensor's
``implicit_replication``), as a constant is under GSPMD.  A cell whose trace raises (an operator with
no DTensor sharding strategy, say) is recorded as ``error`` with the
exception's text, which names the operator.

Records land in ``experiments/dryrun_torch/`` as
``<arch>__<shape>__<mesh>__<tag>.json`` (never under the JAX package's
``experiments/dryrun``), in the JAX package's schema for every key a
reader uses (``status``, ``reason``, ``error``, ``chips``,
``memory_analysis.total_live_gb``, ``roofline``); the costs sit under
``trace`` where the JAX package has ``hlo``.

CLI:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k --mesh single            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  ... --set remat=none --set logits_chunk=8192  # config overrides
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..configs.base import ModelConfig, ShapeConfig
from ..models import encdec as encdec_mod
from ..models import lm as lm_mod
from ..models.model import input_specs, param_specs
from ..optim import adamw
from ..utils import roofline
from ..utils.shard_hints import mesh_context
from ..utils.trace_costs import CostCounter
from ..utils.tree import leaves, unflatten_like
from .mesh import fake_process_group, make_mesh, make_production_mesh
from .sharding import (NamedSharding, map_with_path, batch_shardings,
                       cache_shardings, param_shardings)

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"
#: the device type of the meshes, and so of the fake local shards: a fake
#: process group needs no device, and "cpu" traces anywhere
MESH_DEVICE = "cpu"
NOTES = ("eager trace of fake DTensors on a fake process group; "
         "attention_impl=plain (the CUDA kernels take no fake tensors); "
         "bytes unfused")


def _apply_overrides(cfg: ModelConfig, overrides: Dict[str, str]
                     ) -> ModelConfig:
    kw: Dict[str, Any] = {}
    for k, v in overrides.items():
        field = {f.name: f for f in dataclasses.fields(cfg)}[k]
        if field.type in ("int", int):
            kw[k] = int(v)
        elif field.type in ("bool", bool):
            kw[k] = v.lower() in ("1", "true", "yes")
        elif field.type in ("float", float):
            kw[k] = float(v)
        else:
            kw[k] = v
    return cfg.replace(**kw)


def mesh_layout(mesh_kind: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """'single' | 'multipod' | 'DxM' -> (shape, axis names)."""
    if mesh_kind == "single":
        return (16, 16), ("data", "model")
    if mesh_kind == "multipod":
        return (2, 16, 16), ("pod", "data", "model")
    d, m = (int(x) for x in mesh_kind.split("x"))
    return (d, m), ("data", "model")


def _make_mesh(mesh_kind: str):
    """The mesh of ``mesh_kind`` on the running (fake) process group."""
    if mesh_kind == "single":
        return make_production_mesh(device_type=MESH_DEVICE)
    if mesh_kind == "multipod":
        return make_production_mesh(multi_pod=True, device_type=MESH_DEVICE)
    return make_mesh(*mesh_layout(mesh_kind), MESH_DEVICE)


def _local_shape(shape, sharding: NamedSharding):
    sizes = tuple(sharding.mesh.shape)
    local = list(shape)
    for i, p in enumerate(sharding.placements()):
        if p.is_shard():
            if local[p.dim] % sizes[i]:
                raise ValueError(f"{tuple(shape)} does not split evenly "
                                 f"under {sharding.spec}")
            local[p.dim] //= sizes[i]
    return tuple(local)


def _fake(meta: torch.Tensor, sharding: NamedSharding, dtype=None):
    """A DTensor of ``meta``'s global shape whose local shard is a fake
    tensor (the caller holds a ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(_local_shape(meta.shape, sharding),
                        dtype=dtype or meta.dtype,
                        device=sharding.mesh.device_type)
    shape = tuple(meta.shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, sharding.mesh, sharding.placements(),
                              run_check=False, shape=shape, stride=stride)


def _distribute(metas, shardings, dtype=None):
    flat = leaves(shardings)
    return unflatten_like(metas, [
        _fake(m, s, dtype) for m, s in zip(leaves(metas), flat)])


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """-> (step, the input DTensors): ``step()`` runs the cell's step
    once.  Call under a ``FakeTensorMode``."""
    pspecs = param_specs(cfg)
    pshard = param_shardings(pspecs, cfg, mesh)
    params = _distribute(pspecs, pshard)
    encdec = cfg.encoder is not None
    mod = encdec_mod if encdec else lm_mod

    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig()
        state = adamw.AdamWState(
            step=torch.zeros((), dtype=torch.int32),
            mu=_distribute(pspecs, pshard, torch.float32),
            nu=_distribute(pspecs, pshard, torch.float32))
        bspecs = input_specs(cfg, shape)
        batch = {k: _fake(v, s) for (k, v), s in zip(
            bspecs.items(), batch_shardings(bspecs, cfg, mesh,
                                            shape).values())}
        for p in leaves(params):
            p.requires_grad_(True)

        def train_step():
            loss_fn = encdec_mod.encdec_loss if encdec else lm_mod.lm_loss
            loss, _ = loss_fn(params, batch, cfg)
            flat = leaves(params)
            # an unused leaf (a stub model's embed_out) gets a zero
            # gradient, as jax.grad gives it
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(flat, torch.autograd.grad(
                         loss, flat, allow_unused=True))]
            return adamw.update(unflatten_like(params, grads), state,
                                params, opt_cfg)

        return train_step, (params, state, batch)

    if shape.kind == "prefill":
        bspecs = input_specs(cfg, shape)
        batch = {k: _fake(v, s) for (k, v), s in zip(
            bspecs.items(), batch_shardings(bspecs, cfg, mesh,
                                            shape).values())}
        prefill = encdec_mod.encdec_prefill if encdec else lm_mod.lm_prefill

        def prefill_step():
            with torch.no_grad():
                return prefill(params, batch, cfg)

        return prefill_step, (params, batch)

    specs = input_specs(cfg, shape)
    cshard = cache_shardings(specs["cache"], cfg, mesh, shape)
    cache = map_with_path(
        lambda path, m: _fake(m, _at(cshard, path)), specs["cache"])
    tok = specs["tokens"]
    tokens = _fake(tok, NamedSharding(mesh, (None,) * tok.dim()))
    pos = shape.seq_len - 1          # the cache's last position
    decode = mod.encdec_decode_step if encdec else mod.lm_decode_step

    def decode_step():
        with torch.no_grad():
            return decode(params, cache, tokens, pos, cfg)

    return decode_step, (params, cache, tokens)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in leaves(tree) if hasattr(t, "to_local"))


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_kind: str
               ) -> Dict[str, Any]:
    """Build and trace one cell over a fake process group; returns the
    record's measured part (raises what the trace raises)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    dims, names = mesh_layout(mesh_kind)
    chips = math.prod(dims)
    with fake_process_group(chips):
        mesh = _make_mesh(mesh_kind)
        t0 = time.time()
        with FakeTensorMode():
            step, inputs = build_cell(cfg, shape, mesh)
            t_build = time.time() - t0
            counter = CostCounter(mesh)
            for t in leaves(inputs):
                counter.track(t.to_local() if hasattr(t, "to_local") else t)
            arg_bytes = counter.live
            with counter, implicit_replication(), mesh_context(mesh):
                step()
        t_trace = time.time() - t0 - t_build
    costs = counter.costs()
    return {"chips": chips, "build_s": t_build, "trace_s": t_trace,
            "costs": costs, "argument_bytes": arg_bytes,
            "bandwidth": roofline.axis_bandwidths(dims, names)}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: Optional[Dict[str, str]] = None,
             tag: str = "baseline", save: bool = True,
             verbose: bool = True, out_dir=None) -> Dict[str, Any]:
    """Trace one cell and return (and, with ``save``, write into
    ``out_dir``, default :data:`OUT_DIR`) its record."""
    cfg = get_config(arch)
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    cfg = cfg.replace(attention_impl="plain")
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "overrides": overrides or {},
    }
    out = pathlib.Path(out_dir) if out_dir is not None else OUT_DIR
    if not ok:
        record["status"] = "skipped"
        record["reason"] = why
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {why}", flush=True)
        if save:
            _save(record, out)
        return record

    try:
        got = trace_cell(cfg, shape, mesh_kind)
    except Exception as e:
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"[:4000]
        record["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {mesh_kind}: "
                  f"{record['error'][:300]}", flush=True)
        if save:
            _save(record, out)
        return record

    costs = got["costs"]
    mem_gb = costs.peak_live_bytes / 1e9
    terms = roofline.terms_from_costs(
        arch, shape, mesh_kind, got["chips"], costs, cfg, got["bandwidth"],
        memory_per_dev_gb=mem_gb, notes=NOTES)
    record.update({
        "status": "ok",
        "chips": got["chips"],
        "build_s": got["build_s"],
        "trace_s": got["trace_s"],
        "memory_analysis": {
            "argument_gb": got["argument_bytes"] / 1e9,
            "total_live_gb": mem_gb,
        },
        "trace": {
            "flops_per_dev": costs.flops,
            "bytes_per_dev": costs.bytes,
            "collective_bytes_by_axis": costs.collective_bytes_by_axis,
            "collective_count": costs.collective_count,
            "while_trips": costs.while_trips,
        },
        "axis_bandwidth": got["bandwidth"],
        "notes": NOTES,
        "roofline": dataclasses.asdict(terms),
    })
    if verbose:
        print(f"[ok] {arch} x {shape_name} x {mesh_kind} "
              f"(build {got['build_s']:.1f}s trace {got['trace_s']:.1f}s) "
              f"mem/dev={mem_gb:.2f}GB", flush=True)
        print(f"     compute {terms.compute_s*1e3:.2f}ms "
              f"memory {terms.memory_s*1e3:.2f}ms "
              f"collective {terms.collective_s*1e3:.2f}ms "
              f"-> {terms.bottleneck}-bound, useful={terms.useful_ratio:.2f}",
              flush=True)
    if save:
        _save(record, out)
    return record


def _save(record: Dict[str, Any], out_dir: pathlib.Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = record.get("tag", "baseline")
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}__{tag}.json"
    (out_dir / name).write_text(json.dumps(record, indent=1, default=float))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    help="single | multipod | both | DxM (e.g. 32x8)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override k=v (e.g. remat=none)")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.set) or None

    meshes = ["single", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = sorted(ARCHS) if args.all or args.arch is None else [args.arch]
    shapes = sorted(SHAPES) if args.all or args.shape is None \
        else [args.shape]

    failures = 0
    for m in meshes:
        for a in archs:
            for s in shapes:
                rec = run_cell(a, s, m, overrides=overrides, tag=args.tag)
                failures += rec["status"] == "error"
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
