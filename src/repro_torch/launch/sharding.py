"""Sharding rules: the port of ``repro/launch/sharding.py``.

Parameter, optimizer, batch and cache specs for any arch, rule for rule
the JAX package's (MaxText-style 2-D "fsdp + tensor" sharding):

* batch dims  -> ("pod", "data")        (pod is extra data parallelism)
* TP dims     -> "model" (heads, d_ff, experts, mamba inner, vocab)
* FSDP dims   -> "data" (the non-TP axis of every large weight)

Optimizer state inherits the parameter specs (ZeRO-1 by construction).
Expert counts shard on "model" only when they divide it (EP); otherwise
experts stay replicated and their FFN widths go tensor-parallel.  Every
axis that does not divide its dimension is dropped (the guard at the end
of :func:`param_spec`), so every spec is an even split.

A spec is a tuple with one entry per tensor dimension: ``None``, one mesh
axis name, or a tuple of names (what ``jax.sharding.PartitionSpec``
holds).  :func:`placements` turns it into DTensor placements on a
``DeviceMesh`` (``launch/mesh.py``): ``Shard(d)`` on every mesh dimension
that tensor dimension ``d`` names, ``Replicate()`` on the rest.

:func:`param_spec` takes the JAX package's parameter paths and shapes,
whose layers are stacked along a leading axis under ``layers`` (or
``enc_layers``/``dec_layers``) and so get a leading ``None``.  The port
keeps one dict a layer in a list (``models/lm.py``); :func:`param_shardings`
maps each of its leaves to the JAX package's path (``convert.py``'s
layout) and drops that leading entry.  The caches likewise
(:func:`cache_shardings`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

from ..configs.base import ModelConfig, ShapeConfig
from .mesh import axis_size, data_axes

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: Spec

    def placements(self):
        return placements(self.spec, self.mesh)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension,
    ``Shard(d)`` when tensor dimension ``d`` names it (``("pod", "data")``
    names two), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dim = None
        for d, ax in enumerate(spec):
            axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
            if name in axes:
                dim = d
        out.append(Shard(dim) if dim is not None else Replicate())
    return tuple(out)


def _div(n: int, mesh, axis: str) -> bool:
    return n % axis_size(mesh, axis) == 0


def param_spec(path: Tuple[Any, ...], shape: Tuple[int, ...],
               cfg: ModelConfig, mesh) -> Spec:
    """The spec of one parameter leaf, by its path in the JAX package's
    tree (stacked layers carry a leading repeat axis)."""
    names = [str(p) for p in path]
    name = names[-1]
    stacked = "layers" in names or name in ("enc_layers", "dec_layers") or \
        ("enc_layers" in names or "dec_layers" in names)
    fsdp = "data" if cfg.fsdp_params else None
    model = "model"
    in_moe = any(n in ("wi_gate", "wi_up", "wo") for n in names[-1:]) and \
        any(n == "mlp" or n == "shared" for n in names) and cfg.moe is not None

    def v_axis(V: int) -> Optional[str]:
        return model if (cfg.shard_vocab and _div(V, mesh, model)) else None

    base: Optional[Tuple] = None
    dims = len(shape) - (1 if stacked else 0)
    core = shape[1:] if stacked else shape

    if name in ("embed", "embed_out"):
        base = (v_axis(core[0]), fsdp)
    elif name == "lm_head":
        base = (fsdp, v_axis(core[1]))
    elif name in ("adapter", "frontend"):
        base = (None, model)
    elif name in ("scale", "bias", "w_base", "dt_bias", "D", "conv_b",
                  "ln_out") or name.startswith("mu_"):
        base = (model,) if (dims == 1 and _div(core[0], mesh, model)
                            and core[0] >= 256) else (None,) * dims
    elif name == "wq":
        # shard heads when divisible, else head_dim (always /16 across archs)
        h_ok = _div(core[1], mesh, model)
        base = (fsdp, model, None) if h_ok else (fsdp, None, model)
    elif name in ("wk", "wv") and dims == 3:
        h_ok = _div(core[1], mesh, model)
        base = (fsdp, model, None) if h_ok else (fsdp, None, model)
    elif name == "wo" and dims == 3 and not in_moe:
        h_ok = _div(core[0], mesh, model)
        base = (model, None, fsdp) if h_ok else (None, model, fsdp)
    elif name in ("bq", "bk", "bv"):
        h_ok = _div(core[0], mesh, model)
        base = (model, None) if h_ok else (None, model)
    elif name in ("q_norm", "k_norm"):
        base = (None,)
    elif name == "u":
        base = (model, None)
    elif name == "router":
        base = (None, None)
    elif name in ("wi_gate", "wi_up") and dims == 3:  # moe experts (E, d, ef)
        ep = _div(core[0], mesh, model)
        base = (model, fsdp, None) if ep else (None, fsdp, model)
    elif name == "wo" and dims == 3:                  # moe (E, ef, d)
        ep = _div(core[0], mesh, model)
        base = (model, None, fsdp) if ep else (None, model, fsdp)
    elif name in ("wi_gate", "wi_up", "wi", "wk") and dims == 2:
        base = (fsdp, model)
    elif name in ("wo", "wv") and dims == 2:
        base = (model, fsdp)
    elif name in ("wr", "wg") and dims == 2:          # rwkv square proj
        base = (fsdp, model)
    elif name == "w_A":
        base = (fsdp, None)
    elif name == "w_B":
        base = (None, model)
    elif name == "in_proj":
        base = (fsdp, model)
    elif name == "conv_w":
        base = (None, model)
    elif name == "x_proj":
        base = (model, None)
    elif name == "dt_proj":
        base = (None, model)
    elif name == "A_log":
        base = (model, None)
    elif name == "out_proj":
        base = (model, fsdp)
    if base is None:
        base = (None,) * dims

    # Guard: every split must be even — drop any axis the mesh cannot
    # divide evenly.
    checked = []
    for ax, n in zip(base, core):
        checked.append(ax if (ax is not None and _div(n, mesh, ax))
                       else None)
    base = tuple(checked)
    return ((None,) + base) if stacked else base


def leaf_paths(tree, path=()):
    """(path, leaf) of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, path + (i,))
    else:
        yield path, tree


def map_with_path(fn, tree, path=()):
    """The tree with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def reference_param_path(path: Tuple[Any, ...], cfg: ModelConfig
                         ) -> Tuple[Tuple[Any, ...], bool]:
    """(the JAX package's path, stacked?) of a leaf of the port's tree:
    an LM's layer i is prelude block i or row r of ``layers/sub<j>``; an
    encoder-decoder's ``enc_layers``/``dec_layers`` are stacked."""
    head = path[0] if path else None
    if cfg.encoder is not None and head in ("enc_layers", "dec_layers"):
        return (head,) + tuple(path[2:]), True
    if cfg.encoder is None and head == "layers":
        i, n_pre = path[1], len(cfg.prelude)
        if i < n_pre:
            return ("prelude", i) + tuple(path[2:]), False
        j = (i - n_pre) % len(cfg.pattern)
        return ("layers", f"sub{j}") + tuple(path[2:]), True
    return tuple(path), False


def param_shardings(params: Any, cfg: ModelConfig, mesh):
    """A :class:`NamedSharding` for every leaf of the port's parameter (or
    optimizer-moment) tree: the JAX package's spec of the same leaf, less
    the leading entry of a stacked layer."""
    def one(path, leaf):
        ref, stacked = reference_param_path(path, cfg)
        shape = tuple(leaf.shape)
        spec = param_spec(ref, ((1,) + shape) if stacked else shape, cfg,
                          mesh)
        return NamedSharding(mesh, spec[1:] if stacked else spec)
    return map_with_path(one, params)


# ---------------------------------------------------------------------------
# Activation / batch / cache shardings
# ---------------------------------------------------------------------------

def _n_dp(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in data_axes(mesh))


def _axes(dp: Tuple[str, ...]):
    """A tuple of axes as one spec entry: None, a name, or the tuple."""
    if not dp:
        return None
    return dp[0] if len(dp) == 1 else dp


def batch_spec(key: str, ndim: int, mesh, shape: ShapeConfig) -> Spec:
    """The spec of one train/prefill batch entry (``batch_shardings``):
    batch over (pod, data), or, when the batch does not divide them
    (batch 1 long context), the sequence over ``data``."""
    dp = data_axes(mesh)
    seq_ax = None
    if shape.global_batch % _n_dp(mesh) != 0:
        dp, seq_ax = (), "data"
    lead = _axes(dp)
    if key == "positions":          # (3, B, S)
        return (None, lead, seq_ax)
    if ndim == 2:                   # tokens/labels (B, S)
        return (lead, seq_ax)
    if ndim == 3:                   # embeds (B, S, d)
        return (lead, seq_ax, None)
    return (None,) * ndim


def batch_shardings(batch: Dict[str, Any], cfg: ModelConfig, mesh,
                    shape: ShapeConfig) -> Dict[str, NamedSharding]:
    """Input shardings for a train/prefill batch dict."""
    return {k: NamedSharding(mesh, batch_spec(k, v.dim(), mesh, shape))
            for k, v in batch.items() if k != "cache"}


def cache_spec(path: Tuple[Any, ...], leaf_shape: Tuple[int, ...], mesh,
               shape: ShapeConfig) -> Spec:
    """The spec of one decode-cache leaf, by its path in the JAX package's
    cache tree (stacked under ``layers``, ``self`` or ``cross_*``).

    Regular decode: batch over (pod, data), kv-heads over model (head_dim
    when they do not divide).  Batch-1 long-context decode:
    sequence-parallel, the cache's S axis over "data"."""
    dp = data_axes(mesh)
    n_dp = _n_dp(mesh)
    sp = shape.global_batch % n_dp != 0  # can't shard batch -> shard seq
    names = [str(p) for p in path]
    name = names[-1]
    nd = len(leaf_shape)
    stacked = "layers" in names or "self" in names or \
        name.startswith("cross")
    lead = (None,) if stacked else ()
    core = leaf_shape[1:] if stacked else leaf_shape

    def ax_div(dim_idx: int, ax: str):
        return ax if _div(core[dim_idx], mesh, ax) else None

    if name in ("k", "v") or name.startswith("cross"):
        # (B, S, KV, hd): kv-heads over model when divisible, else hd
        kv_ax = ax_div(2, "model")
        hd_ax = None if kv_ax else ax_div(3, "model")
        if sp:  # batch=1 long context: sequence-parallel cache
            return (*lead, None, ax_div(1, "data"), kv_ax, hd_ax)
        b_ax = _axes(dp) if core[0] % n_dp == 0 else None
        return (*lead, b_ax, None, kv_ax, hd_ax)
    b = None if sp else (_axes(dp) if core[0] % n_dp == 0 else None)
    if name == "state":      # rwkv (B, H, n, n)
        h_ax = ax_div(1, "model")
        n_ax = None if h_ax else ax_div(2, "model")
        return (*lead, b, h_ax, n_ax, None)
    if name == "ssm":        # mamba (B, di, ds)
        return (*lead, b, ax_div(1, "model"), None)
    if name == "conv":       # mamba (B, dc-1, di)
        return (*lead, b, None, ax_div(2, "model"))
    if name == "x_prev":
        return (*lead, b, *([None] * (len(core) - 1)))
    return (None,) * nd


def reference_cache_path(path: Tuple[Any, ...], cfg: ModelConfig
                         ) -> Tuple[Tuple[Any, ...], bool]:
    """(the JAX package's path, stacked?) of a leaf of the port's cache
    list: an LM's layer i under ``prelude`` or ``layers/sub<j>``; an
    encoder-decoder's ``self/k`` and ``cross/k`` as ``self/k`` and
    ``cross_k``."""
    i, rest = path[0], tuple(path[1:])
    if cfg.encoder is not None:
        if rest[0] == "cross":
            return (f"cross_{rest[1]}",), True
        return rest, True
    n_pre = len(cfg.prelude)
    if i < n_pre:
        return ("prelude", i) + rest, False
    j = (i - n_pre) % len(cfg.pattern)
    return ("layers", f"sub{j}") + rest, True


def cache_shardings(cache: Any, cfg: ModelConfig, mesh,
                    shape: ShapeConfig):
    """A :class:`NamedSharding` for every leaf of the port's decode cache
    (one entry a layer): the JAX package's spec of the same leaf, less
    the leading entry of a stacked one."""
    def one(path, leaf):
        ref, stacked = reference_cache_path(path, cfg)
        s = tuple(leaf.shape)
        spec = cache_spec(ref, ((1,) + s) if stacked else s, mesh, shape)
        return NamedSharding(mesh, spec[1:] if stacked else spec)
    return map_with_path(one, cache)
