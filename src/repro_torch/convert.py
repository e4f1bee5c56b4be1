"""Carry state from the JAX package's objects into the port's.

Both functions take plain numpy arrays and Python values, so this module
imports nothing of the JAX package; a caller extracts the arrays from a
``repro.lsm.LSMTree`` or a ``repro.core.Phi`` (``np.asarray`` on each
field) and passes them in.

* :func:`phi_from_numpy` — a tuning ``(T, mfilt_bits, K)`` as a port
  :class:`~repro_torch.core.lsm_cost.Phi`.
* :func:`tree_from_numpy` — a whole engine: config, every level's arenas
  and run metadata, the value codec's intern table, the write buffer, the
  I/O counters and the flush clock.  Keys become the ordered int64 form
  of the device arenas; Bloom words, where given, are carried bit for bit.
* :func:`lm_params_from_numpy` — an LM's parameters (dense, MoE, RWKV-6,
  the Mamba hybrid, stub-embedding, or the encoder-decoder) from the JAX
  package's ``init_lm`` or ``init_encdec`` tree (``np.asarray`` on each
  leaf): every top-level entry but the layer stacks comes as it is
  (``embed`` or the stub frontend's ``adapter`` and ``embed_out``,
  ``final_norm``, ``lm_head``; the encoder-decoder's ``frontend`` and
  ``enc_final_norm``), the encoder-decoder's stacked ``enc_layers`` and
  ``dec_layers`` become lists of per-layer dicts, and an LM's
  ``prelude`` list and its stacked
  layers become the port's one list of per-layer dicts, prelude first,
  then the pattern's ``sub<j>`` stacks interleaved in execution order
  (Jamba's eight; an expert weight stacked as ``(n_rep, E, d, ef)``
  becomes ``(E, d, ef)`` in each layer); every leaf keeps its dtype
  (RWKV's float32 ``w_base`` and ``u``, Mamba's float32 ``dt_bias``,
  ``A_log`` and ``D`` and the MoE router's float32 in a bfloat16 model
  stay float32) and every sub-dict (``mixer``, ``mlp``, ``mlp/shared``)
  comes along.  :func:`lm_params_from_reference` does the same from the
  reference's layout in torch tensors.
* :func:`lm_params_to_reference` and :func:`lm_params_to_numpy` — the
  way back: the port's per-layer list split into the reference's
  ``prelude`` list and stacked ``{"layers": {"sub<j>": ...}}`` tree (the
  encoder-decoder's lists stacked back), as tensors or as numpy arrays
  (bfloat16 widened to float32, as the reference's checkpoints store it).
* :func:`adamw_state_from_numpy` / :func:`adamw_state_to_reference` — an
  ``AdamWState`` (step, ``mu``, ``nu``) carried across the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.lsm_cost import Phi
from .kernels._compat import resolve_device
from .lsm.engine import EngineConfig, IOStats, LSMTree
from .lsm.store import LevelStore, RunData
from .optim.adamw import AdamWState
from .utils.tree import tree_map
from .utils.u64 import to_device_keys


def phi_from_numpy(T, mfilt_bits, K) -> Phi:
    """A float32 port ``Phi`` from array-likes (CPU tensors)."""
    f32 = lambda x: torch.as_tensor(np.array(x, np.float32))  # noqa: E731
    return Phi(T=f32(T), mfilt_bits=f32(mfilt_bits), K=f32(K))


def _level_from_numpy(lv: Mapping[str, Any], device) -> LevelStore:
    """One level dict (keys, vals, starts, n_bits, ks, flushes, tomb_seqs,
    min_keys, max_keys, words) -> a port ``LevelStore`` on ``device``."""
    starts = np.asarray(lv["starts"], np.int64)
    keys = to_device_keys(np.asarray(lv["keys"], np.uint64), device)
    vals = torch.from_numpy(np.ascontiguousarray(
        np.asarray(lv["vals"], np.int64))).to(device)
    words = lv.get("words")
    runs = []
    for r in range(len(starts) - 1):
        s, e = int(starts[r]), int(starts[r + 1])
        w = None if words is None or words[r] is None else torch.from_numpy(
            np.ascontiguousarray(np.asarray(words[r], np.uint64))
            .view(np.int64)).to(device)
        runs.append(RunData(
            keys=keys[s:e], vals=vals[s:e], flushes=int(lv["flushes"][r]),
            n_bits=int(lv["n_bits"][r]), k=int(lv["ks"][r]),
            min_key=int(lv["min_keys"][r]), max_key=int(lv["max_keys"][r]),
            words=w, tomb_seq=int(lv["tomb_seqs"][r])))
    out = LevelStore(device)
    out._set_runs(runs)
    return out


def tree_from_numpy(config_fields: Mapping[str, Any],
                    levels: Sequence[Mapping[str, Any]],
                    codec_objects: Sequence[Any],
                    buffer: Mapping[int, int],
                    stats: Mapping[str, Any],
                    flush_seq: int, device=None) -> LSMTree:
    """A port ``LSMTree`` holding the given state.

    ``config_fields`` are ``EngineConfig``'s fields (``dataclasses.asdict``
    of the reference config); ``levels`` one dict per level, 1-indexed
    order (see :func:`_level_from_numpy`); ``codec_objects`` the intern
    table; ``buffer`` the memtable (uint64 key -> encoded value);
    ``stats`` ``IOStats``'s fields."""
    fields: Dict[str, Any] = dict(config_fields)
    fields["K"] = tuple(int(k) for k in fields.get("K", ()))
    fields["policy_params"] = tuple(
        tuple(p) for p in fields.get("policy_params", ()))
    tree = LSMTree(EngineConfig(**fields), device=device)
    tree.store.levels = [_level_from_numpy(lv, tree.device) for lv in levels]
    tree.store.codec.objects = list(codec_objects)
    tree.buffer = {int(k): int(v) for k, v in buffer.items()}
    names = {f.name for f in dataclasses.fields(IOStats)}
    tree.stats = IOStats(**{k: (dict(v) if k == "queries" else int(v))
                            for k, v in stats.items() if k in names})
    tree.flush_seq = int(flush_seq)
    return tree


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included) on ``device``."""
    a = np.array(a, order="C")              # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map_tree(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


# the reference's stacked layer entries; every other top-level entry of a
# parameter tree is carried as it is
_ENCDEC_STACKS = ("enc_layers", "dec_layers")
_LM_STACKS = ("layers", "prelude")


def lm_params_from_numpy(cfg: ModelConfig, params_np: Mapping[str, Any],
                         device=None) -> Dict[str, Any]:
    """The port's parameter tree (``models/lm.py`` or ``models/encdec.py``)
    from the JAX ``init_lm`` or ``init_encdec`` tree as numpy arrays: see
    :func:`lm_params_from_reference`.  On ``device`` (the card unless
    ``"cpu"``)."""
    tensors = {name: _map_tree(lambda a: _tensor(a, "cpu"), tree)
               for name, tree in params_np.items()}
    return lm_params_from_reference(cfg, tensors, device)


def _unstack(stacked, n: int, dev) -> list:
    """Rows 0..n-1 of a tree stacked along a leading axis, as copies."""
    return [_map_tree(lambda a, r=r: a[r].to(dev).clone(), stacked)
            for r in range(n)]


def lm_params_from_reference(cfg: ModelConfig, tree: Mapping[str, Any],
                             device=None) -> Dict[str, Any]:
    """The port's parameter tree from the reference's layout in torch
    tensors (a restored checkpoint), on ``device`` (the card unless
    ``"cpu"``).  Every top-level entry but the layer stacks comes as it
    is.  The encoder-decoder's stacked ``enc_layers`` and ``dec_layers``
    become lists of per-layer copies.  An LM's ``prelude`` blocks followed
    by ``layers/sub<j>/...`` (stacked along a leading axis of
    ``cfg.n_repeats``) become one list, in execution order (prelude block
    i -> layer i; repeat r, pattern entry j -> layer len(prelude) + r *
    len(pattern) + j)."""
    dev = resolve_device(device)
    stacks = _ENCDEC_STACKS if cfg.encoder is not None else _LM_STACKS
    out: Dict[str, Any] = {
        name: _map_tree(lambda a: a.to(dev), sub)
        for name, sub in tree.items() if name not in stacks}
    if cfg.encoder is not None:
        out["enc_layers"] = _unstack(tree["enc_layers"],
                                     cfg.encoder.num_layers, dev)
        out["dec_layers"] = _unstack(tree["dec_layers"], cfg.num_layers,
                                     dev)
        return out
    prelude = list(tree.get("prelude") or ())
    if len(prelude) != len(cfg.prelude):
        raise ValueError(f"{len(prelude)} prelude blocks for "
                         f"{cfg.name}'s {len(cfg.prelude)}")
    groups = tree["layers"]
    out["layers"] = [
        _map_tree(lambda a: a.to(dev).clone(), blk) for blk in prelude] + [
        _map_tree(lambda a, r=r: a[r].to(dev).clone(), groups[f"sub{j}"])
        for r in range(cfg.n_repeats) for j in range(len(cfg.pattern))]
    return out


def _stack(items: Sequence[Any]):
    if isinstance(items[0], Mapping):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return torch.stack(list(items))


def lm_params_to_reference(cfg: ModelConfig,
                           params: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's ``init_lm`` (``init_encdec``) layout of the port's
    parameters, in torch tensors: every top-level entry but the layer
    lists as it is; the encoder-decoder's ``enc_layers`` and
    ``dec_layers`` stacked; an LM's first ``len(cfg.prelude)`` layers as
    the ``prelude`` list, and the rest as ``layers/sub<j>/...`` stacked
    (layer len(prelude) + r * len(pattern) + j is row r of ``sub<j>``)."""
    if cfg.encoder is not None:
        return {name: (_stack(sub) if name in _ENCDEC_STACKS else sub)
                for name, sub in params.items()}
    n_pat, n_pre = len(cfg.pattern), len(cfg.prelude)
    out: Dict[str, Any] = {name: sub for name, sub in params.items()
                           if name != "layers"}
    out["prelude"] = list(params["layers"][:n_pre])
    scanned = params["layers"][n_pre:]
    out["layers"] = {f"sub{j}": _stack(scanned[j::n_pat])
                     for j in range(n_pat)}
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_to_numpy(cfg: ModelConfig,
                       params: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`lm_params_from_numpy`: the reference's layout
    in numpy arrays, bfloat16 leaves widened to float32."""
    return tree_map(_numpy, lm_params_to_reference(cfg, params))


def adamw_state_from_numpy(cfg, state, device=None) -> AdamWState:
    """A reference ``AdamWState`` (``np.asarray`` on each leaf) as the
    port's: ``step`` a 0-d int32 tensor, ``mu``/``nu`` in the port's
    parameter layout when ``cfg`` is an LM config (else the same tree),
    on ``device``."""
    dev = resolve_device(device)
    if cfg is None:
        mu, nu = (tree_map(lambda a: _tensor(a, dev), m)
                  for m in (state.mu, state.nu))
    else:
        mu, nu = (lm_params_from_numpy(cfg, m, dev)
                  for m in (state.mu, state.nu))
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=dev)
    return AdamWState(step=step, mu=mu, nu=nu)


def adamw_state_to_reference(cfg: ModelConfig,
                             state: AdamWState) -> AdamWState:
    """An LM's ``AdamWState`` with ``mu``/``nu`` in the reference's layout
    (stacked layers): the tree whose leaves, in order, a checkpoint's
    ``opt_state.npz`` numbers."""
    return AdamWState(step=state.step,
                      mu=lm_params_to_reference(cfg, state.mu),
                      nu=lm_params_to_reference(cfg, state.nu))
