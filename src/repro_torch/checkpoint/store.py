"""Checkpointing with an ENDURE-tuned LSM manifest, and the storm-batched
re-tune path: the port of ``repro/checkpoint/store.py``.

The framework derives an expected storage workload mix from a run's
behaviour (checkpoint writes vs. restore reads vs. manifest scans) and an
uncertainty radius rho, and deploys the robust tuner's output through
``LSMTree.from_phi``.  Every re-tune in the port goes through one batched
path, :func:`retune_storm`: the online drift loop's triggers
(:mod:`repro_torch.online.retune`) and a fleet of manifests re-deriving
their tunings alike.

:class:`CheckpointStore` saves a trainer's state: tensors as flat
``.npy`` files (the optimizer state as one ``opt_state.npz``) and all
metadata (per-tensor entries, the step registry, the data cursor,
heartbeats) in a :func:`tuned_manifest_tree` on the caller's device, so
every save's flush runs the engine's ``merge`` and every lookup its
``point_read`` there.  Its files, their names and bytes, and its manifest
entries are the reference's for the same tree: a leaf is named as
``jax.tree_util.keystr`` names its path (:mod:`repro_torch.utils.tree`),
``opt_state.npz``'s ``s<i>`` follow the reference's leaf order, bfloat16
is widened to float32 on save and cast back on restore, and each file is
written atomically before the ``latest`` pointer flips.

Like the reference, a new store starts with an empty, in-memory manifest:
``CheckpointStore.create`` on a directory that holds checkpoints sees none
(``latest_step()`` is None), so a trainer that "resumes" through a new
store starts from step 0.  The port keeps that semantics on purpose
(persisting the manifest would be a feature the JAX package lacks).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import pathlib
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core import LSMSystem, tune_robust_many
from ..faults import atomic_write_bytes
from ..kernels._compat import resolve_device
from ..lsm import LSMTree
from ..utils.tree import leaves, leaves_with_path, unflatten_like


def _key_of(name: str) -> int:
    """Manifest keys are uint64 hashes of the logical name."""
    return int.from_bytes(hashlib.blake2b(name.encode(),
                                          digest_size=8).digest(), "big")


def framework_storage_workload(ckpt_interval: int, restore_prob: float,
                               scan_frac: float = 0.05) -> np.ndarray:
    """Map run behaviour to the paper's (z0, z1, q, w) workload vector.

    writes  ~ manifest puts per checkpoint; z1 ~ restores + lookups;
    z0 ~ existence probes of absent steps; q ~ manifest scans (listing)."""
    w_write = 1.0 / max(ckpt_interval, 1) * 20
    z1 = 0.2 + restore_prob
    z0 = 0.1
    q = scan_frac
    v = np.array([z0, z1, q, w_write], np.float64)
    return v / v.sum()


def retune_storm(workloads, rhos, sys, seed: int = 0, design=None,
                 n_starts: int = 64, steps: int = 250, lr: float = 0.25,
                 pad_pow2: bool = False, device=None, starts=None) -> list:
    """One batched tuner dispatch for a fleet-wide re-tuning storm.

    A batch of (workload, rho) re-tune requests becomes ONE
    ``tune_robust_many`` grid (workloads on one axis, the distinct positive
    rhos on the other, each request picking its cell) plus one
    ``tune_nominal_many`` batch for the ``rho <= 0`` requests, instead of a
    per-request ``tune_robust`` loop.

    ``pad_pow2`` pads the workload axis to the next power of two with
    repeats of the last row (dropped from the result), so storm sizes fall
    in O(log fleet) lane-batch shapes.  The lanes are independent, so
    padding never changes the surviving results.  ``device`` is where the
    storm runs (``None``: the card); ``starts`` (``(1, n_starts, n_params)``
    or None for the tuners' own draw from ``seed``) seeds every lane.

    Returns one :class:`repro_torch.core.TuningResult` per request, in
    order."""
    W = np.atleast_2d(np.asarray(workloads, np.float64))
    R = np.asarray(rhos, np.float64).reshape(-1)
    if len(W) != len(R):
        raise ValueError(f"{len(W)} workloads for {len(R)} rhos")
    obs.count("tuner.storms")
    obs.count("tuner.storm_requests", len(W))
    with obs.span("tuner.storm", requests=len(W), pad_pow2=bool(pad_pow2)):
        return _retune_storm(W, R, sys, seed, design, n_starts, steps, lr,
                             pad_pow2, device, starts)


def _retune_storm(W, R, sys, seed, design, n_starts, steps, lr,
                  pad_pow2, device, starts) -> list:
    from ..core import tune_nominal_many
    kw = dict(n_starts=n_starts, steps=steps, lr=lr, seed=seed,
              device=device, starts=starts)
    if design is not None:
        kw["design"] = design

    def padded(M: np.ndarray) -> np.ndarray:
        if not pad_pow2 or len(M) < 2:
            return M
        P = 1 << (len(M) - 1).bit_length()
        return np.concatenate([M, np.repeat(M[-1:], P - len(M), axis=0)])

    out: list = [None] * len(W)
    nom = np.flatnonzero(R <= 0)
    if nom.size:
        res = tune_nominal_many(padded(W[nom]), sys, **kw)
        for i, r in zip(nom, res):
            out[i] = r
    rob = np.flatnonzero(R > 0)
    if rob.size:
        uniq = sorted(set(float(r) for r in R[rob]))
        grid = tune_robust_many(padded(W[rob]), uniq, sys, **kw)
        for row, i in zip(grid, rob):
            out[i] = row[uniq.index(float(R[i]))]
    return out


def tuned_manifest_trees(specs: Sequence[Dict[str, Any]], seed: int = 0,
                         device=None) -> list:
    """Deploy ENDURE-tuned manifests for a whole fleet in ONE tuner dispatch
    per distinct store size.

    ``specs`` is a sequence of dicts with the :func:`tuned_manifest_tree`
    keywords (``expected_entries``, ``ckpt_interval``, ``restore_prob``,
    ``rho``); their tunings go through :func:`retune_storm` (one batched
    grid per distinct store size), and each tree is deployed on
    ``device``."""
    trees: list = [None] * len(specs)
    by_n: Dict[int, list] = {}
    for i, spec in enumerate(specs):
        by_n.setdefault(int(spec.get("expected_entries", 50_000)),
                        []).append(i)
    for n_entries, idxs in by_n.items():
        sys_small = LSMSystem(N=float(n_entries), entry_bits=256 * 8,
                              page_bits=4096 * 8, bits_per_entry=16.0,
                              min_buf_bits=256 * 8 * 64, s_rq=2e-5)
        W = [framework_storage_workload(
            specs[i].get("ckpt_interval", 100),
            specs[i].get("restore_prob", 0.3)) for i in idxs]
        rhos = [float(specs[i].get("rho", 1.0)) for i in idxs]
        tunings = retune_storm(np.stack(W), rhos, sys_small, seed=seed,
                               device=device)
        for i, tuning in zip(idxs, tunings):
            trees[i] = LSMTree.from_phi(tuning.phi, sys_small,
                                        expected_entries=n_entries,
                                        entry_bytes=256, device=device)
    return trees


def tuned_manifest_tree(expected_entries: int = 50_000,
                        ckpt_interval: int = 100,
                        restore_prob: float = 0.3,
                        rho: float = 1.0,
                        seed: int = 0, device=None) -> LSMTree:
    """An LSM manifest whose (T, K, memory split) comes from ENDURE."""
    return tuned_manifest_trees([dict(expected_entries=expected_entries,
                                      ckpt_interval=ckpt_interval,
                                      restore_prob=restore_prob, rho=rho)],
                                seed=seed, device=device)[0]


_STORED = ("float32", "float64", "int32", "int64", "uint32", "uint64",
           "bool")


def _to_numpy(leaf) -> np.ndarray:
    """A leaf (a tensor on any device, or an array) as a host numpy array,
    bfloat16 widened to float32 (numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _restored(arr: np.ndarray, like, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, order="C")).to(
        device=device, dtype=_torch_dtype(like.dtype))


@dataclasses.dataclass
class CheckpointStore:
    root: pathlib.Path
    manifest: LSMTree

    @classmethod
    def create(cls, root: str, device=None,
               **tuning_kw) -> "CheckpointStore":
        """A store at ``root`` with a new ENDURE-tuned manifest on
        ``device`` (the card unless ``"cpu"``); ``tuning_kw`` are
        :func:`tuned_manifest_tree`'s."""
        p = pathlib.Path(root)
        p.mkdir(parents=True, exist_ok=True)
        dev = resolve_device(device)
        return cls(root=p, manifest=tuned_manifest_tree(device=dev,
                                                        **tuning_kw))

    # -- manifest KV helpers --------------------------------------------

    def _mput(self, name: str, value: Dict[str, Any]) -> None:
        self.manifest.put(_key_of(name), json.dumps(value))

    def _mget(self, name: str) -> Optional[Dict[str, Any]]:
        v = self.manifest.get(_key_of(name))
        return None if v is None else json.loads(v)

    # -- save / restore ----------------------------------------------------

    @staticmethod
    def _write_array(path: pathlib.Path, arr: np.ndarray) -> None:
        """One tensor file, atomically: serialize to memory, then temp +
        ``os.replace`` — a crash mid-save can leave an *unreferenced* file,
        never a torn ``.npy`` at a path the manifest points to."""
        buf = io.BytesIO()
        np.save(buf, arr)
        atomic_write_bytes(str(path), buf.getvalue())

    @staticmethod
    def _write_npz(path: pathlib.Path, arrays: Dict[str, np.ndarray]) -> None:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        atomic_write_bytes(str(path), buf.getvalue())

    def save(self, step: int, params: Any, opt_state: Any = None,
             data_state: Optional[Dict[str, int]] = None) -> None:
        """Write one checkpoint crash-safely.

        Every tensor file and per-step manifest entry lands *before* the
        ``latest`` pointer flips, and each file write is atomic — so a save
        interrupted anywhere leaves ``latest_step()`` on the previous fully
        written checkpoint.  ``params`` and ``opt_state`` are trees of
        tensors or arrays; a trainer passes the reference's layout
        (``convert.lm_params_to_reference``)."""
        ckdir = self.root / f"step_{step:08d}"
        ckdir.mkdir(parents=True, exist_ok=True)
        names = []
        for name, leaf in leaves_with_path(params):
            arr = _to_numpy(leaf)
            if arr.dtype.name not in _STORED:
                arr = arr.astype(np.float32)  # bf16 etc: store widened
            fname = hashlib.md5(name.encode()).hexdigest() + ".npy"
            self._write_array(ckdir / fname, arr)
            self._mput(f"tensor/{step}/{name}", {
                "file": fname, "shape": list(arr.shape),
                "dtype": str(arr.dtype)})
            names.append(name)
        extras: Dict[str, Any] = {"names": names, "step": step}
        if data_state is not None:
            extras["data_state"] = data_state
        self._mput(f"ckpt/{step}", extras)
        if opt_state is not None:
            self._write_npz(ckdir / "opt_state.npz", {
                f"s{i}": _to_numpy(leaf)
                for i, leaf in enumerate(leaves(opt_state))})
        # the commit point: everything above must already be durable
        self._mput("latest", {"step": step})
        self.manifest.flush()

    def latest_step(self) -> Optional[int]:
        v = self._mget("latest")
        return None if v is None else int(v["step"])

    def restore(self, params_like: Any, step: Optional[int] = None,
                device=None) -> Tuple[Any, Dict[str, Any]]:
        """The checkpoint of ``step`` (default: the latest) in
        ``params_like``'s structure, each leaf a tensor of its ``like``'s
        shape and dtype (a torch or numpy dtype) on ``device`` (default:
        the manifest's), and the step's metadata.  ``device`` stands in for
        the reference's ``shardings``: one card holds every leaf whole."""
        step = self.latest_step() if step is None else step
        assert step is not None, "no checkpoint found"
        meta = self._mget(f"ckpt/{step}")
        assert meta is not None, f"manifest missing ckpt/{step}"
        dev = self.manifest.device if device is None else device
        ckdir = self.root / f"step_{step:08d}"
        out = []
        for name, like in leaves_with_path(params_like):
            info = self._mget(f"tensor/{step}/{name}")
            assert info is not None, f"manifest missing {name}"
            arr = np.load(ckdir / info["file"])
            assert list(arr.shape) == list(like.shape), (name, arr.shape,
                                                         like.shape)
            out.append(_restored(arr, like, dev))
        return unflatten_like(params_like, out), meta

    def restore_opt_state(self, opt_like: Any, step: Optional[int] = None,
                          device=None) -> Any:
        step = self.latest_step() if step is None else step
        dev = self.manifest.device if device is None else device
        z = np.load(self.root / f"step_{step:08d}" / "opt_state.npz")
        out = [_restored(z[f"s{i}"], like, dev) if hasattr(like, "dtype")
               else z[f"s{i}"] for i, like in enumerate(leaves(opt_like))]
        return unflatten_like(opt_like, out)

    # -- health / straggler bookkeeping (elastic.py reads these) -----------

    def heartbeat(self, worker: int, step: int, t: float) -> None:
        self._mput(f"hb/{worker}", {"step": step, "t": t})

    def heartbeats(self, workers: int) -> Dict[int, Dict[str, Any]]:
        out = {}
        for w in range(workers):
            v = self._mget(f"hb/{w}")
            if v is not None:
                out[w] = v
        return out
