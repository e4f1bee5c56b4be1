"""Gradient compression for cross-pod reduction, with error feedback: the
port of ``repro/optim/compression.py``.

Gradients are quantized to int8 with a per-block (``BLOCK`` entries)
symmetric scale before the cross-pod reduction, and the quantization
residual stays local ("error feedback", Karimireddy et al., 2019).
``torch.round`` rounds half to even as ``jnp.round`` does, so the int8
payloads are the reference's bit for bit.

As in the JAX package the trainer does not call it
(``TrainConfig.grad_compression`` is unused): it is a pure module whose
collectives are injected (``psum_fn``/``pmax_fn`` over trees), so its
arithmetic runs without a process group.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
import torch.nn.functional as F

from ..utils.tree import leaves, tree_map, unflatten_like

BLOCK = 256


def _blocks(flat: torch.Tensor) -> torch.Tensor:
    """A flat float32 tensor zero-padded to whole blocks, (-1, BLOCK)."""
    pad = (-flat.shape[0]) % BLOCK
    return F.pad(flat, (0, pad)).reshape(-1, BLOCK)


def _block_scale(xp: torch.Tensor) -> torch.Tensor:
    s = torch.amax(torch.abs(xp), dim=1, keepdim=True) / 127.0
    return torch.clamp(s, min=1e-12)


def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization. x: flat f32."""
    xp = _blocks(x)
    scale = _block_scale(xp)
    q = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor, n: int
                ) -> torch.Tensor:
    x = (q.float() * scale).reshape(-1)
    return x[:n]


def _map_tuples(fn, tree, *rest):
    """``fn`` over the leaves, each call returning a tuple; -> one tree per
    element of the tuples."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    outs = [fn(*xs) for xs in zip(*cols)]
    return [unflatten_like(tree, [o[i] for o in outs])
            for i in range(len(outs[0]))] if outs else []


def compress_grads(grads: Any, residual: Any) -> Tuple[Any, Any, Any]:
    """-> (quantized payloads, scales, new residuals). Leafwise int8 + EF."""
    def one(g, r):
        gf = g.float() + r
        flat = gf.reshape(-1)
        q, s = _quantize_int8(flat)
        deq = _dequantize(q, s, flat.shape[0]).reshape(g.shape)
        return q, s, gf - deq  # residual carries quantization error

    return tuple(_map_tuples(one, grads, residual))


def decompress_grads(qs: Any, ss: Any, like: Any) -> Any:
    def one(q, s, g):
        return _dequantize(q, s, g.numel()).reshape(g.shape).to(g.dtype)

    return tree_map(one, qs, ss, like)


def compressed_cross_pod_mean(grads: Any, residual: Any,
                              psum_fn: Callable[[Any], Any],
                              pmax_fn: Callable[[Any], Any],
                              n_pods: int) -> Tuple[Any, Any]:
    """Two-phase compressed mean across pods.

    1. max-reduce the blockwise scales so all pods quantize on a COMMON grid;
    2. sum-reduce the int8 payloads in int32;
    3. dequantize with the common scale / n_pods -> exact mean of the
       quantized gradients.  Per-pod quantization error stays in the local
       error-feedback residual.

    ``psum_fn`` / ``pmax_fn`` are the collectives over trees (e.g. an
    ``all_reduce`` over a process group); injected so the arithmetic runs
    without one."""
    def local_scale(g, r):
        return _block_scale(_blocks((g.float() + r).reshape(-1)))

    scales = pmax_fn(tree_map(local_scale, grads, residual))

    def quantize_common(g, r, s):
        gf = g.float() + r
        flat = gf.reshape(-1)
        q = torch.clamp(torch.round(_blocks(flat) / s), -127,
                        127).to(torch.int8)
        deq = _dequantize(q, s, flat.shape[0]).reshape(g.shape)
        return q, gf - deq

    qs, new_res = _map_tuples(quantize_common, grads, residual, scales)
    qsum = psum_fn(tree_map(lambda q: q.to(torch.int32), qs))
    mean = tree_map(
        lambda q, s, g: _dequantize(q.float(), s / n_pods,
                                    g.numel()).reshape(g.shape),
        qsum, scales, grads)
    return mean, new_res
