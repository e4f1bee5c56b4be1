"""AdamW with global-norm clipping: the port of ``repro/optim/adamw.py``.

Optimizer state is a tree shaped exactly like the parameters (the port's
nested dicts and lists of tensors, :mod:`repro_torch.utils.tree`), with
float32 moments whatever the parameter dtype, and a step counter (a 0-d
int32 tensor) beside them.

What differs from the JAX module: :func:`update` writes the new
parameters and moments into the tensors it was given and returns those
same tensors (a jitted JAX step donates its buffers to the same end).  It
walks one leaf at a time, and a large leaf in slices of ``SLICE``
entries, so the float32 temporaries of the update never exceed a few
slices: at full width the largest leaf is ``qwen3-14b``'s ``lm_head``
(778 M entries, 3.1 GB a float32 copy).  Every operation is elementwise,
so the slicing changes no number.  A DTensor leaf (the dry run's) updates
whole: each rank holds its shard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..utils.tree import leaves, tree_map

# entries a slice of one leaf's update
SLICE = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # moments kept in f32 regardless of param dtype (mixed-precision safe)
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def init(params: Any) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _flat_slices(*tensors: torch.Tensor):
    """Aligned slices of SLICE entries of each tensor's flat view.  A
    DTensor comes whole: each rank updates its own shard, and the flat
    view of a sharded tensor would gather it."""
    if hasattr(tensors[0], "placements"):       # a DTensor
        yield list(tensors)
        return
    flats = [t.reshape(-1) for t in tensors]
    n = flats[0].numel()
    for lo in range(0, n, SLICE):
        yield [f[lo:lo + SLICE] for f in flats]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sums = []
    for x in leaves(tree):
        s = None
        for (c,) in _flat_slices(x):
            part = torch.sum(torch.square(c.float()))
            s = part if s is None else s + part
        sums.append(s)
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def update(grads: Any, state: AdamWState, params: Any,
           cfg: AdamWConfig) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}), the
    parameters and moments updated in place."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cfg.lr if cfg.schedule is None else cfg.lr * cfg.schedule(step)

    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    bias1 = 1.0 - torch.pow(b1, t)
    bias2 = 1.0 - torch.pow(b2, t)

    for p, g, mu, nu in zip(leaves(params), leaves(grads), leaves(state.mu),
                            leaves(state.nu)):
        if not (p.is_contiguous() and mu.is_contiguous()
                and nu.is_contiguous()):
            raise ValueError("adamw.update writes parameters and moments "
                             "in place: they must be contiguous")
        for ps, gs, ms, ns in _flat_slices(p, g, mu, nu):
            gf = gs.float() * scale
            ms.copy_(b1 * ms + (1 - b1) * gf)
            ns.copy_(b2 * ns + (1 - b2) * gf * gf)
            del gf
            delta = (ms / bias1) / (torch.sqrt(ns / bias2) + cfg.eps)
            delta = delta + cfg.weight_decay * ps.float()
            ps.copy_((ps.float() - lr * delta).to(ps.dtype))
    new_state = AdamWState(step=step, mu=state.mu, nu=state.nu)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def cosine_schedule(warmup: int, total: int, floor: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return warm * cos
    return fn
