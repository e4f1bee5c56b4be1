"""Roofline terms for the NVIDIA H100 SXM from a dry-run trace: the port of
``repro/utils/roofline.py`` (which charges a TPU v5e).

Hardware constants, per GPU.  All four are datasheet peaks (NVIDIA H100
Tensor Core GPU datasheet; NVIDIA ConnectX-7 400G NIC), not
measurements:

* ``PEAK_FLOPS`` 989e12 — dense BF16 Tensor Core FLOP/s of the SXM part;
* ``HBM_BW`` 3.35e12 — HBM3 bytes/s;
* ``NVLINK_BW`` 450e9 — NVLink 4 bytes/s in one direction (900 GB/s
  total), charged on a mesh axis whose groups all fit in one 8-GPU node;
* ``NIC_BW`` 50e9 — one 400 Gb/s NIC a GPU, charged on an axis whose
  groups cross nodes.

Ranks are placed on nodes row-major (rank r on node r // 8), as
``launch/mesh.py`` numbers a mesh.  Every trace-derived quantity is PER
DEVICE (``utils/trace_costs.py`` counts one rank's local program), so
terms are seconds a step directly:

  compute_s    = flops_per_device / PEAK_FLOPS
  memory_s     = bytes_per_device / HBM_BW
  collective_s = sum_axis collective_bytes_axis / bandwidth(axis)

MODEL_FLOPS is the analytic useful compute: 6*N*D for dense training
(2*N*D prefill, 2*N*B_tokens decode), with N = active params for MoE.
The ratio MODEL_FLOPS / (trace FLOPs * chips) exposes remat and dispatch
waste.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

from ..configs.base import ModelConfig, ShapeConfig

PEAK_FLOPS = 989e12          # bf16 dense / GPU
HBM_BW = 3.35e12             # bytes/s / GPU
NVLINK_BW = 450e9            # bytes/s / GPU, one direction
NIC_BW = 50e9                # bytes/s / GPU (400 Gb/s)
NODE_GPUS = 8


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    collective_by_axis: Dict[str, float]
    hlo_flops_per_dev: float
    hlo_bytes_per_dev: float
    model_flops_total: float
    useful_ratio: float          # MODEL_FLOPS / (trace FLOPs * chips)
    bottleneck: str
    step_time_s: float           # max of the three terms (no overlap)
    roofline_frac: float         # compute_s / step_time_s
    memory_per_dev_gb: Optional[float] = None
    notes: str = ""

    def row(self) -> str:
        col = ",".join(f"{a}:{v*1e3:.2f}ms"
                       for a, v in sorted(self.collective_by_axis.items()))
        mem = f"{self.memory_per_dev_gb:.2f}" if self.memory_per_dev_gb \
            else "-"
        return (f"| {self.arch} | {self.shape} | {self.mesh} "
                f"| {self.compute_s*1e3:.2f} | {self.memory_s*1e3:.2f} "
                f"| {self.collective_s*1e3:.2f} ({col}) "
                f"| **{self.bottleneck}** | {self.useful_ratio:.2f} "
                f"| {self.roofline_frac:.2f} | {mem} |")


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic 'useful' FLOPs per step: 6ND train / 2ND prefill / 2NB
    decode (N = active params)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def axis_bandwidths(mesh_shape: Sequence[int],
                    axis_names: Sequence[str]) -> Dict[str, float]:
    """Bytes/s charged on each mesh axis: ``NVLINK_BW`` when every group
    of the axis lies in one node of ``NODE_GPUS`` (ranks row-major), else
    ``NIC_BW``."""
    shape = tuple(mesh_shape)
    n = math.prod(shape)
    out = {}
    for i, name in enumerate(axis_names):
        stride = math.prod(shape[i + 1:])
        inside = True
        for r in range(n):
            if (r // stride) % shape[i]:
                continue                     # not the first of its group
            last = r + stride * (shape[i] - 1)
            if r // NODE_GPUS != last // NODE_GPUS:
                inside = False
                break
        out[name] = NVLINK_BW if inside else NIC_BW
    return out


def terms_from_costs(arch: str, shape: ShapeConfig, mesh_name: str,
                     chips: int, costs, cfg: ModelConfig,
                     bandwidth: Dict[str, float],
                     memory_per_dev_gb: Optional[float] = None,
                     notes: str = "") -> RooflineTerms:
    """The roofline of one cell from its per-device ``costs``
    (``trace_costs.TraceCosts``); ``bandwidth``: bytes/s per mesh axis
    (:func:`axis_bandwidths`)."""
    compute_s = costs.flops / PEAK_FLOPS
    memory_s = costs.bytes / HBM_BW
    col_by_axis = {a: b / bandwidth[a]
                   for a, b in costs.collective_bytes_by_axis.items()}
    collective_s = sum(col_by_axis.values())
    mf = model_flops(cfg, shape)
    useful = mf / max(costs.flops * chips, 1.0)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step = max(terms.values())
    return RooflineTerms(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        collective_by_axis=col_by_axis,
        hlo_flops_per_dev=costs.flops,
        hlo_bytes_per_dev=costs.bytes,
        model_flops_total=mf, useful_ratio=useful,
        bottleneck=bottleneck, step_time_s=step,
        roofline_frac=compute_s / step if step > 0 else 0.0,
        memory_per_dev_gb=memory_per_dev_gb, notes=notes)


TABLE_HEADER = (
    "| arch | shape | mesh | compute (ms) | memory (ms) "
    "| collective (ms, by axis) | bottleneck | useful 6ND/HLO "
    "| roofline frac | mem/dev (GB) |\n"
    "|---|---|---|---|---|---|---|---|---|---|")
