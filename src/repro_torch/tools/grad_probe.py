"""Where a full-width model's gradient norm comes from, on the card.

    PYTHONPATH=src python -m repro_torch.tools.grad_probe \\
        [--arch rwkv6-3b] [--layers 4 32] [--dtypes bfloat16 float32]

For each (depth, dtype): the architecture at its published width with its
first ``layers`` layers, as the trainer runs it (``attention_impl="plain"``,
its remat), drawn from seed 0 (the bfloat16 weights are the float32 ones
rounded), one loss and gradient on the pipeline's first batch (8 x 512
tokens), and one JSON line with the loss, the global gradient norm and
the six largest per-leaf norms by name.  Then the card's name and power
limit.  Telling the model's own gradient scale from bfloat16 rounding is
what the float32 run is for.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..data.pipeline import DataConfig, shard_batch_at
from ..launch.train import train_config
from ..models import build_model
from ..models import lm as lm_mod
from ..utils.tree import leaves, leaves_with_path


def probe(arch: str, layers: int, dtype: str, batch: int = 8,
          seq: int = 512) -> dict:
    cfg = train_config(arch, False).replace(num_layers=layers, dtype=dtype,
                                            param_dtype=dtype)
    model = build_model(cfg, "cuda", seed=0)
    model.requires_grad_(True)
    params = model.params
    b = shard_batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch), 0, 0, 1)
    data = {k: torch.as_tensor(np.asarray(b[k], np.int64), device="cuda")
            for k in ("tokens", "labels")}
    loss, _ = lm_mod.lm_loss(params, data, cfg)
    grads = torch.autograd.grad(loss, leaves(params))
    norms = sorted(((float(g.float().norm()), name) for (name, _), g in
                    zip(leaves_with_path(params), grads)), reverse=True)
    total = float(torch.sqrt(sum(g.float().square().sum() for g in grads)))
    return {"arch": arch, "layers": layers, "dtype": dtype,
            "loss": loss.item(), "grad_norm": total, "top_leaves": norms[:6],
            "finite": all(bool(torch.isfinite(g).all()) for g in grads)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 32])
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    for layers in args.layers:
        for dtype in args.dtypes:
            print(json.dumps(probe(args.arch, layers, dtype)), flush=True)
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
