"""Batched serving: prefill a batch of prompts, then decode greedily.

The port of ``repro/launch/serve.py`` for every architecture.  The
inputs are drawn as the reference draws them, in its numpy order: the
prompts' tokens, then, for the encoder-decoder, (B, prompt_len, d_input)
frame embeddings (the decoder prefills the tokens), or, for a
stub-embedding model, (B, prompt_len, d) embeddings in place of the
tokens, whose decode feeds back each new token's output embedding
``embed_out[token]``.  The decode cache is allocated once (attention k/v
at ``prompt_len + gen`` positions, or a ring of ``window`` slots; the RWKV
state and last rows and the Mamba conv window and state at their fixed
size; the encoder-decoder's cross K/V at the encoder's length) and the
prefill's cache is written into it in place (:func:`write_prefill_cache`),
which takes the place of the JAX package's ``pad_cache_to``.  (That one
pads the cross K/V out to ``prompt_len + gen`` rows of zeros, which every
decode step attends to; ROADMAP.md section 3.)  :func:`serve_batch` builds the model by name;
:func:`serve_model` serves one already built (a config cut in depth, say).
Times are host wall clock up to a device synchronise.

CLI:  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
          --reduced --device cpu
      PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
          --reduced --device cpu
      PYTHONPATH=src python -m repro_torch.launch.serve \\
          --arch deepseek-moe-16b --reduced --device cpu
      PYTHONPATH=src python -m repro_torch.launch.serve \\
          --arch jamba-1.5-large-398b --reduced --device cpu
      PYTHONPATH=src python -m repro_torch.launch.serve \\
          --arch whisper-base --reduced --device cpu
      PYTHONPATH=src python -m repro_torch.launch.serve \\
          --arch qwen2-vl-72b --reduced --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..models import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _write_kv(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Prompt k/v (B, S, KV, hd) into a cache of ``dst.shape[1]`` slots.  A
    ring cache (sliding window, fewer slots than the prompt) keeps the last
    positions, each at slot ``pos % slots``, as ``attention_decode``
    indexes it."""
    S, slots = src.shape[1], dst.shape[1]
    if S <= slots:
        dst[:, :S] = src
    else:
        pos = torch.arange(S - slots, S, device=dst.device)
        dst[:, pos % slots] = src[:, S - slots:]


def write_prefill_cache(cache: List[Dict[str, Any]],
                        prefill_cache: List[Dict[str, Any]]) -> None:
    """Copy every tensor of each layer's prefill cache into the decode
    cache: self-attention k/v along the sequence (:func:`_write_kv`),
    anything else (the RWKV state, the time and channel mixes' ``x_prev``,
    the Mamba conv window and state, the encoder-decoder's cross K/V at
    the encoder's length) whole."""
    for c, pc in zip(cache, prefill_cache):
        for part, tensors in pc.items():
            for name, src in tensors.items():
                dst = c[part][name]
                if part in ("mixer", "self") and name in ("k", "v"):
                    _write_kv(dst, src)
                else:
                    dst.copy_(src)


def serve_batch(arch: str, reduced: bool = True, batch: int = 4,
                prompt_len: int = 16, gen: int = 16, seed: int = 0,
                device=None, params: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``gen`` tokens each, greedily.  ``params`` (``model.init_params``'
    tree, e.g. from ``convert.lm_params_from_numpy``) replaces the seeded
    init.
    See :func:`serve_model` for the result."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device, seed=seed, params=params)
    return serve_model(model, batch, prompt_len, gen, seed)


def serve_inputs(cfg, batch: int, prompt_len: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The prefill's batch, drawn as the reference's ``serve_batch`` draws
    it from ``default_rng(seed)``: the prompts' tokens first, then the
    float32 encoder frames (B, prompt_len, d_input) or the stub
    embeddings (B, prompt_len, d)."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    out: Dict[str, torch.Tensor] = {}
    if cfg.encoder is not None or cfg.embed_inputs:
        out["tokens"] = torch.as_tensor(prompts, dtype=torch.int64,
                                        device=device)
    if cfg.encoder is not None:
        d_in = cfg.encoder.d_input or cfg.d_model
    elif not cfg.embed_inputs:
        d_in = cfg.d_model
    else:
        return out
    out["embeds"] = torch.as_tensor(
        rng.normal(size=(batch, prompt_len, d_in)).astype(np.float32),
        device=device)
    return out


def serve_model(model, batch: int = 4, prompt_len: int = 16,
                gen: int = 16, seed: int = 0) -> Dict[str, Any]:
    """:func:`serve_batch` on an already built ``model`` (an ``LM`` or an
    ``EncDec``): ``batch`` prompts drawn from ``seed``
    (:func:`serve_inputs`), prefilled, then ``gen`` greedy tokens each.
    ``kv_cache_bytes`` in the result counts every tensor of the decode
    cache, the RWKV and Mamba states and the cross K/V included."""
    cfg, dev = model.cfg, model.device
    max_seq = prompt_len + gen
    inputs = serve_inputs(cfg, batch, prompt_len, seed, dev)
    # a stub-embedding model decodes from each token's output embedding
    embed_out = model.params["embed_out"] \
        if cfg.encoder is None and not cfg.embed_inputs else None

    t0 = time.perf_counter()
    cache = model.init_cache(batch, max_seq) if cfg.encoder is None \
        else model.init_cache(batch, max_seq, enc_seq=prompt_len)
    logits, prompt_cache = model.prefill(inputs)
    del inputs
    write_prefill_cache(cache, prompt_cache)
    del prompt_cache
    finite = torch.isfinite(logits).all()
    next_tok = logits[:, -1].argmax(-1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = torch.empty((batch, gen), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for i in range(gen):
        out[:, i] = next_tok
        step_in = next_tok[:, None] if embed_out is None \
            else embed_out[next_tok][:, None]
        logits, cache = model.decode_step(cache, step_in, prompt_len + i)
        finite &= torch.isfinite(logits).all()
        next_tok = logits[:, -1].argmax(-1)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    kv_bytes = sum(t.numel() * t.element_size() for c in cache
                   for part in c.values() for t in part.values())
    return {"tokens": out.cpu().numpy().astype(np.int32),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "tok_per_s": batch * gen / max(t_decode, 1e-9),
            "logits_finite": bool(finite), "kv_cache_bytes": kv_bytes,
            "device": str(dev)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    out = serve_batch(args.arch, args.reduced, args.batch, args.prompt_len,
                      args.gen, args.seed, device=args.device)
    print(f"{out['device']}: prefill {out['prefill_s']:.2f}s  decode "
          f"{out['decode_s']:.2f}s ({out['tok_per_s']:.1f} tok/s)")
    print("first sequences:", out["tokens"][:2, :12].tolist())


if __name__ == "__main__":
    main()
