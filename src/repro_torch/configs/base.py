"""The LM configuration: the port's copy of
``repro/configs/base.py::ModelConfig``.

A :class:`ModelConfig` describes one architecture: its layer pattern of
(sequence mixer, channel mixer) blocks, the attention flavour, the MoE
settings (:class:`MoEConfig`), the encoder tower (:class:`EncoderConfig`)
and the runtime knobs.  The fields are the JAX package's, but for one
difference.  ``SHAPES`` (the four assigned input shapes, each a
:class:`ShapeConfig`) and ``shape_applicable`` are the JAX package's too;
the dry run (``launch/dryrun.py``) pairs every arch with every shape.

* ``attention_impl`` names the port's two prefill paths: ``"flash"`` (the
  default; the hand-written kernels on the card and their plain versions
  on the CPU: ``kernels/flash_attention`` for attention and
  ``kernels/rwkv6`` for the RWKV-6 WKV recurrence — the JAX package's
  ``"pallas"``) or ``"plain"`` (torch ops: the materialised softmax and
  the chunked WKV ``models/rwkv.py::wkv_chunked`` — its ``"xla"``).
  ``"xla_chunked"`` is a TPU memory workaround and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

Pair = Tuple[str, str]  # (mixer, mlp) kinds


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_expert: int = 0           # per-expert FFN width
    num_shared: int = 0         # always-on shared experts (DeepSeek-MoE)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec (whisper backbone; conv frontend stubbed)."""
    num_layers: int = 6
    d_input: int = 0  # stub frame-embedding dim (0 -> d_model)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense|ssm|moe|vlm|audio|hybrid
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1024

    # layer pattern
    pattern: Tuple[Pair, ...] = (("attn", "dense"),)
    prelude: Tuple[Pair, ...] = ()

    # attention flavor
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None                 # sliding-window attention
    mrope_sections: Optional[Tuple[int, int, int]] = None  # M-RoPE (t,h,w)

    # mixers
    moe: Optional[MoEConfig] = None
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # towers
    encoder: Optional[EncoderConfig] = None      # enc-dec (audio)
    embed_inputs: bool = True                    # False -> stub embeddings in
    norm: str = "rms"                            # rms|ln
    act: str = "swiglu"                          # swiglu|gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # runtime knobs
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "full"
    scan_unroll: int = 1
    logits_chunk: int = 0
    attention_impl: str = "flash"  # flash|plain
    q_chunk: int = 512
    mamba_chunk: int = 256
    shard_vocab: bool = True
    fsdp_params: bool = True

    # ----------------------------------------------------------------- utils
    @property
    def n_repeats(self) -> int:
        n_scan = self.num_layers - len(self.prelude)
        if n_scan % len(self.pattern):
            raise ValueError(f"{self.name}: {n_scan} scan layers not "
                             f"divisible by pattern {len(self.pattern)}")
        return n_scan // len(self.pattern)

    @property
    def d_inner_mamba(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def is_pure_full_attention(self) -> bool:
        """True if *every* mixer is unwindowed full attention.  Only these
        skip long_500k; hybrids (Jamba: 1 attn per 8 layers) and SWA archs
        (Mixtral) run it."""
        mixers = {m for m, _ in self.pattern + self.prelude}
        return mixers == {"attn"} and self.window is None

    def moe_param_count(self) -> int:
        if self.moe is None:
            return 0
        n = self.moe.num_experts * 3 * self.d_model * self.moe.d_expert
        n += self.d_model * self.moe.num_experts  # router
        n += self.moe.num_shared * 3 * self.d_model * self.moe.d_expert
        return n

    def param_count(self) -> int:
        """Approximate total parameter count N, the JAX package's count
        for ``attn``/``mamba``/``rwkv`` mixers, ``dense``/``moe``/
        ``rwkv_ffn`` MLPs and an encoder tower with the decoder's
        cross-attention."""
        d, hd = self.d_model, self.head_dim
        di = self.d_inner_mamba
        attn = d * (self.num_heads * hd) * 2 \
            + d * (self.num_kv_heads * hd) * 2
        dense_mlp = 3 * d * self.d_ff if self.act == "swiglu" \
            else 2 * d * self.d_ff
        mamba = (d * 2 * di                                   # in_proj
                 + di * (self.mamba_d_conv + self.mamba_d_state * 2 + 2)
                 + di * d)                                    # out_proj
        rwkv = 5 * d * d + 2 * d * self.rwkv_decay_lora  # r,k,v,g,o + LoRA
        mixers = {"attn": attn, "mamba": mamba, "rwkv": rwkv}
        mlps = {"dense": dense_mlp, "moe": self.moe_param_count(),
                "rwkv_ffn": 2 * d * self.d_ff + d * d}
        total = 0
        for mixer, mlp in self.prelude + tuple(self.pattern) * \
                self.n_repeats:
            total += mixers[mixer] + mlps[mlp] + 2 * d   # + 2 norms
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.encoder is not None:
            enc_layer = attn + dense_mlp + 2 * d
            total += self.encoder.num_layers * enc_layer
            total += self.num_layers * (attn + 2 * d)  # cross-attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full_moe = self.moe_param_count()
        active_moe = ((m.top_k + m.num_shared) * 3 * self.d_model *
                      m.d_expert + self.d_model * m.num_experts)
        n_moe_layers = sum(1 for _, mlp in self.prelude + tuple(
            self.pattern) * self.n_repeats if mlp == "moe")
        return self.param_count() - n_moe_layers * (full_moe - active_moe)

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized config of the same family/pattern."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=len(self.prelude) + 2 * len(self.pattern),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if
            self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            rwkv_head_dim=16,
            rwkv_decay_lora=8,
            mamba_d_state=8,
            dtype="float32",
            param_dtype="float32",
            remat="none",
            logits_chunk=0,
        )
        if self.moe is not None:
            # capacity_factor high enough that no token ever drops: keeps
            # prefill/decode exactly consistent in the smoke tests (capacity
            # dropping is batch-composition-dependent by design).
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_expert=32,
                num_shared=min(self.moe.num_shared, 1),
                capacity_factor=8.0)
        if self.encoder is not None:
            kw["encoder"] = EncoderConfig(num_layers=2, d_input=64)
        if self.mrope_sections is not None:
            kw["mrope_sections"] = (2, 3, 3)  # sums to head_dim/2 = 8
        kw.update(overrides)
        return dataclasses.replace(self, **kw)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned): every arch is paired with all four shapes.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k is skipped for pure full-attention archs; SSM, SWA and
    hybrid archs run it."""
    if shape.name == "long_500k" and cfg.is_pure_full_attention:
        return False, ("pure full-attention arch: 500k context requires "
                       "sub-quadratic attention (skip per DESIGN.md)")
    return True, ""
