"""Mixtral-8x7B: 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]  SWA makes prefill sub-quadratic and bounds the decode
cache -> runs long_500k."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    pattern=(("attn", "moe"),),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=14336),
    window=4096, rope_theta=1e6, norm="rms", act="swiglu",
)
