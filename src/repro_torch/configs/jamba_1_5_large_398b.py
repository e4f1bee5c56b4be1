"""Jamba-1.5-Large 398B: hybrid Mamba+attention 1:7 interleave, MoE 16e
top-2 on alternate layers. [arXiv:2403.19887]

8-layer period: attention at position 4, Mamba elsewhere; MoE on odd
positions."""
from .base import ModelConfig, MoEConfig

_PERIOD = tuple(
    ("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    pattern=_PERIOD,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576),
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    rope_theta=1e6, norm="rms", act="swiglu",
)
