"""DeepSeek-MoE 16B: fine-grained MoE, 2 shared + 64 routed top-6; first
layer dense (d_ff=10944), expert width 1408. [arXiv:2401.06066]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=10944, vocab_size=102400,
    prelude=(("attn", "dense"),),
    pattern=(("attn", "moe"),),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
    rope_theta=1e4, norm="rms", act="swiglu",
)
