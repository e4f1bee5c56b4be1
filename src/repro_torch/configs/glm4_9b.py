"""GLM4-9B: dense, RoPE (partial rotary), GQA kv=2. [hf:THUDM/glm-4-9b]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=151552,
    pattern=(("attn", "dense"),),
    rope_theta=1e4, rotary_pct=0.5, qkv_bias=True, norm="rms", act="swiglu",
)
