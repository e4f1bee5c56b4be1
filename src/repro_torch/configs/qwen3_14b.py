"""Qwen3-14B: dense, GQA kv=8, per-head qk RMSNorm. [hf:Qwen/Qwen3-8B family]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936,
    pattern=(("attn", "dense"),),
    rope_theta=1e6, qk_norm=True, norm="rms", act="swiglu",
)
