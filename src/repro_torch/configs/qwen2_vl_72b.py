"""Qwen2-VL-72B backbone: M-RoPE (t/h/w sections), dynamic-resolution vision
tower stubbed -- input_specs feeds precomputed patch embeddings + position
triples. [arXiv:2409.12191]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    pattern=(("attn", "dense"),),
    mrope_sections=(16, 24, 24),
    embed_inputs=False,
    rope_theta=1e6, qkv_bias=True, norm="rms", act="swiglu",
)
