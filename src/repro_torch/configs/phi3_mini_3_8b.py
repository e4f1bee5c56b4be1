"""Phi-3-mini 3.8B: dense, RoPE, SwiGLU, MHA (kv=32). [arXiv:2404.14219]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    pattern=(("attn", "dense"),),
    rope_theta=1e4, norm="rms", act="swiglu",
)
