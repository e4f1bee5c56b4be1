"""Whisper-base backbone: enc-dec, conv frontend stubbed (input_specs feeds
precomputed frame embeddings). [arXiv:2212.04356]

vocab 51865 is not divisible by the 16-way model axis -> vocab replicated
(the unembed is only 27 MB)."""
from .base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    pattern=(("attn", "dense"),),
    encoder=EncoderConfig(num_layers=6, d_input=128),
    norm="ln", act="gelu", tie_embeddings=True, shard_vocab=False,
    rotary_pct=0.0,  # whisper uses absolute/no rotary; positions unused
)
