"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2), d_ff=8960,
vocab=151936 — M-RoPE (t/h/w rotary sections), dynamic resolution. Vision
encoder (ViT) is a stub: patch embeddings arrive precomputed.
[arXiv:2409.12191 — Qwen2-VL]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_type="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    vision_patches=1024,
    activation="swiglu",
)
