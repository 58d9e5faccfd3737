"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2), d_ff=11008,
vocab=151936 — GQA, QKV bias, tied embeddings.  [hf:Qwen/Qwen2.5-0.5B
family, 3B point per assignment]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    activation="swiglu",
)
