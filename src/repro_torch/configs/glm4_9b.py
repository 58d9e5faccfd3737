"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2), d_ff=13696,
vocab=151552 — RoPE, GQA.  [hf:THUDM/glm-4-9b]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    activation="swiglu",
    qkv_bias=True,  # GLM-4 uses QKV bias
    rope_theta=1_000_000.0,
)
