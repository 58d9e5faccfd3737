"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5), d_ff=5504,
vocab=32001, ssm_state=16 — parallel attention + mamba heads per layer;
sliding-window attention path (global attn in a few layers omitted — backbone
carve-out).  [arXiv:2411.13676 — Hymba]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_heads=25,
    ssm_expand=2,
    sliding_window=2048,  # Hymba uses SWA in most layers -> long_500k native
    activation="swiglu",
)
