"""deepseek-7b [dense]: llama-arch, 30L d_model=4096 32H (GQA kv=32 = MHA),
d_ff=11008, vocab=102400.  [arXiv:2401.02954 — DeepSeek LLM 7B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    activation="swiglu",
    rope_theta=10_000.0,
)
