"""gemma-7b [dense]: 28L d_model=3072 16H (kv=16), d_ff=24576, GeGLU,
head_dim=256, vocab=256000, tied embeddings.  [arXiv:2403.08295]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
)
