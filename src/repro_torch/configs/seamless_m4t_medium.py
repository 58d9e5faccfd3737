"""seamless-m4t-medium [audio]: enc-dec, 12L(+12 enc) d_model=1024 16H
(kv=16), d_ff=4096, vocab=256206. Audio frontend (mel + conv) is a stub:
the encoder consumes precomputed frame embeddings.  [arXiv:2308.11596]
No long_500k (encoder-decoder, full cross-attention — documented skip)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    encoder_layers=12,
    frontend_len=1024,  # stub frames per utterance
    activation="swiglu",
)
